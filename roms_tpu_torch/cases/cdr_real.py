"""Shared assembly of the three realistic mCDR test cases (port of
roms_tpu/cases/cdr_real.py; reference: tests/CDR_parameterized/,
tests/CDR_dp/, tests/CDR_3d/).

All three run the USWC-sample domain with MARBL-scale biogeochemistry
(32 BGC tracers -> nt=34), bulk-COARE surface forcing, 4-side open
boundaries with physical + BGC-climatology data, sponge, rivers, KPP,
nonlinear split EOS and masking (reference: tests/CDR_*/cppdefs.opt,
identical across the three cases), and differ ONLY in the mCDR forcing
mode selected in cdr_frc.opt:

  * CDR_parameterized — Gaussian release footprints built from
    lon/lat/depth/scales + a per-release tracer-flux series
    (reference: src/cdr_frc.F:264-292);
  * CDR_dp — layerwise ALK/DIC flux profiles conservatively remapped
    onto the model levels (reference: src/cdr_frc.F:189-243);
  * CDR_3d — full-3D ALK/DIC flux fields (reference: src/cdr_frc.F:111-114).

The reference runs NTIMES=10 at dt=40 with NDTFAST=30; the inputs are the
synthetic reference-schema files of `cases/uswc.py`, and the TIDES switch
is off (reference: tests/CDR_parameterized/cppdefs.opt `!# define TIDES`).
"""

from __future__ import annotations

import os
from typing import Optional

import torch

from roms_tpu_torch.bgc.bec import MARBL_TRACERS
from roms_tpu_torch.cases import uswc
from roms_tpu_torch.config import ModelConfig
from roms_tpu_torch.experiment import Experiment, assemble

TRACER_NAMES = ("temp", "salt") + MARBL_TRACERS  # nt = 34 (param.opt:31-32)
IALK = TRACER_NAMES.index("ALK")
IDIC = TRACER_NAMES.index("DIC")

# mirrors reference tests/CDR_*/benchmark.in (dt=40, NDTFAST=30,
# v_sponge=1, MARBL biogeochemistry; values re-stated, not copied)
BENCHMARK_IN = """\
title:
   USWC sample domain - realistic CDR test (synthetic inputs).

time_stepping: NTIMES   dt[sec]  NDTFAST  NINFO
               {ntimes}        40       30       1

S-coord: THETA_S,   THETA_B,    hc (m)
          6.0D0        6.0D0     25.0D0

grid:  filename
     {inp}/example_input_grid.nc

forcing: filename
     {inp}/example_input_bgc_surface_forcing_clim.nc
     {inp}/example_input_bgc_boundary_forcing_clim.nc
     {inp}/example_input_boundary_forcing.nc
     {inp}/example_input_surface_forcing.nc
     {inp}/example_input_river_forcing.nc
     {inp}/example_input_tides.nc

initial: NRREC  filename
          1
     {inp}/example_input_bgc_initial_conditions.nc

MARBL_biogeochemistry: namelist  tracer_output_list   diagnostic_output_list
      marbl_in
      marbl_tracer_output_list
      marbl_diagnostic_output_list

output_root_name:
     cdr

lateral_visc:   VISC2,    VISC4    [m^2/sec for all]
                 0.       0.

rho0:
      1027.5

v_sponge:           V_SPONGE [m^2/sec]
                   1.

bottom_drag:     RDRG [m/s],  RDRG2,  Zob [m],  Cdb_min, Cdb_max
                  0.E-4       1.0E-3   1.E-2     1.E-4    1.E-2

gamma2:
                  1.D0

ubind: OBC binding velocity scale [m/s]
       0.1
"""

CDR_FILES = {"parameterized": "cdr_forcing_parm.nc",
             "dp": "cdr_forcing_dp.nc",
             "3d": "cdr_forcing_3d.nc"}


def base_config() -> ModelConfig:
    """Compile-time switches (reference: tests/CDR_parameterized/cppdefs.opt:
    BULK_FRC RIVER_SOURCE MASKING SALINITY NONLIN_EOS SPLIT_EOS UV_VIS2
    TS_DIF2 LMD_KPP/BKPP OBC_* M2FLATHER M3ORLANSKI TORLANSKI *_FRC_BRY
    SPONGE CDR_FORCING MARBL; TIDES off)."""
    return ModelConfig(
        nx=uswc.NX, ny=uswc.NY, nz=uswc.NZ, nt=len(TRACER_NAMES),
        nonlin_eos=True, salinity=True, lmd_kpp=True,
        curvgrid=True, masking=True,
        ew_periodic=False, ns_periodic=False,
        obc_west=True, obc_east=True, obc_south=True, obc_north=True,
        obc_m2="flather", obc_m3="orlanski", obc_t="orlanski",
        frc_bry=True, river_source=True, sponge=True,
        bgc_model="marbl32", n_bgc=len(MARBL_TRACERS))


def build(workdir: str, mode: str, ntimes: int = 10,
          dtype: torch.dtype = torch.float64,
          device: torch.device | str = "cuda",
          base_cfg: Optional[ModelConfig] = None) -> Experiment:
    """Generate inputs + the case's roms.in under `workdir` and assemble
    the run on the card unless `device` says otherwise; `base_cfg`
    replaces `base_config()` (a configuration without rivers takes the
    tracer kernel's path)."""
    inp = os.path.join(workdir, "input_data")
    uswc.generate_inputs(inp, bgc_names=MARBL_TRACERS,
                         ntracers=len(TRACER_NAMES), ialk=IALK, idic=IDIC)
    infile = os.path.join(workdir, f"cdr_{mode}.in")
    with open(infile, "w") as f:
        f.write(BENCHMARK_IN.format(inp=inp, ntimes=ntimes))
    return assemble(infile, base_cfg or base_config(),
                    tracer_names=TRACER_NAMES, nz=uswc.NZ, dtype=dtype,
                    device=device, cdr_mode=mode,
                    cdr_file=os.path.join(inp, CDR_FILES[mode]),
                    bry_tides=False, pot_tides=False)
