"""bgc_real test case (port of roms_tpu/cases/bgc_real.py; reference:
tests/bgc_real/): the USWC-sample domain with full biogeochemistry and no
mCDR forcing, in the reference CI matrix's two engine variants
(reference: tests/bgc_real/cppdefs_MARBL.opt -> MARBL, 32 BGC tracers;
cppdefs_BEC.opt -> BIOLOGY_BEC2 without Ncycle_SY, 26 BGC tracers;
param.opt:26-32).

Relative to the CDR cases the physics adds TIDES (boundary + potential,
reference: tests/bgc_real/cppdefs.opt `# define TIDES`, tides.opt) and
runs at dt=20 (reference: tests/bgc_real/benchmark.in).  The inputs are
the synthetic reference-schema files of `cases/uswc.py`.
"""

from __future__ import annotations

import os

import torch

from roms_tpu_torch.bgc.bec import BEC2_TRACERS, MARBL_TRACERS
from roms_tpu_torch.cases import uswc
from roms_tpu_torch.config import ModelConfig
from roms_tpu_torch.experiment import Experiment, assemble

VARIANTS = {
    "marbl": ("marbl32", MARBL_TRACERS),
    "bec": ("bec2_base", BEC2_TRACERS[:-3]),
}

# mirrors reference tests/bgc_real/benchmark.in (dt=20, NDTFAST=30,
# v_sponge=1; values re-stated, not copied)
BENCHMARK_IN = """\
title:
   bgc_real test (synthetic USWC inputs).

time_stepping: NTIMES   dt[sec]  NDTFAST  NINFO
               {ntimes}        20       30       1

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
     bgc

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


def base_config(variant: str = "marbl") -> ModelConfig:
    """Compile-time switches (reference: tests/bgc_real/cppdefs_*.opt:
    TIDES BULK_FRC RIVER_SOURCE MASKING SALINITY NONLIN_EOS SPLIT_EOS
    UV_VIS2 TS_DIF2 LMD_KPP/BKPP OBC_* M2FLATHER M3ORLANSKI TORLANSKI
    *_FRC_BRY SPONGE + {MARBL | BIOLOGY_BEC2})."""
    model, bgc_names = VARIANTS[variant]
    return ModelConfig(
        nx=uswc.NX, ny=uswc.NY, nz=uswc.NZ, nt=2 + len(bgc_names),
        nonlin_eos=True, salinity=True, lmd_kpp=True,
        curvgrid=True, masking=True,
        ew_periodic=False, ns_periodic=False,
        obc_west=True, obc_east=True, obc_south=True, obc_north=True,
        obc_m2="flather", obc_m3="orlanski", obc_t="orlanski",
        frc_bry=True, river_source=True, sponge=True,
        bgc_model=model, n_bgc=len(bgc_names))


def build(workdir: str, ntimes: int = 10, variant: str = "marbl",
          dtype: torch.dtype = torch.float64,
          device: torch.device | str = "cuda") -> Experiment:
    """Generate inputs + roms.in under `workdir` and assemble the run on
    the card unless `device` says otherwise."""
    _, bgc_names = VARIANTS[variant]
    tracer_names = ("temp", "salt") + bgc_names
    inp = os.path.join(workdir, "input_data")
    uswc.generate_inputs(inp, bgc_names=bgc_names,
                         ntracers=len(tracer_names),
                         ialk=tracer_names.index("ALK")
                         if "ALK" in tracer_names
                         else tracer_names.index("Alk"),
                         idic=tracer_names.index("DIC"))
    infile = os.path.join(workdir, "bgc_real.in")
    with open(infile, "w") as f:
        f.write(BENCHMARK_IN.format(inp=inp, ntimes=ntimes))
    return assemble(infile, base_config(variant),
                    tracer_names=tracer_names, nz=uswc.NZ, dtype=dtype,
                    device=device, bry_tides=True, pot_tides=True)
