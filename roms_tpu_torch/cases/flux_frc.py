"""Flux_frc test case (port of roms_tpu/cases/flux_frc.py;
reference: tests/Flux_frc/).

USWC-sample domain with direct prescribed surface fluxes (wind stress +
heat/freshwater/solar, reference: src/flux_frc.F), open boundaries on all
four sides with external data (Flather/Orlanski/Orlanski), full KPP,
nonlinear split EOS, masking, spherical curvilinear metrics — the
configuration of tests/Flux_frc/cppdefs.opt + benchmark.in.

Input files are generated synthetically (see `uswc` for why
the reference's downloaded data cannot be used here) with the exact
reference schemas, so the full file path — roms.in parser -> grid/init
readers -> multi-file forcing search -> two-slot time interpolation ->
stepper — is what this case regression-tests.
"""

from __future__ import annotations

import torch

from roms_tpu_torch.cases import uswc
from roms_tpu_torch.config import ModelConfig
from roms_tpu_torch.experiment import Experiment

# mirrors reference tests/Flux_frc/benchmark.in (values re-stated, not
# copied as a file: title/time_stepping/S-coord/rho0/bottom_drag/ubind)
BENCHMARK_IN = """\
title:
    Flux_frc module test (synthetic USWC inputs).

time_stepping: NTIMES   dt[sec]  NDTFAST  NINFO
               {ntimes}        20       30       1

S-coord: THETA_S,   THETA_B,    hc (m)
          6.0D0        6.0D0     25.0D0

grid:  filename
     {inp}/example_input_grid.nc

forcing: filename
     {inp}/example_input_surface_flux_forcing.nc
     {inp}/example_input_boundary_forcing.nc

initial: NRREC  filename
          1
     {inp}/example_input_bgc_initial_conditions.nc

output_root_name:
     flux_frc

lateral_visc:   VISC2,    VISC4    [m^2/sec for all]
                 0.       0.

rho0:
      1027.5

tracer_diff2: TNU2(1:NT)           [m^2/sec for all]
 0. 0.

bottom_drag:     RDRG [m/s],  RDRG2,  Zob [m],  Cdb_min, Cdb_max
                  0.E-4       1.0E-3   1.E-2     1.E-4    1.E-2

gamma2:
                  1.D0

ubind: OBC binding velocity scale [m/s]
       0.1
"""


def base_config() -> ModelConfig:
    """Compile-time switches (reference: tests/Flux_frc/cppdefs.opt:
    NONLIN_EOS SPLIT_EOS SALINITY *_FRC_BRY UV_VIS2 TS_DIF2 LMD_KPP
    LMD_BKPP CURVGRID SPHERICAL MASKING OBC_* M2FLATHER M3ORLANSKI
    TORLANSKI ADV_ISONEUTRAL)."""
    return ModelConfig(
        nx=uswc.NX, ny=uswc.NY, nz=uswc.NZ, nt=2,
        nonlin_eos=True, salinity=True, lmd_kpp=True,
        curvgrid=True, masking=True,
        ew_periodic=False, ns_periodic=False,
        obc_west=True, obc_east=True, obc_south=True, obc_north=True,
        obc_m2="flather", obc_m3="orlanski", obc_t="orlanski",
        frc_bry=True)


def build(workdir: str, ntimes: int = 20,
          dtype: torch.dtype = torch.float64,
          device: torch.device | str = "cuda") -> Experiment:
    """Generate inputs + roms.in under `workdir` and assemble the run on
    the card unless `device` says otherwise."""
    return uswc.build_case(workdir, "flux_frc.in", BENCHMARK_IN, base_config(),
                           ntimes, dtype, device)
