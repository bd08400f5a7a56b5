"""Rivers_real test case (port of roms_tpu/cases/rivers_real.py;
reference: tests/Rivers_real/).

USWC-sample domain with a realistic (file-driven) river: the river mouth
location/fraction is read from the grid file's `river_flux` field and the
volume/tracer time series from the river forcing file (reference:
src/river_frc.F:46-49, analytical=.false. branch), on top of the Flux_frc
physics (flux surface forcing, 4-side OBC with data, KPP, nonlinear split
EOS, masking) plus the open-boundary sponge (reference:
tests/Rivers_real/cppdefs.opt SPONGE, benchmark.in v_sponge=1).
"""

from __future__ import annotations

import torch

from roms_tpu_torch.cases import uswc
from roms_tpu_torch.config import ModelConfig
from roms_tpu_torch.experiment import Experiment

# mirrors reference tests/Rivers_real/benchmark.in (dt=40, v_sponge=1)
BENCHMARK_IN = """\
title:
   USWC sample domain - realistic river test (synthetic inputs).

time_stepping: NTIMES   dt[sec]  NDTFAST  NINFO
               {ntimes}        40       30       1

S-coord: THETA_S,   THETA_B,    hc (m)
          6.0D0        6.0D0     25.0D0

grid:  filename
     {inp}/example_input_grid.nc

forcing: filename
     {inp}/example_input_surface_flux_forcing.nc
     {inp}/example_input_river_forcing.nc
     {inp}/example_input_boundary_forcing.nc

initial: NRREC  filename
          1
     {inp}/example_input_bgc_initial_conditions.nc

output_root_name:
     rivers

lateral_visc:   VISC2,    VISC4    [m^2/sec for all]
                 0.       0.

rho0:
      1027.5

v_sponge:           V_SPONGE [m^2/sec]
                   1.

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
    """(reference: tests/Rivers_real/cppdefs.opt: Flux_frc physics +
    RIVER_SOURCE + SPONGE, no ADV_ISONEUTRAL)."""
    return ModelConfig(
        nx=uswc.NX, ny=uswc.NY, nz=uswc.NZ, nt=2,
        nonlin_eos=True, salinity=True, lmd_kpp=True,
        curvgrid=True, masking=True,
        ew_periodic=False, ns_periodic=False,
        obc_west=True, obc_east=True, obc_south=True, obc_north=True,
        obc_m2="flather", obc_m3="orlanski", obc_t="orlanski",
        frc_bry=True, river_source=True, sponge=True)


def build(workdir: str, ntimes: int = 20,
          dtype: torch.dtype = torch.float64,
          device: torch.device | str = "cuda") -> Experiment:
    """Generate inputs + roms.in under `workdir` and assemble the run on
    the card unless `device` says otherwise."""
    return uswc.build_case(workdir, "rivers.in", BENCHMARK_IN, base_config(),
                           ntimes, dtype, device)
