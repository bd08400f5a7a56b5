"""Pipes_real test case (port of roms_tpu/cases/pipes_real.py;
reference: tests/Pipes_real/).

USWC-sample domain with a realistic (file-driven) submerged pipe source:
location/fraction from the pipe forcing file's pipe_index/pipe_fraction
fields, volume/tracer time series from the same file, bottom-two-level
discharge profile (reference: src/pipe_frc.F:39-42,115-116,
set_pipe_vert_prf), on Flux_frc physics + sponge (reference:
tests/Pipes_real/cppdefs.opt SPONGE/SPONGE_WIDTH, benchmark.in dt=20).
"""

from __future__ import annotations

import torch

from roms_tpu_torch.cases import uswc
from roms_tpu_torch.config import ModelConfig
from roms_tpu_torch.experiment import Experiment


BENCHMARK_IN = """\
title:
   USWC sample domain - realistic pipe test (synthetic inputs).

time_stepping: NTIMES   dt[sec]  NDTFAST  NINFO
               {ntimes}        20       30       1

S-coord: THETA_S,   THETA_B,    hc (m)
          6.0D0        6.0D0     25.0D0

grid:  filename
     {inp}/example_input_grid.nc

forcing: filename
     {inp}/example_input_surface_flux_forcing.nc
     {inp}/example_input_boundary_forcing.nc
     {inp}/example_input_pipe_forcing.nc

initial: NRREC  filename
          1
     {inp}/example_input_bgc_initial_conditions.nc

output_root_name:
     pipes

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
    """(reference: tests/Pipes_real/cppdefs.opt: Flux_frc physics +
    PIPE_SOURCE + SPONGE)."""
    return ModelConfig(
        nx=uswc.NX, ny=uswc.NY, nz=uswc.NZ, nt=2,
        nonlin_eos=True, salinity=True, lmd_kpp=True,
        curvgrid=True, masking=True,
        ew_periodic=False, ns_periodic=False,
        obc_west=True, obc_east=True, obc_south=True, obc_north=True,
        obc_m2="flather", obc_m3="orlanski", obc_t="orlanski",
        frc_bry=True, pipe_source=True, sponge=True)


def build(workdir: str, ntimes: int = 20,
          dtype: torch.dtype = torch.float64,
          device: torch.device | str = "cuda") -> Experiment:
    """Generate inputs + roms.in under `workdir` and assemble the run on
    the card unless `device` says otherwise."""
    return uswc.build_case(workdir, "pipes.in", BENCHMARK_IN, base_config(),
                           ntimes, dtype, device)
