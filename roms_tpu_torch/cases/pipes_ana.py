"""Pipes_ana test case (port of roms_tpu/cases/pipes_ana.py; reference:
tests/Pipes_ana/).

Closed shelf basin (100x100x10, 30 km) with a submerged 2x2-cell pipe
source at mid-domain discharging into the bottom two levels; nonlinear
split EOS, T+S, full KPP (reference: tests/Pipes_ana/ana_grid.h,
ana_pipe_frc.h, benchmark.in).  Its 20-step diagnostics series is the
frozen oracle tests/data/pipes_ana_oracle.txt.
"""

from __future__ import annotations

import numpy as np
import torch

from roms_tpu_torch.cases import resolve_device
from roms_tpu_torch.cases.rivers_ana import rest_state, shelf_basin
from roms_tpu_torch.config import ModelConfig
from roms_tpu_torch.state import zero_forcing

SIZE = 30.0e3
F0 = 1.0e-4
DEPTH = 10.0
PIPE_VOL = 5.0e2
PIPE_TRC = (24.0, 1.0)


def config(ntimes: int = 20) -> ModelConfig:
    """The same ModelConfig as roms_tpu.cases.pipes_ana.config."""
    return ModelConfig(
        nx=100, ny=100, nz=10, nt=2,
        dt=60.0, ndtfast=30, ntimes=ntimes,
        theta_s=6.0, theta_b=6.0, hc=25.0,
        rho0=1027.5,
        rdrg=0.0, rdrg2=1.0e-3, zob=1.0e-2, gamma2=1.0,
        visc2=0.0, tnu2=0.0, akv_bak=0.0, akt_bak=0.0,
        nonlin_eos=True, salinity=True, lmd_kpp=True,
        pipe_source=True,
        ew_periodic=False, ns_periodic=False, masking=True)


def setup(cfg: ModelConfig | None = None, dtype: torch.dtype = torch.float64,
          device: torch.device | str = "cuda"):
    """Build (grid, state, forcing) on the card unless `device` says
    otherwise; raises where there is no CUDA device."""
    device = resolve_device(device)
    if cfg is None:
        cfg = config()
    grid, xr, yr, _ = shelf_basin(cfg, SIZE, DEPTH, F0, dtype, device)

    # pipe placement (reference: ana_grid.h:96-113)
    dx = SIZE / cfg.nx
    psz = SIZE * 0.02
    px = py = SIZE * 0.5
    pipe_cells = np.rint(psz / dx) ** 2
    in_pipe = ((xr > px - 0.5 * psz) & (xr < px + 0.5 * psz)
               & (yr > py - 0.5 * psz) & (yr < py + 0.5 * psz))
    pipe_fraction = np.where(in_pipe, 1.0 / pipe_cells, 0.0)
    pipe_idx = np.where(in_pipe, 1, 0).astype(np.int32)
    # profile: half into each of the two bottom levels (ana_pipe_frc.h)
    pipe_prf = np.zeros((2, cfg.nz))
    pipe_prf[1, 0] = 0.5
    pipe_prf[1, 1] = 0.5
    pipe_trc = np.array([[0.0, 0.0], list(PIPE_TRC)])

    def dev(a):
        return torch.as_tensor(a, dtype=dtype, device=device)

    forcing = zero_forcing(cfg, dtype, device).replace(
        pipe_flx=dev(pipe_fraction * PIPE_VOL),
        pipe_idx=torch.as_tensor(pipe_idx, device=device),
        pipe_prf=dev(pipe_prf), pipe_trc=dev(pipe_trc))
    return grid, rest_state(cfg, grid, forcing, dtype, device), forcing
