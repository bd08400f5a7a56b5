"""Rivers_ana test case (port of roms_tpu/cases/rivers_ana.py; reference:
tests/Rivers_ana/).

Closed shelf basin (100x100x10) with a land strip in the south, a river
channel cut through the land, and one analytic river source; nonlinear
split EOS, T+S, full KPP (reference: tests/Rivers_ana/ana_grid.h,
ana_init.h, ana_frc_river.h, benchmark.in, cppdefs.opt).  Its 20-step
diagnostics series is the frozen oracle tests/data/rivers_ana_oracle.txt
(reference: tests/Rivers_ana/benchmark.result_github_gnu).
"""

from __future__ import annotations

import numpy as np
import torch

from roms_tpu_torch import vcoord
from roms_tpu_torch.cases import resolve_device
from roms_tpu_torch.config import ModelConfig
from roms_tpu_torch.grid import build_grid
from roms_tpu_torch.ops import kinematics, kpp
from roms_tpu_torch.ops.eos import rho_eos
from roms_tpu_torch.ops.rivers import build_river_faces
from roms_tpu_torch.parallel.halo import make_halo_fill
from roms_tpu_torch.state import zero_forcing, zeros_state

SIZE_XI = 1.0e4
SIZE_ETA = 1.0e4
DEPTH = 5.0
MAX_DEPTH = 100.0
RIV_VOL = 5.0e2            # m^3/s (reference: ana_frc_river.h)
RIV_TRC = (24.0, 1.0)      # temperature, salinity


def config(ntimes: int = 20) -> ModelConfig:
    """The same ModelConfig as roms_tpu.cases.rivers_ana.config."""
    return ModelConfig(
        nx=100, ny=100, nz=10, nt=2,
        dt=20.0, ndtfast=30, ntimes=ntimes,
        theta_s=6.0, theta_b=6.0, hc=25.0,
        rho0=1027.5,
        rdrg=0.0, rdrg2=1.0e-3, zob=1.0e-2, gamma2=1.0,
        visc2=0.0, tnu2=0.0, akv_bak=0.0, akt_bak=0.0,
        nonlin_eos=True, salinity=True, lmd_kpp=True,
        river_source=True,
        ew_periodic=False, ns_periodic=False, masking=True)


def shelf_basin(cfg: ModelConfig, size: float, depth: float, f0: float,
                dtype: torch.dtype, device: torch.device):
    """The analytic shelf basin that Rivers_ana and Pipes_ana share
    (reference: tests/{Rivers,Pipes}_ana/ana_grid.h): square domain of
    side `size`, a shelf of `depth` over the southern fifth sloping to
    MAX_DEPTH, a southern land strip cut by a channel between 0.4 and 0.6
    of the width.  Returns (grid, xr, yr, in_channel) with the last three
    numpy."""
    h = cfg.halo
    npdt = np.float64
    jy, ix = cfg.ny + 2 * h, cfg.nx + 2 * h
    dx = size / cfg.nx
    dy = size / cfg.ny
    i_f = np.arange(-1, cfg.nx + 3, dtype=npdt)
    j_f = np.arange(-1, cfg.ny + 3, dtype=npdt)
    xr = np.broadcast_to((dx * (i_f - 0.5))[None, :], (jy, ix)).copy()
    yr = np.broadcast_to((dy * (j_f - 0.5))[:, None], (jy, ix)).copy()
    pm = np.full((jy, ix), 1.0 / dx, npdt)
    pn = np.full((jy, ix), 1.0 / dy, npdt)
    f = np.full((jy, ix), f0, npdt)

    shelf = size / 5.0
    slope = (MAX_DEPTH - depth) / (size * 4.0 / 5.0)
    hb = np.where(yr < shelf, depth, depth + (yr - shelf) * slope)

    land = size * 0.1
    coast = size * 0.02
    in_channel = (xr > size * 0.4) & (xr < size * 0.6)
    rmask = np.ones((jy, ix), npdt)
    rmask[(yr < land) & ~in_channel] = 0.0
    rmask[yr < coast] = 0.0
    grid = build_grid(cfg, hb, pm, pn, f, rmask, xr=xr, yr=yr, dtype=dtype,
                      device=device)
    return grid, xr, yr, in_channel


def rest_state(cfg: ModelConfig, grid, forcing, dtype: torch.dtype,
               device: torch.device):
    """State at rest over the basin with the ana_init.h profiles
    (T = 4 + 10 exp(z/50), S = 36), swr_frac from the rest-state Hz once
    (reference: main.F:216-220), and the initial fluxes, omega and
    density; omega sees the pipes through `forcing`."""
    jy, ix = grid.h.shape
    zeros2 = torch.zeros((jy, ix), dtype=dtype, device=device)
    z_w, z_r, hz = vcoord.set_depth(zeros2, grid.h, grid.hinv,
                                    grid.cs_w, grid.cs_r, cfg.hc, cfg.nz)
    temp = 4.0 + 10.0 * torch.exp(z_r / 50.0)
    salt = torch.full_like(temp, 36.0)
    t0 = torch.stack([temp, salt], dim=0)
    halo_fill = make_halo_fill(cfg)
    st = zeros_state(cfg, dtype, device).replace(
        t=t0, t_prev=t0, z_w=z_w, z_r=z_r, hz=hz, swrf=kpp.swr_frac(hz, cfg))
    flx_u, flx_v = kinematics.set_huv(st.u, st.v, hz, grid)
    flx_u, flx_v = halo_fill(flx_u), halo_fill(flx_v)
    om = kinematics.omega(flx_u, flx_v, z_w, hz, zeros2, grid,
                          0.6 * cfg.dt, cfg, forcing)
    eos0 = rho_eos(st.t, z_r, z_w, hz, grid.rmask, cfg)
    return st.replace(flx_u=flx_u, flx_v=flx_v, we=halo_fill(om.we),
                      wi=halo_fill(om.wi), rho=eos0.rho)


def setup(cfg: ModelConfig | None = None, dtype: torch.dtype = torch.float64,
          device: torch.device | str = "cuda"):
    """Build (grid, state, forcing) on the card unless `device` says
    otherwise; raises where there is no CUDA device."""
    device = resolve_device(device)
    if cfg is None:
        cfg = config()
    jy, ix = cfg.ny + 2 * cfg.halo, cfg.nx + 2 * cfg.halo
    grid, xr, yr, in_channel = shelf_basin(cfg, SIZE_XI, DEPTH, 0.0, dtype,
                                           device)

    # river faces (reference: river_frc.F:121-139 analytic branch)
    rmask = grid.rmask.cpu().numpy()
    riv_cells = np.rint((SIZE_XI * 0.6 - SIZE_XI * 0.4) / (SIZE_XI / cfg.nx))
    rfrc = np.zeros((jy, ix))
    ridx = np.zeros((jy, ix), np.int64)
    src = in_channel & (rmask == 0.0) & (np.roll(rmask, -1, axis=0) == 1.0)
    # restrict to the Fortran loop range 0..n+1 (first ring)
    src[0, :] = src[-1, :] = False
    src[:, 0] = src[:, -1] = False
    rfrc[src] = 1.0 / riv_cells
    ridx[src] = 1
    uflx, vflx = build_river_faces(rmask, rfrc, ridx)

    def dev(a):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

    riv_vol = np.zeros(2)            # index 0 unused; river ids are 1-based
    riv_vol[1] = RIV_VOL
    riv_trc = np.zeros((2, cfg.nt))
    riv_trc[1, :2] = RIV_TRC
    forcing = zero_forcing(cfg, dtype, device).replace(
        riv_uflx=dev(uflx), riv_vflx=dev(vflx), riv_vol=dev(riv_vol),
        riv_trc=dev(riv_trc))
    return grid, rest_state(cfg, grid, forcing, dtype, device), forcing
