"""Filament idealized test case (port of roms_tpu/cases/filament.py;
reference: tests/Filament/ana_grid.h, ana_init.h, benchmark.in).

Doubly periodic submesoscale cold-filament setup with an analytic grid
and a geostrophically balanced initial state; its 20-step diagnostics
series is the frozen regression oracle (tests/data/filament_oracle.txt).
The analytic initial fields are numpy float64, then the port's
set_depth, halo fill, set_HUV, omega and rho_eos run on the target
device and dtype.
"""

from __future__ import annotations

import numpy as np
import torch

from roms_tpu_torch import vcoord
from roms_tpu_torch.cases import resolve_device
from roms_tpu_torch.config import ModelConfig
from roms_tpu_torch.grid import build_grid
from roms_tpu_torch.ops import kinematics
from roms_tpu_torch.ops.eos import rho_eos
from roms_tpu_torch.parallel.halo import make_halo_fill, shift
from roms_tpu_torch.state import zero_forcing, zeros_state

# physical parameters (reference: tests/Filament/ana_grid.h, ana_init.h,
# param.opt HD, benchmark.in)
SIZE_X = 12.8e3
SIZE_Y = 3.2e3
F0 = 2 * 7.81e-5
HD = 1000.0
B0 = 5.0e-2
B_CFF = 0.025
LAMBDA_INV = 8.0
NB = 1.0e-7
N0 = 3.0e-5
H0 = 60.0
DH0 = 15.0
L_FIL = 2000.0


def config(ntimes: int = 20) -> ModelConfig:
    """The same ModelConfig as roms_tpu.cases.filament.config."""
    return ModelConfig(
        nx=64, ny=64, nz=32, nt=1,
        dt=5.0, ndtfast=60, ntimes=ntimes,
        theta_s=6.0, theta_b=2.0, hc=25.0,
        rho0=1000.0, tcoef=0.2, t0=1.0,
        rdrg=0.0, rdrg2=1.0e-3, zob=1.0e-2,
        visc2=0.0, tnu2=0.0, akv_bak=0.0, akt_bak=0.0,
        nonlin_eos=False, salinity=False,
        ew_periodic=True, ns_periodic=True, masking=True)


def setup(cfg: ModelConfig | None = None, dtype: torch.dtype = torch.float64,
          device: torch.device | str = "cuda"):
    """Build (grid, state, forcing) for the Filament case, following the
    reference init sequence (reference: main.F:86-321): analytic grid ->
    rest-state depths -> ana_init -> set_depth with the analytic zeta ->
    set_HUV -> omega -> rho_eos.  Builds on the card unless `device`
    says otherwise; raises where there is no CUDA device."""
    if cfg is None:
        cfg = config()
    device = resolve_device(device)
    h = cfg.halo
    npdt = np.float64
    jy, ix = cfg.ny + 2 * h, cfg.nx + 2 * h

    # analytic grid (reference: tests/Filament/ana_grid.h); Fortran index
    # i = -1..nx+2 <-> padded index i+1
    dx = SIZE_X / cfg.nx
    dy = SIZE_Y / cfg.ny
    i_f = np.arange(-1, cfg.nx + 3, dtype=npdt)
    j_f = np.arange(-1, cfg.ny + 3, dtype=npdt)
    xr1 = dx * (i_f - 0.5) - SIZE_X / 2.0
    yr1 = dy * (j_f - 0.5)
    xr = np.broadcast_to(xr1[None, :], (jy, ix)).copy()
    yr = np.broadcast_to(yr1[:, None], (jy, ix)).copy()
    pm = np.full((jy, ix), 1.0 / dx, npdt)
    pn = np.full((jy, ix), 1.0 / dy, npdt)
    f = np.full((jy, ix), F0, npdt)
    hb = np.full((jy, ix), HD, npdt)
    rmask = np.ones((jy, ix), npdt)

    grid = build_grid(cfg, hb, pm, pn, f, rmask, xr=xr, yr=yr, dtype=dtype,
                      device=device)

    # rest-state vertical grid for ana_init (zeta = 0), numpy float64
    cs_w, cs_r = vcoord.stretching_curves(cfg.nz, cfg.theta_s, cfg.theta_b)
    ds = 1.0 / cfg.nz
    hinv0 = 1.0 / (hb + cfg.hc)
    k_w = np.arange(0, cfg.nz + 1, dtype=npdt)[:, None, None]
    k_r = np.arange(1, cfg.nz + 1, dtype=npdt)[:, None, None]
    z_w0 = hb[None] * (cfg.hc * ds * (k_w - cfg.nz)
                       + cs_w[:, None, None] * hb[None]) * hinv0[None]
    z_w0[0] = -hb
    z_r0 = hb[None] * (cfg.hc * ds * (k_r - cfg.nz - 0.5)
                       + cs_r[:, None, None] * hb[None]) * hinv0[None]
    hz0 = z_w0[1:] - z_w0[:-1]

    # ana_init (reference: tests/Filament/ana_init.h)
    g = cfg.g
    alpha = cfg.tcoef / cfg.rho0
    h_sbl = H0 + DH0 * np.exp(-((xr / L_FIL) ** 2))

    def logcosh(x):
        ax = np.abs(x)
        return ax + np.log1p(np.exp(-2.0 * ax)) - np.log(2.0)

    def buoyancy(z, hs):
        return (B0 + NB * (z + HD)
                + 0.5 * N0 * ((1 + B_CFF) * z - (1 - B_CFF)
                              * (hs + LAMBDA_INV
                                 * logcosh((1.0 / LAMBDA_INV) * (z + hs)))))

    t = buoyancy(z_r0, h_sbl[None]) / (g * alpha)

    # bf_int at one interior column (reference: ana_init.h bf_int loop)
    c0 = (h, h)
    bf_int = float(np.sum(hz0[(slice(None),) + c0]
                          * buoyancy(z_r0[(slice(None),) + c0], H0)) / g)

    zeta = np.sum(t * alpha * hz0, axis=0) - bf_int

    # geostrophic v: surface from dzeta/dx, thermal wind downward (the
    # wrapped np.roll values land only in the ghost ring refreshed below)
    v = np.zeros_like(t)
    dzdx = 0.5 * (1.0 / dx) * (np.roll(zeta, -1, axis=1)
                               - np.roll(zeta, 1, axis=1))
    v[cfg.nz - 1] = g * dzdx / F0
    for k in range(cfg.nz - 2, -1, -1):
        dbdx = 0.25 * (1.0 / dx) * g * alpha * (
            np.roll(t[k], -1, axis=1) - np.roll(t[k], 1, axis=1)
            + np.roll(t[k + 1], -1, axis=1) - np.roll(t[k + 1], 1, axis=1))
        v[k] = v[k + 1] - dbdx * (z_r0[k + 1] - z_r0[k]) / F0

    # vbar excludes the top level, as the reference does
    vbar = np.sum(v[:cfg.nz - 1] * hz0[:cfg.nz - 1], axis=0) / HD

    # assemble the state on the device
    def dev(a):
        return torch.as_tensor(a, dtype=dtype, device=device)

    st = zeros_state(cfg, dtype, device)
    halo_fill = make_halo_fill(cfg)
    zeta_t = halo_fill(dev(zeta))
    t_t = halo_fill(dev(t)[None])
    v_t = halo_fill(dev(v))
    vbar_t = halo_fill(dev(vbar))

    # vertical grid from the analytic free surface (reference: main.F:268)
    z_w, z_r, hz = vcoord.set_depth(zeta_t, grid.h, grid.hinv,
                                    grid.cs_w, grid.cs_r, cfg.hc, cfg.nz)
    z_w, z_r, hz = halo_fill(z_w), halo_fill(z_r), halo_fill(hz)

    # initial fast-averaged fluxes (reference: set_depth.F:42-63, iic==0)
    du_avg1 = torch.zeros_like(zeta_t)
    dv_avg1 = 0.5 * (grid.h + shift(grid.h, -1, 0)
                     + zeta_t + shift(zeta_t, -1, 0)) * grid.dm_v * vbar_t
    dv_avg1 = halo_fill(dv_avg1)

    st = st.replace(zeta=zeta_t, vbar=vbar_t, v=v_t, v_prev=v_t,
                    t=t_t, t_prev=t_t, z_w=z_w, z_r=z_r, hz=hz,
                    du_avg1=du_avg1, dv_avg1=dv_avg1)

    # initial kinematics for the step-0 diagnostics (reference: main.F:281-288)
    flx_u, flx_v = kinematics.set_huv(st.u, st.v, hz, grid)
    flx_u, flx_v = halo_fill(flx_u), halo_fill(flx_v)
    om = kinematics.omega(flx_u, flx_v, z_w, hz, st.zeta * 0.0, grid,
                          0.6 * cfg.dt)
    eos0 = rho_eos(st.t, z_r, z_w, hz, grid.rmask, cfg)
    st = st.replace(flx_u=flx_u, flx_v=flx_v,
                    we=halo_fill(om.we), wi=halo_fill(om.wi), rho=eos0.rho)

    return grid, st, zero_forcing(cfg, dtype, device)
