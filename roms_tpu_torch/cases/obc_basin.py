"""Idealized open-boundary basin cases (port of
roms_tpu/cases/obc_basin.py): the quick check of the boundary-condition
menu without KPP (reference: tests/Flux_frc/cppdefs.opt OBC_* switches
with OBC_M2FLATHER / OBC_M3ORLANSKI / OBC_TORLANSKI + *_FRC_BRY).

  * `radiating`: flat-bottom basin, Gaussian free-surface bump, all four
    edges open with zero external data.
  * `inflow`: west/east open with specified external data driving a
    uniform zonal inflow carrying a tracer anomaly into the domain.
  * `closed`: the same basin with four walls.
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
from roms_tpu_torch.parallel.halo import shift
from roms_tpu_torch.state import zero_boundary, zero_forcing, zeros_state

H0 = 100.0      # flat bottom depth [m]
F0 = 1.0e-4     # Coriolis
DX = 1000.0     # grid spacing [m]
ZAMP = 0.1      # initial bump amplitude [m]


def config(mode: str = "radiating", ntimes: int = 60) -> ModelConfig:
    """The same ModelConfig as roms_tpu.cases.obc_basin.config."""
    common = dict(
        nx=64, ny=64, nz=10, nt=1,
        dt=60.0, ndtfast=30, ntimes=ntimes,
        theta_s=3.0, theta_b=0.0, hc=50.0,
        nonlin_eos=False, salinity=False, tcoef=0.2, t0=1.0,
        ew_periodic=False, ns_periodic=False, masking=True,
        uv_adv=True, uv_cor=True,
        rdrg=0.0, visc2=0.0, tnu2=0.0,
        frc_bry=True, ubind=0.1)
    if mode == "radiating":
        return ModelConfig(obc_west=True, obc_east=True,
                           obc_south=True, obc_north=True,
                           obc_m2="flather", obc_m3="orlanski",
                           obc_t="orlanski", **common)
    if mode == "inflow":
        # specified tracer data at the inflow boundary (OBC_TSPECIFIED)
        return ModelConfig(obc_west=True, obc_east=True,
                           obc_m2="flather", obc_m3="orlanski",
                           obc_t="specified", **common)
    if mode == "closed":
        return ModelConfig(**common)
    raise ValueError(mode)


def setup(cfg: ModelConfig, dtype: torch.dtype = torch.float64,
          device: torch.device | str = "cuda", inflow_u: float = 0.0,
          t_inflow: float | None = None):
    """Build (grid, state, forcing) on the card unless `device` says
    otherwise.  For the inflow case pass `inflow_u` > 0 and `t_inflow`
    (boundary tracer value)."""
    device = resolve_device(device)
    h = cfg.halo
    npdt = np.float64
    jy, ix = cfg.ny + 2 * h, cfg.nx + 2 * h

    i_f = np.arange(-1, cfg.nx + 3, dtype=npdt)
    j_f = np.arange(-1, cfg.ny + 3, dtype=npdt)
    xr = np.broadcast_to((DX * (i_f - 0.5))[None, :], (jy, ix)).copy()
    yr = np.broadcast_to((DX * (j_f - 0.5))[:, None], (jy, ix)).copy()
    pm = np.full((jy, ix), 1.0 / DX, npdt)
    pn = np.full((jy, ix), 1.0 / DX, npdt)
    f = np.full((jy, ix), F0, npdt)
    hb = np.full((jy, ix), H0, npdt)
    rmask = np.ones((jy, ix), npdt)
    grid = build_grid(cfg, hb, pm, pn, f, rmask, xr=xr, yr=yr, dtype=dtype,
                      device=device)

    st = zeros_state(cfg, dtype, device)
    if inflow_u == 0.0:
        # Gaussian free-surface bump in the basin center
        xc = 0.5 * cfg.nx * DX
        yc = 0.5 * cfg.ny * DX
        r2 = (xr - xc) ** 2 + (yr - yc) ** 2
        zeta = torch.as_tensor(ZAMP * np.exp(-r2 / (8.0 * DX) ** 2),
                               dtype=dtype, device=device)
        u = st.u
        ubar = st.ubar
    else:
        zeta = st.zeta
        u = torch.full_like(st.u, inflow_u)
        ubar = torch.full_like(st.ubar, inflow_u)

    z_w, z_r, hz = vcoord.set_depth(zeta, grid.h, grid.hinv,
                                    grid.cs_w, grid.cs_r, cfg.hc, cfg.nz)
    t = torch.ones((cfg.nt, cfg.nz, jy, ix), dtype=dtype, device=device)
    du_avg1 = 0.5 * (grid.h + shift(grid.h, 0, -1)
                     + zeta + shift(zeta, 0, -1)) * grid.dn_u * ubar
    st = st.replace(zeta=zeta, u=u, u_prev=u, ubar=ubar,
                    t=t, t_prev=t, z_w=z_w, z_r=z_r, hz=hz,
                    du_avg1=du_avg1)

    flx_u, flx_v = kinematics.set_huv(st.u, st.v, hz, grid)
    om = kinematics.omega(flx_u, flx_v, z_w, hz, st.zeta * 0.0, grid,
                          0.6 * cfg.dt)
    eos0 = rho_eos(st.t, z_r, z_w, hz, grid.rmask, cfg)
    st = st.replace(flx_u=flx_u, flx_v=flx_v, we=om.we, wi=om.wi,
                    rho=eos0.rho)

    bry = zero_boundary(cfg, dtype, device)
    if inflow_u != 0.0:
        tb = t_inflow if t_inflow is not None else 1.0

        def full(shape, val):
            return torch.full(shape, val, dtype=dtype, device=device)

        bry = bry.replace(
            ubar_west=full((jy,), inflow_u),
            u_west=full((cfg.nz, jy), inflow_u),
            t_west=full((cfg.nt, cfg.nz, jy), tb),
            ubar_east=full((jy,), inflow_u),
            u_east=full((cfg.nz, jy), inflow_u),
            t_east=full((cfg.nt, cfg.nz, jy), 1.0))
    forcing = zero_forcing(cfg, dtype, device).replace(bry=bry)
    return grid, st, forcing
