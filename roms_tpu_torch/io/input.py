"""Input readers: grid and initial state from whole-grid ROMS NetCDF files
(port of roms_tpu/io/input.py; reference: src/grid.F get_grid,
src/get_init.F).

Whole-grid files are read on the host in float64 and embedded into the
padded compute layout; the port's `Grid` and `OceanState` are then built
on the given device.
"""

from __future__ import annotations

import numpy as np
import torch

from roms_tpu_torch import vcoord
from roms_tpu_torch.config import ModelConfig
from roms_tpu_torch.forcing import pad_field
from roms_tpu_torch.grid import Grid, build_grid
from roms_tpu_torch.io.netcdf import open_dataset
from roms_tpu_torch.ops import kinematics, kpp
from roms_tpu_torch.ops.eos import rho_eos
from roms_tpu_torch.parallel.halo import make_halo_fill, shift
from roms_tpu_torch.state import OceanState, zeros_state


def read_grid(path: str, cfg: ModelConfig, *, dtype: torch.dtype,
              device: torch.device) -> Grid:
    """Load a ROMS grid file (variables h, pm, pn, f, mask_rho/rmask,
    lon_rho/lat_rho or x_rho/y_rho; reference: src/grid.F get_grid) and
    build the derived metric terms."""
    with open_dataset(path) as ds:
        def get(*names, required=True):
            for n in names:
                if n in ds:
                    return np.asarray(ds[n][...], np.float64)
            if required:
                raise KeyError(f"{path}: none of {names} found")
            return None

        h = get("h")
        if h.shape[-1] != cfg.nx + 2 or h.shape[-2] != cfg.ny + 2:
            raise ValueError(
                f"{path}: grid is {h.shape[-2]}x{h.shape[-1]} (eta,xi) but "
                f"config wants interior {cfg.ny}x{cfg.nx} "
                f"(expected {cfg.ny + 2}x{cfg.nx + 2} incl. boundary ring)")
        pm = get("pm")
        pn = get("pn")
        f = get("f")
        rmask = get("mask_rho", "rmask", required=False)
        if rmask is None:
            rmask = np.ones_like(h)
        xr = get("x_rho", "lon_rho", required=False)
        yr = get("y_rho", "lat_rho", required=False)

    def pad(a):
        return pad_field(a, cfg) if a is not None else None

    return build_grid(cfg, pad(h), pad(pm), pad(pn), pad(f), pad(rmask),
                      xr=pad(xr), yr=pad(yr), dtype=dtype, device=device)


def read_init(path: str, cfg: ModelConfig, grid: Grid, record: int = -1, *,
              dtype: torch.dtype, device: torch.device,
              tracer_names=None) -> OceanState:
    """Load initial conditions (zeta, ubar, vbar, u, v, temp[, salt], and
    any further tracers by their file variable names) from a ROMS
    initial/history file at `record` (reference: src/get_init.F; tracer
    variable naming: src/tracers.opt t_vname), then rebuild the vertical
    grid and derived fields."""
    with open_dataset(path) as ds:
        def get(name, rec=record, required=True):
            if name not in ds:
                if required:
                    raise KeyError(f"{path}: missing {name}")
                return None
            var = ds[name]
            return np.asarray(var[rec] if "time" in var.dims[0]
                              else var[...], np.float64)

        zeta = get("zeta")
        ubar = get("ubar")
        vbar = get("vbar")
        u = get("u")
        v = get("v")
        if tracer_names is None:
            tracer_names = ["temp"] + (["salt"] if cfg.salinity else [])
            tracer_names += [f"passive_{i:02d}"
                             for i in range(len(tracer_names), cfg.nt)]
        tracers = []
        for i, nm in enumerate(tracer_names):
            a = get(nm, required=(i < cfg.i_t_and_s))
            tracers.append(a if a is not None
                           else np.zeros_like(tracers[0]))
        tm = get("ocean_time", required=False)

    halo_fill = make_halo_fill(cfg)

    def pad(a):
        return halo_fill(torch.as_tensor(pad_field(a, cfg), dtype=dtype,
                                         device=device))

    st = zeros_state(cfg, dtype, device)
    zeta_t = pad(zeta)
    z_w, z_r, hz = vcoord.set_depth(zeta_t, grid.h, grid.hinv,
                                    grid.cs_w, grid.cs_r, cfg.hc, cfg.nz)
    z_w, z_r, hz = halo_fill(z_w), halo_fill(z_r), halo_fill(hz)
    u_t, v_t = pad(u), pad(v)
    ubar_t, vbar_t = pad(ubar), pad(vbar)
    t_t = torch.stack([pad(t) for t in tracers], dim=0)

    # initial fast-averaged transports from (zeta, ubar, vbar)
    # (reference: set_depth.F:42-63 iic==0 branch)
    du_avg1 = 0.5 * (grid.h + shift(grid.h, 0, -1)
                     + zeta_t + shift(zeta_t, 0, -1)) * grid.dn_u * ubar_t
    dv_avg1 = 0.5 * (grid.h + shift(grid.h, -1, 0)
                     + zeta_t + shift(zeta_t, -1, 0)) * grid.dm_v * vbar_t

    # solar penetration profile from the rest-state thickness, once
    # (reference: main.F:216-220 swr_frac at init)
    _, _, hz0 = vcoord.set_depth(zeta_t * 0.0, grid.h, grid.hinv,
                                 grid.cs_w, grid.cs_r, cfg.hc, cfg.nz)
    st = st.replace(zeta=zeta_t, ubar=ubar_t, vbar=vbar_t,
                    u=u_t, v=v_t, u_prev=u_t, v_prev=v_t,
                    t=t_t, t_prev=t_t, z_w=z_w, z_r=z_r, hz=hz,
                    swrf=kpp.swr_frac(hz0, cfg),
                    du_avg1=halo_fill(du_avg1), dv_avg1=halo_fill(dv_avg1))

    flx_u, flx_v = kinematics.set_huv(st.u, st.v, hz, grid)
    flx_u, flx_v = halo_fill(flx_u), halo_fill(flx_v)
    om = kinematics.omega(flx_u, flx_v, z_w, hz, st.zeta * 0.0, grid,
                          0.6 * cfg.dt)
    eos0 = rho_eos(st.t, z_r, z_w, hz, grid.rmask, cfg)
    st = st.replace(flx_u=flx_u, flx_v=flx_v,
                    we=halo_fill(om.we), wi=halo_fill(om.wi), rho=eos0.rho)
    if tm is not None:
        st = st.replace(time=torch.tensor(
            float(np.ravel(tm)[-1] if np.ndim(tm) else tm), dtype=dtype,
            device=device))
    return st
