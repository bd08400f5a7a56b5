"""Model state, forcing and boundary data as dataclasses of tensors
(port of roms_tpu/state.py).

Time levels are explicit named fields, as in the JAX package.  All
horizontal fields carry the halo ghosts; 3D fields are (nz, jy, ix),
w-type fields (nz+1, jy, ix), tracers (nt, nz, jy, ix).  `iic` is an
int32 0-d tensor and `time` a 0-d tensor of the model dtype.

The step never writes into a tensor that a state holds: `replace`
returns a new object sharing the unchanged tensors, so `u_prev=state.u`
aliases safely exactly as in the JAX package.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional

import torch

from bench_h100.reference.config import ModelConfig


class _Replace:
    def replace(self, **kw):
        return dataclasses.replace(self, **kw)


@dataclass
class BoundaryData(_Replace):
    """Open-boundary data, one slice per open edge (see
    roms_tpu.state.BoundaryData); every field optional.  ub_*: per-point
    Orlanski binding velocities (cfg.ubind when None)."""
    zeta_west: Optional[torch.Tensor] = None
    zeta_east: Optional[torch.Tensor] = None
    zeta_south: Optional[torch.Tensor] = None
    zeta_north: Optional[torch.Tensor] = None
    ubar_west: Optional[torch.Tensor] = None
    ubar_east: Optional[torch.Tensor] = None
    ubar_south: Optional[torch.Tensor] = None
    ubar_north: Optional[torch.Tensor] = None
    vbar_west: Optional[torch.Tensor] = None
    vbar_east: Optional[torch.Tensor] = None
    vbar_south: Optional[torch.Tensor] = None
    vbar_north: Optional[torch.Tensor] = None
    u_west: Optional[torch.Tensor] = None
    u_east: Optional[torch.Tensor] = None
    u_south: Optional[torch.Tensor] = None
    u_north: Optional[torch.Tensor] = None
    v_west: Optional[torch.Tensor] = None
    v_east: Optional[torch.Tensor] = None
    v_south: Optional[torch.Tensor] = None
    v_north: Optional[torch.Tensor] = None
    t_west: Optional[torch.Tensor] = None
    t_east: Optional[torch.Tensor] = None
    t_south: Optional[torch.Tensor] = None
    t_north: Optional[torch.Tensor] = None
    ub_west: Optional[torch.Tensor] = None
    ub_east: Optional[torch.Tensor] = None
    ub_south: Optional[torch.Tensor] = None
    ub_north: Optional[torch.Tensor] = None


@dataclass
class Forcing(_Replace):
    """Surface forcing and point sources (see roms_tpu.state.Forcing)."""
    sustr: torch.Tensor
    svstr: torch.Tensor
    stflx: torch.Tensor            # (nt, jy, ix)
    srflx: torch.Tensor
    swflx: torch.Tensor
    sst: Optional[torch.Tensor] = None
    sss: Optional[torch.Tensor] = None
    riv_uflx: Optional[torch.Tensor] = None
    riv_vflx: Optional[torch.Tensor] = None
    riv_vol: Optional[torch.Tensor] = None
    riv_trc: Optional[torch.Tensor] = None
    pipe_flx: Optional[torch.Tensor] = None
    pipe_idx: Optional[torch.Tensor] = None
    pipe_prf: Optional[torch.Tensor] = None
    pipe_trc: Optional[torch.Tensor] = None
    bry: Optional[BoundaryData] = None
    ptide: Optional[torch.Tensor] = None
    cdr: Optional[object] = None
    bgc: Optional[dict] = None


@dataclass
class OceanState(_Replace):
    zeta: torch.Tensor
    ubar: torch.Tensor
    vbar: torch.Tensor
    u: torch.Tensor
    v: torch.Tensor
    u_prev: torch.Tensor
    v_prev: torch.Tensor
    t: torch.Tensor
    t_prev: torch.Tensor
    z_w: torch.Tensor
    z_r: torch.Tensor
    hz: torch.Tensor
    du_avg1: torch.Tensor
    dv_avg1: torch.Tensor
    du_avg2: torch.Tensor
    dv_avg2: torch.Tensor
    du_avg_bak: torch.Tensor
    dv_avg_bak: torch.Tensor
    flx_u: torch.Tensor
    flx_v: torch.Tensor
    we: torch.Tensor
    wi: torch.Tensor
    rho: torch.Tensor
    akv: torch.Tensor              # (nz+1, jy, ix)
    akt: torch.Tensor              # (n_akt, nz+1, jy, ix)
    hbls: torch.Tensor
    hbbl: torch.Tensor
    swrf: torch.Tensor             # (nz+1, jy, ix)
    iic: torch.Tensor              # int32 step counter
    time: torch.Tensor             # model time [s]
    upscale: Optional[dict] = None
    t_budget: Optional[dict] = None
    uv_budget: Optional[dict] = None


def zeros_state(cfg: ModelConfig, dtype: torch.dtype,
                device: torch.device) -> OceanState:
    h = cfg.halo
    jy, ix = cfg.ny + 2 * h, cfg.nx + 2 * h

    def z(*shape):
        return torch.zeros(shape, dtype=dtype, device=device)

    return OceanState(
        zeta=z(jy, ix), ubar=z(jy, ix), vbar=z(jy, ix),
        u=z(cfg.nz, jy, ix), v=z(cfg.nz, jy, ix),
        u_prev=z(cfg.nz, jy, ix), v_prev=z(cfg.nz, jy, ix),
        t=z(cfg.nt, cfg.nz, jy, ix), t_prev=z(cfg.nt, cfg.nz, jy, ix),
        z_w=z(cfg.nz + 1, jy, ix), z_r=z(cfg.nz, jy, ix),
        hz=z(cfg.nz, jy, ix),
        du_avg1=z(jy, ix), dv_avg1=z(jy, ix), du_avg2=z(jy, ix),
        dv_avg2=z(jy, ix), du_avg_bak=z(jy, ix), dv_avg_bak=z(jy, ix),
        flx_u=z(cfg.nz, jy, ix), flx_v=z(cfg.nz, jy, ix),
        we=z(cfg.nz + 1, jy, ix), wi=z(cfg.nz + 1, jy, ix),
        rho=z(cfg.nz, jy, ix),
        akv=z(cfg.nz + 1, jy, ix),
        akt=z(cfg.i_t_and_s, cfg.nz + 1, jy, ix),
        hbls=z(jy, ix), hbbl=z(jy, ix), swrf=z(cfg.nz + 1, jy, ix),
        iic=torch.zeros((), dtype=torch.int32, device=device),
        time=torch.zeros((), dtype=dtype, device=device),
    )


def zero_boundary(cfg: ModelConfig, dtype: torch.dtype,
                  device: torch.device) -> BoundaryData:
    """Zero-valued boundary data on every open edge of `cfg`."""
    h = cfg.halo
    jy, ix = cfg.ny + 2 * h, cfg.nx + 2 * h

    def z(*shape):
        return torch.zeros(shape, dtype=dtype, device=device)

    kw = {}
    for edge, n in (("west", jy), ("east", jy), ("south", ix), ("north", ix)):
        if not getattr(cfg, f"obc_{edge}"):
            continue
        kw[f"zeta_{edge}"] = z(n)
        kw[f"ubar_{edge}"] = z(n)
        kw[f"vbar_{edge}"] = z(n)
        kw[f"u_{edge}"] = z(cfg.nz, n)
        kw[f"v_{edge}"] = z(cfg.nz, n)
        kw[f"t_{edge}"] = z(cfg.nt, cfg.nz, n)
    return BoundaryData(**kw)


def zero_forcing(cfg: ModelConfig, dtype: torch.dtype,
                 device: torch.device) -> Forcing:
    h = cfg.halo
    jy, ix = cfg.ny + 2 * h, cfg.nx + 2 * h

    def z(*shape):
        return torch.zeros(shape, dtype=dtype, device=device)

    return Forcing(sustr=z(jy, ix), svstr=z(jy, ix),
                   stflx=z(cfg.nt, jy, ix), srflx=z(jy, ix),
                   swflx=z(jy, ix))
