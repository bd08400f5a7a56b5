"""Sponge-layer mixing enhancement near open boundaries (port of
roms_tpu/sponge.py; reference: src/set_nudgcof.F).

Builds the "flat-top roof" profile wrk = (isp - ibnd)/isp where ibnd is the
distance (in grid points) to the nearest open boundary, clipped at
isp = sponge_size + 1 (reference: set_nudgcof.F:42-85), and adds
v_sponge * wrk onto the lateral viscosity (rho + psi points) and every
tracer diffusivity (reference: set_nudgcof.F:87-111).
"""

from __future__ import annotations

import numpy as np
import torch

from roms_tpu_torch.config import ModelConfig
from roms_tpu_torch.grid import Grid
from roms_tpu_torch.parallel.halo import shift


def sponge_profile(cfg: ModelConfig) -> np.ndarray:
    """(jy, ix) profile: 0 in the interior, rising to ~1 at open edges."""
    h = cfg.halo
    jy, ix = cfg.ny + 2 * h, cfg.nx + 2 * h
    isp = cfg.sponge_size + 1
    # absolute physical indices: Fortran i = py - 1 (i=0 is the boundary ring)
    i_f = np.arange(ix) - 1
    j_f = np.arange(jy) - 1
    ibnd = np.full((jy, ix), isp, np.float64)
    if cfg.obc_west:
        ibnd = np.minimum(ibnd, i_f[None, :])
    if cfg.obc_east:
        ibnd = np.minimum(ibnd, cfg.nx + 1 - i_f[None, :])
    if cfg.obc_south:
        ibnd = np.minimum(ibnd, j_f[:, None])
    if cfg.obc_north:
        ibnd = np.minimum(ibnd, cfg.ny + 1 - j_f[:, None])
    ibnd = np.clip(ibnd, 0.0, isp)
    return (isp - ibnd) / isp


def set_nudgcof(grid: Grid, cfg: ModelConfig) -> Grid:
    """Return a grid carrying sponge-enhanced visc2_r/visc2_p/diff2 on the
    grid's device (reference: set_nudgcof.F:87-111)."""
    if not cfg.sponge or cfg.v_sponge == 0.0:
        return grid
    wrk = torch.as_tensor(sponge_profile(cfg), dtype=grid.h.dtype,
                          device=grid.h.device)
    visc2_r = cfg.visc2 + cfg.v_sponge * wrk
    # psi-point average: 0.25*(w(i,j)+w(i-1,j)+w(i,j-1)+w(i-1,j-1))
    visc2_p = cfg.visc2 + 0.25 * cfg.v_sponge * (
        wrk + shift(wrk, 0, -1) + shift(wrk, -1, 0) + shift(wrk, -1, -1))
    diff2 = (cfg.tnu2 + cfg.v_sponge * wrk).repeat(cfg.nt, 1, 1)
    return grid.replace(visc2_r=visc2_r, visc2_p=visc2_p, diff2=diff2)
