"""Global diagnostics: volume-averaged energies and maximum Courant
numbers (port of roms_tpu/diag.py; reference: src/diag.F).

The reported volume sums keep the canonical pairwise order of the JAX
package's `deterministic_sum` (8x8 canonical blocks, each summed by an
explicit pairwise tree of elementwise adds, then the 64 block sums in one
fixed tree), so they do not depend on how a reduction is scheduled on the
device: no `torch.sum` and no atomics feed them.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from roms_tpu_torch.config import ModelConfig
from roms_tpu_torch.grid import Grid
from roms_tpu_torch.parallel.halo import shift
from roms_tpu_torch.state import OceanState


class Diag(NamedTuple):
    avke: torch.Tensor      # volume-mean kinetic energy (KINETIC_ENRG)
    avke2b: torch.Tensor    # barotropic KE (BAROTR_KE)
    avpe: torch.Tensor      # potential energy
    avzeta: torch.Tensor    # area-mean free surface
    cu_adv: torch.Tensor    # max advective Courant number (MAX_ADV_CFL)
    cu_w: torch.Tensor      # its vertical part (MAX_VERT_CFL)
    v2d_max: torch.Tensor


NB_SUM = 8  # canonical sum-block grid (NB_SUM x NB_SUM blocks)


def _interior(a, h):
    return a[..., h:-h, h:-h]


def _pairwise_last(x):
    """Exact pairwise binary-tree sum over the last axis (zero-padded to a
    power of two; explicit elementwise adds fix the pairing)."""
    n = x.shape[-1]
    m = 1 << max(n - 1, 0).bit_length()
    if m != n:
        x = F.pad(x, (0, m - n))
    while x.shape[-1] > 1:
        x = x[..., 0::2] + x[..., 1::2]
    return x[..., 0]


def _block_sums(f2d, nby, nbx):
    """Pairwise-tree sum of each (nby x nbx) block -> (nby, nbx)."""
    ny, nx = f2d.shape
    by, bx = ny // nby, nx // nbx
    b = f2d.reshape(nby, by, nbx, bx).permute(0, 2, 1, 3)
    return _pairwise_last(b.reshape(nby, nbx, by * bx))


def deterministic_sum(f2d):
    """Canonical-block pairwise sum of a full 2D interior field; the
    pairing depends only on the interior shape."""
    ny, nx = f2d.shape
    pn = (-ny) % NB_SUM
    px = (-nx) % NB_SUM
    if pn or px:
        f2d = F.pad(f2d, (0, px, 0, pn))
    blocks = _block_sums(f2d, NB_SUM, NB_SUM)
    return _pairwise_last(blocks.reshape(1, -1))[0]


def compute_diag(state: OceanState, grid: Grid, cfg: ModelConfig) -> Diag:
    """Diagnostics of the just-completed step: the time-n velocity
    (state.u_prev), the new Hz/z_w, the corrected fluxes and the new
    density (reference: diag.F:129-237)."""
    h = cfg.halo
    ke, ke2b, pe, dvol, cx, cw, v2_2d = _local_fields(state, grid, cfg)

    cx_i = _interior(cx, h)
    cw_i = _interior(cw, h)
    idx = torch.argmax(cx_i.reshape(-1))       # first maximum, as jnp
    cu_adv = cx_i.reshape(-1)[idx]
    cu_w = cw_i.reshape(-1)[idx]

    s_zeta = deterministic_sum(_interior(dvol, h))
    s_ke = deterministic_sum(_interior(ke, h))
    s_pe = deterministic_sum(_interior(pe, h))
    s_ke2b = deterministic_sum(_interior(ke2b, h))
    denom = grid.volume + s_zeta
    return Diag(avke=s_ke / denom, avke2b=s_ke2b / denom, avpe=s_pe / denom,
                avzeta=s_zeta / grid.area, cu_adv=cu_adv, cu_w=cu_w,
                v2d_max=torch.sqrt(torch.max(_interior(v2_2d, h))))


def _local_fields(state: OceanState, grid: Grid, cfg: ModelConfig):
    """Per-point diagnostic fields (reference: diag.F:129-237)."""
    u = state.u_prev
    v = state.v_prev
    hz = state.hz
    z_w = state.z_w
    ub = torch.sum((hz + shift(hz, 0, -1)) * u, dim=0) / (
        z_w[-1] + shift(z_w[-1], 0, -1) - z_w[0] - shift(z_w[0], 0, -1))
    vb = torch.sum((hz + shift(hz, -1, 0)) * v, dim=0) / (
        z_w[-1] + shift(z_w[-1], -1, 0) - z_w[0] - shift(z_w[0], -1, 0))
    v2_2d = 0.5 * (ub ** 2 + shift(ub, 0, 1) ** 2
                   + vb ** 2 + shift(vb, 1, 0) ** 2)
    v2_3d = 0.5 * (u ** 2 + shift(u, 0, 1) ** 2
                   + v ** 2 + shift(v, 1, 0) ** 2)
    da = (grid.rmask if cfg.masking else 1.0) / (grid.pm * grid.pn)
    ke = da * torch.sum(0.5 * v2_3d * hz, dim=0)
    ke2b = da * 0.5 * (z_w[-1] - z_w[0]) * v2_2d
    cffg = cfg.g / cfg.rho0
    pe = da * (0.5 * cfg.g * z_w[-1] ** 2
               + torch.sum(cffg * hz * state.rho * (state.z_r - z_w[0][None]),
                           dim=0))
    dvol = da * z_w[-1]
    if cfg.masking:
        civ = cfg.dt * grid.rmask[None] * (grid.pm * grid.pn)[None] / hz
    else:
        civ = cfg.dt * (grid.pm * grid.pn)[None] / hz
    wtot = state.we + state.wi
    cw = civ * (torch.clamp(wtot[1:], min=0.0) - torch.clamp(wtot[:-1], max=0.0))
    cx = cw + civ * (torch.clamp(shift(state.flx_u, 0, 1), min=0.0)
                     - torch.clamp(state.flx_u, max=0.0)
                     + torch.clamp(shift(state.flx_v, 1, 0), min=0.0)
                     - torch.clamp(state.flx_v, max=0.0))
    return ke, ke2b, pe, dvol, cx, cw, v2_2d


def make_distributed_diag(cfg: ModelConfig, mesh):
    """This rank's diagnostics over block-halo-layout state
    (`parallel.dist`); every rank calls it and gets the same Diag.

    The four volume sums all-gather each block's interior partial fields
    (ke, ke2b, pe, dvol), lay them out in canonical (y, x) order, crop the
    mesh-divisibility pad and call the same `deterministic_sum` as
    `compute_diag`.  The Courant maxima all-gather each block's first
    maximum over its share of the interior with its index in the global
    (k, j, i) order, and take the first of the largest, as `compute_diag`'s
    argmax does.  So the diagnostics are bitwise those of `compute_diag`
    on the gathered state, on any grid and any mesh (the reference's
    rank-count-independent reduction, diag.F:14 SUM_BY_PAIRS,
    :434-470).  `cfg` is the mesh-padded config (pad_for_mesh)."""
    h = cfg.halo
    py, px = mesh.shape
    my, mx = cfg.ny // py, cfg.nx // px
    ny, nx = cfg.ny - cfg.pad_n, cfg.nx - cfg.pad_e
    j0, i0 = mesh.iy * my, mesh.ix * mx
    # this block's share of the unpadded interior
    ry, rx = max(0, min(my, ny - j0)), max(0, min(mx, nx - i0))

    def diag(state: OceanState, grid: Grid) -> Diag:
        ke, ke2b, pe, dvol, cx, cw, v2_2d = _local_fields(state, grid, cfg)
        parts = torch.stack([_interior(f, h) for f in (ke, ke2b, pe, dvol)])
        blocks = mesh.all_gather(parts)
        g = torch.cat([torch.cat([blocks[r] for r in row], dim=-1)
                       for row in mesh.ranks], dim=-2)[:, :ny, :nx]
        s_ke, s_ke2b, s_pe, s_zeta = (deterministic_sum(g[k])
                                      for k in range(4))

        row = torch.zeros(5, dtype=torch.float64, device=cx.device)
        if ry and rx:
            cx_i = _interior(cx, h)[:, :ry, :rx].reshape(-1)
            k = torch.argmax(cx_i)
            kz, rem = k // (ry * rx), k % (ry * rx)
            gidx = kz * (ny * nx) + (j0 + rem // rx) * nx + i0 + rem % rx
            row = torch.stack([torch.ones_like(row[0]), cx_i[k].double(),
                               _interior(cw, h)[:, :ry, :rx].reshape(-1)[k]
                               .double(),
                               torch.max(_interior(v2_2d, h)[:ry, :rx])
                               .double(), gidx.double()])
        rows = torch.stack(mesh.all_gather(row)).cpu().numpy()
        rows = rows[rows[:, 0] == 1.0]
        # the first of the largest (a NaN counts as the largest, as in
        # argmax)
        best = min(rows, key=lambda r: (not np.isnan(r[1]),
                                        -np.nan_to_num(r[1], nan=0.0), r[4]))
        dtype = parts.dtype

        def scalar(x):
            return torch.tensor(x, dtype=dtype, device=parts.device)

        denom = grid.volume + s_zeta
        return Diag(avke=s_ke / denom, avke2b=s_ke2b / denom,
                    avpe=s_pe / denom, avzeta=s_zeta / grid.area,
                    cu_adv=scalar(best[1]), cu_w=scalar(best[2]),
                    v2d_max=torch.sqrt(scalar(np.max(rows[:, 3]))))

    return diag
