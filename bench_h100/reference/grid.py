"""Horizontal grid and derived metric terms (port of roms_tpu/grid.py;
reference: src/setup_grid1.F, src/setup_grid2.F).

All horizontal fields are padded with the halo and (j, i)-indexed with i
fastest.  The global invariants `area`/`volume` are summed in float64
numpy over the interior, exactly as the JAX package does.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from bench_h100.reference import vcoord
from bench_h100.reference.config import ModelConfig
from bench_h100.reference.parallel.halo import shift
from bench_h100.reference.state import _Replace


@dataclass
class Grid(_Replace):
    h: torch.Tensor
    hinv: torch.Tensor
    pm: torch.Tensor
    pn: torch.Tensor
    f: torch.Tensor
    fomn: torch.Tensor
    rmask: torch.Tensor
    umask: torch.Tensor
    vmask: torch.Tensor
    pmask: torch.Tensor
    xr: torch.Tensor
    yr: torch.Tensor
    dm_r: torch.Tensor
    dn_r: torch.Tensor
    dm_u: torch.Tensor
    dn_u: torch.Tensor
    dm_v: torch.Tensor
    dn_v: torch.Tensor
    dm_p: torch.Tensor
    dn_p: torch.Tensor
    pm_u: torch.Tensor
    pn_u: torch.Tensor
    pm_v: torch.Tensor
    pn_v: torch.Tensor
    pmon_u: torch.Tensor
    pnom_v: torch.Tensor
    dndx: Optional[torch.Tensor]
    dmde: Optional[torch.Tensor]
    cs_w: torch.Tensor             # (nz+1,)
    cs_r: torch.Tensor             # (nz,)
    area: torch.Tensor
    volume: torch.Tensor
    visc2_r: Optional[torch.Tensor] = None
    visc2_p: Optional[torch.Tensor] = None
    diff2: Optional[torch.Tensor] = None
    # edge ownership and the block's offsets in the padded interior, fixed
    # per mesh rank (parallel.dist._with_ownership); None = single block,
    # which owns every edge
    own_w: Optional[bool] = None
    own_e: Optional[bool] = None
    own_s: Optional[bool] = None
    own_n: Optional[bool] = None
    j0: Optional[int] = None
    i0: Optional[int] = None


def build_grid(cfg: ModelConfig, h, pm, pn, f, rmask, xr=None, yr=None, *,
               dtype: torch.dtype, device: torch.device) -> Grid:
    """Derive all metric combinations from the primary padded fields
    (numpy arrays or tensors, (ny+2h, nx+2h)); mirrors setup_grid1 over the
    full extended range (reference: src/setup_grid1.F:59-211)."""
    def t(a):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

    h, pm, pn, f, rmask = t(h), t(pm), t(pn), t(f), t(rmask)
    xr = torch.zeros_like(h) if xr is None else t(xr)
    yr = torch.zeros_like(h) if yr is None else t(yr)

    fomn = f / (pm * pn)
    dm_r = 1.0 / pm
    dn_r = 1.0 / pn

    pm_w = shift(pm, 0, -1)
    pn_w = shift(pn, 0, -1)
    pm_s = shift(pm, -1, 0)
    pn_s = shift(pn, -1, 0)

    dm_u = 2.0 / (pm + pm_w)
    dn_u = 2.0 / (pn + pn_w)
    pm_u = 0.5 * (pm + pm_w)
    pn_u = 0.5 * (pn + pn_w)
    pmon_u = (pm + pm_w) / (pn + pn_w)

    dm_v = 2.0 / (pm + pm_s)
    dn_v = 2.0 / (pn + pn_s)
    pm_v = 0.5 * (pm + pm_s)
    pn_v = 0.5 * (pn + pn_s)
    pnom_v = (pn + pn_s) / (pm + pm_s)

    pm_sw = shift(pm, -1, -1)
    pn_sw = shift(pn, -1, -1)
    dm_p = 4.0 / (pm + pm_w + pm_s + pm_sw)
    dn_p = 4.0 / (pn + pn_w + pn_s + pn_sw)

    umask = rmask * shift(rmask, 0, -1)
    vmask = rmask * shift(rmask, -1, 0)
    # psi mask (reference: setup_grid1.F:150-190): 1 with >= 3 water
    # corners, 2 with exactly two, else 0
    nwater = rmask + shift(rmask, 0, -1) + shift(rmask, -1, 0) \
        + shift(rmask, -1, -1)
    one = torch.ones_like(nwater)
    pmask = torch.where(nwater >= 3.0, one,
                        torch.where(nwater == 2.0, 2.0 * one, 0.0 * one))

    if cfg.curvgrid:
        dndx = 0.5 / shift(pn, 0, 1) - 0.5 / shift(pn, 0, -1)
        dmde = 0.5 / shift(pm, 1, 0) - 0.5 / shift(pm, -1, 0)
    else:
        dndx = dmde = None

    cs_w, cs_r = vcoord.stretching_curves(cfg.nz, cfg.theta_s, cfg.theta_b)

    # global invariants over the interior (reference: setup_grid2.F:97-106)
    hl = cfg.halo
    intr = (slice(hl, -hl), slice(hl, -hl))
    dA = (rmask[intr] / (pm[intr] * pn[intr])).cpu().numpy().astype(
        np.float64)
    area = dA.sum()
    volume = (dA * h[intr].cpu().numpy().astype(np.float64)).sum()

    return Grid(
        h=h, hinv=1.0 / (h + cfg.hc), pm=pm, pn=pn, f=f, fomn=fomn,
        rmask=rmask, umask=umask, vmask=vmask, pmask=pmask, xr=xr, yr=yr,
        dm_r=dm_r, dn_r=dn_r, dm_u=dm_u, dn_u=dn_u, dm_v=dm_v, dn_v=dn_v,
        dm_p=dm_p, dn_p=dn_p, pm_u=pm_u, pn_u=pn_u, pm_v=pm_v, pn_v=pn_v,
        pmon_u=pmon_u, pnom_v=pnom_v, dndx=dndx, dmde=dmde,
        cs_w=t(cs_w), cs_r=t(cs_r), area=t(area), volume=t(volume))


def grid_stiffness(z_w, grid, cfg: ModelConfig):
    """Maximum grid stiffness ratios rx0 (Beckmann-Haidvogel, bottom
    slope) and rx1 (Haney, layer-interface slope) over unmasked u/v faces
    of the interior; purely diagnostic, in float64 numpy on the host
    (reference: src/grid_stiffness.F grid_stiffness_tile; printed at init,
    main.F:223-225).

    z_w: (nz+1, jy, ix) rest-state interface depths.  Returns
    (rx0, rx1) floats."""
    def host(a):
        return torch.as_tensor(a).detach().cpu().numpy()

    zw = host(z_w).astype(np.float64)
    h_ = cfg.halo

    def face_ratios(zw_m, zw_p, mask):
        # zw_m/zw_p: (nz+1, ...) at the two cells of each face
        r0 = np.abs((zw_p[0] - zw_m[0]) / (zw_p[0] + zw_m[0]))
        num = (zw_p[1:] - zw_m[1:] + zw_p[:-1] - zw_m[:-1])
        den = (zw_p[1:] + zw_m[1:] - zw_p[:-1] - zw_m[:-1])
        r1 = np.abs(num / den).max(axis=0)
        if mask is not None:
            keep = mask.astype(np.float64) > 0.5
            r0 = np.where(keep, r0, 0.0)
            r1 = np.where(keep, r1, 0.0)
        return r0, r1

    sl = (slice(h_, -h_), slice(h_, -h_))
    um = host(grid.umask)[sl] if cfg.masking else None
    vm = host(grid.vmask)[sl] if cfg.masking else None
    # u faces: cell (j, i) vs (j, i-1); v faces: (j, i) vs (j-1, i)
    r0u, r1u = face_ratios(zw[:, h_:-h_, h_ - 1:-h_ - 1],
                           zw[:, h_:-h_, h_:-h_], um)
    r0v, r1v = face_ratios(zw[:, h_ - 1:-h_ - 1, h_:-h_],
                           zw[:, h_:-h_, h_:-h_], vm)
    rx0 = max(float(r0u.max()), float(r0v.max()))
    rx1 = max(float(r1u.max()), float(r1v.max()))
    return rx0, rx1
