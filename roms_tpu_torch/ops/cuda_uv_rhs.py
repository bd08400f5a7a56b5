"""The 3D momentum r.h.s. (Coriolis, horizontal and SPLINE_UV vertical
momentum advection): the CUDA kernel and its plain PyTorch version.

`uv_rhs` launches `csrc/uv_rhs.cu` for a CUDA tensor whose configuration
`usable` admits and calls `uv_rhs_plain` for a CPU tensor, a
configuration `usable` refuses, or the momentum budget's split (`parts`);
any other device raises (`_build.dispatch`).  `launch_plan` picks the
kernel's tile (rows of TILE_I columns, two threads a column): each thread
keeps the spline's cf and fc of its column's nz levels in shared memory,
so nz is capped at NZ_MAX, and a deeper column raises.  `occupancy`
reports a launch configuration on the card.  The plain version is the
port's composition of `advection` functions (the JAX package's
roms_tpu/stepper.py:_uv_rhs; reference: compute_horiz_rhs_uv_terms.h +
compute_vert_rhs_uv_terms.h).
"""

from __future__ import annotations

import torch

from roms_tpu_torch.config import AdvScheme, ModelConfig
from roms_tpu_torch.ops import _build
from roms_tpu_torch.ops import advection as adv

TILE_I = 32                  # columns of a tile along i (one warp a half)
NZ_MAX = 192                 # deepest column the kernel takes
# threads an SM can hold at the kernel's register cap (float 144 a thread,
# double 255), which is also a block's largest size
THREADS_SM = {4: 448, 8: 256}


def smem_bytes(tj: int, nz: int, elem: int) -> int:
    """Shared memory of one block of `tj` tile rows (csrc/uv_rhs.cu:
    smem_bytes): cf and fc of nz levels for each of its 2 * TILE_I * tj
    threads."""
    return 2 * nz * 2 * TILE_I * tj * elem


def launch_plan(elem: int, nz: int) -> tuple[int, int]:
    """(tile rows, shared-memory bytes) of a launch: the tile that keeps
    the most threads resident on an SM (limited by shared memory and by
    the register cap), the tallest among those (its halo rows are read
    by fewer blocks).  Raises ValueError outside 2 <= nz <= NZ_MAX."""
    _build.check_nz("uv_rhs", nz, NZ_MAX)
    best = None
    for tj in range(1, THREADS_SM[elem] // (2 * TILE_I) + 1):
        b = smem_bytes(tj, nz, elem)
        if b > _build.SMEM_BLOCK:
            break
        blocks = min(_build.SMEM_SM // (b + _build.SMEM_RESERVED),
                     THREADS_SM[elem] // (2 * TILE_I * tj))
        key = (blocks * tj, tj)
        if best is None or key > best[0]:
            best = (key, tj, b)
    return best[1], best[2]


def usable(cfg: ModelConfig) -> bool:
    """Whether the kernel covers this configuration's momentum r.h.s.: a
    grid without the mesh's divisibility pad."""
    return cfg.pad_e == 0 and cfg.pad_n == 0


def uv_rhs(u, v, flx_u, flx_v, hz, we, grid, cfg: ModelConfig,
           scheme: AdvScheme, parts: bool = False):
    """(ru, rv), each (nz, jy, ix): the Coriolis, horizontal and vertical
    momentum advection r.h.s. of `uv_rhs_plain` (same arguments); with
    parts=True, which the kernel does not split, the plain version's
    (ru, rv, cori_u, cori_v)."""
    return _build.dispatch("uv_rhs", usable(cfg) and not parts,
                           uv_rhs_plain, _launch, u, v, flx_u, flx_v, hz,
                           we, grid, cfg, scheme, parts=parts)


def _launch(u, v, flx_u, flx_v, hz, we, grid, cfg: ModelConfig,
            scheme: AdvScheme, parts: bool = False):
    """The kernel's path of `uv_rhs` (same arguments, parts False)."""
    nz, jy, ix = u.shape
    tj, smem = launch_plan(u.element_size(), nz)
    if jy < 6 or ix < 6:
        raise ValueError("uv_rhs: jy, ix >= 6 required")
    if (nz + 1) * jy * ix >= 2**31:
        raise ValueError("uv_rhs: (nz + 1) * jy * ix must be < 2**31 (the "
                         "kernel's offsets within a field are ints)")
    curv = cfg.curvgrid and cfg.uv_adv
    cor = cfg.uv_cor or curv
    plane = (grid.fomn, grid.umask, grid.vmask)
    if curv:
        plane += (grid.dndx, grid.dmde)
    _build.check_groups(
        u, ((nz, jy, ix), "u v flx_u flx_v hz", (u, v, flx_u, flx_v, hz)),
        ((nz + 1, jy, ix), "we", (we,)),
        ((jy, ix), "fomn umask vmask dndx dmde", plane))
    ru = torch.empty_like(u)
    rv = torch.empty_like(v)
    p = _build.ptr
    _build.launch(
        "uv_rhs", u,
        [p(u), p(v), p(flx_u), p(flx_v), p(hz), p(we), p(grid.fomn),
         p(grid.dndx) if curv else 0, p(grid.dmde) if curv else 0,
         p(grid.umask), p(grid.vmask), p(ru), p(rv)],
        [nz, jy, ix, int(scheme is AdvScheme.UPSTREAM3), int(cor),
         int(curv), int(cfg.uv_adv), int(cfg.masking), int(cfg.ew_periodic),
         int(cfg.ns_periodic),
         *map(_build.owned, (grid.own_w, grid.own_e, grid.own_s,
                             grid.own_n)), tj, smem])
    return ru, rv


def occupancy(dtype: torch.dtype, nz: int, scheme: AdvScheme) -> dict:
    """The kernel's launch configuration for (dtype, nz, scheme) on the
    current card: tile rows, threads and shared memory per block,
    resident blocks and warps per SM
    (`cudaOccupancyMaxActiveBlocksPerMultiprocessor`), registers and
    stack bytes per thread."""
    elem = torch.empty((), dtype=dtype).element_size()
    tj, smem = launch_plan(elem, nz)
    occ, = _build.occupancy("uv_rhs", [
        int(dtype == torch.float64), int(scheme is AdvScheme.UPSTREAM3), tj,
        nz, smem])
    return {"tile_rows": tj, **occ}


def uv_rhs_plain(u, v, flx_u, flx_v, hz, we, grid, cfg: ModelConfig,
                 scheme: AdvScheme, parts: bool = False):
    """Coriolis + horizontal + vertical momentum advection r.h.s.
    (reference: compute_horiz_rhs_uv_terms.h + compute_vert_rhs_uv_terms.h).

    With parts=True also returns the Coriolis part (cori_u, cori_v) for
    the momentum budget (reference: diagnostics.F icori/iadv)."""
    ru = torch.zeros_like(u)
    rv = torch.zeros_like(v)
    rc_u = rc_v = None
    if cfg.uv_cor or (cfg.curvgrid and cfg.uv_adv):
        rc_u, rc_v = adv.coriolis_rhs(u, v, hz, grid, cfg)
        ru = ru + rc_u
        rv = rv + rc_v
    if cfg.uv_adv:
        ra_u, ra_v = adv.horiz_uv_adv_rhs(u, v, flx_u, flx_v, grid, cfg,
                                          scheme)
        ru = ru + ra_u
        rv = rv + ra_v
        ru = ru + adv.vert_uv_rhs_spline(u, hz, we, grid.umask, grid, cfg, "u")
        rv = rv + adv.vert_uv_rhs_spline(v, hz, we, grid.vmask, grid, cfg, "v")
    if parts:
        return (ru, rv, torch.zeros_like(u) if rc_u is None else rc_u,
                torch.zeros_like(v) if rc_v is None else rc_v)
    return ru, rv
