"""The 3D momentum r.h.s. (Coriolis, horizontal and SPLINE_UV vertical
momentum advection): the CUDA kernel and its plain PyTorch version.

`uv_rhs` launches `csrc/uv_rhs.cu` for a CUDA tensor and calls
`uv_rhs_plain` for a CPU tensor; any other device raises.  Its `launches`
counts the launches, `plain_calls` the calls that took the plain version
instead (a CPU tensor here; in `stepper._uv_rhs` the budget's split and
every configuration `usable` refuses), and `last_bytes` holds the
compulsory bytes of the last launch.
`launch_plan` picks the kernel's tile (rows of TILE_I columns, two threads
a column): each thread keeps the spline's cf and fc of its column's nz
levels in shared memory, so nz is capped at NZ_MAX.  `occupancy` reports a
launch configuration on the card.  The plain version is the port's
composition of `advection` functions (the JAX package's
roms_tpu/stepper.py:_uv_rhs; reference: compute_horiz_rhs_uv_terms.h +
compute_vert_rhs_uv_terms.h).
"""

from __future__ import annotations

import ctypes

import torch

from roms_tpu_torch.config import AdvScheme, ModelConfig
from roms_tpu_torch.ops import _build
from roms_tpu_torch.ops import advection as adv

TILE_I = 32                  # columns of a tile along i (one warp a half)
NZ_MAX = 192                 # deepest column the kernel takes
SMEM_BLOCK = 232_448         # dynamic shared memory of one block, sm_90
SMEM_SM = 233_472            # shared memory of one SM (228 KB) ...
SMEM_RESERVED = 1_024        # ... of which each resident block reserves 1 KB
# threads an SM can hold at the kernel's register cap (float 144 a thread,
# double 255), which is also a block's largest size
THREADS_SM = {4: 448, 8: 256}


def smem_bytes(tj: int, nz: int, elem: int) -> int:
    """Shared memory of one block of `tj` tile rows (csrc/uv_rhs.cu:
    smem_bytes): cf and fc of nz levels for each of its 2 * TILE_I * tj
    threads."""
    return 2 * nz * 2 * TILE_I * tj * elem


def check_nz(nz: int):
    """Raise ValueError outside the kernel's 2 <= nz <= NZ_MAX."""
    if not 2 <= nz <= NZ_MAX:
        raise ValueError(f"uv_rhs: the kernel takes 2 <= nz <= {NZ_MAX}, "
                         f"got nz={nz}")


def launch_plan(elem: int, nz: int) -> tuple[int, int]:
    """(tile rows, shared-memory bytes) of a launch: the tile that keeps
    the most threads resident on an SM (limited by shared memory and by
    the register cap), the tallest among those (its halo rows are read
    by fewer blocks).  Raises ValueError outside 2 <= nz <= NZ_MAX."""
    check_nz(nz)
    best = None
    for tj in range(1, THREADS_SM[elem] // (2 * TILE_I) + 1):
        b = smem_bytes(tj, nz, elem)
        if b > SMEM_BLOCK:
            break
        blocks = min(SMEM_SM // (b + SMEM_RESERVED),
                     THREADS_SM[elem] // (2 * TILE_I * tj))
        key = (blocks * tj, tj)
        if best is None or key > best[0]:
            best = (key, tj, b)
    return best[1], best[2]


def usable(cfg: ModelConfig) -> bool:
    """Whether the kernel covers this configuration's momentum r.h.s.: a
    column it can hold, and a grid without the mesh's divisibility pad
    (the step's budget path, `parts`, keeps the plain version)."""
    return 2 <= cfg.nz <= NZ_MAX and cfg.pad_e == 0 and cfg.pad_n == 0


def _owned(f) -> int:
    """An edge-ownership flag as the kernel takes it: None (a single
    block) owns the edge."""
    return 1 if f is None else int(bool(f))


def uv_rhs(u, v, flx_u, flx_v, hz, we, grid, cfg: ModelConfig,
           scheme: AdvScheme):
    """(ru, rv), each (nz, jy, ix): the Coriolis, horizontal and vertical
    momentum advection r.h.s. of `uv_rhs_plain` (same arguments, without
    `parts`)."""
    if u.device.type == "cpu":
        uv_rhs.plain_calls += 1
        return uv_rhs_plain(u, v, flx_u, flx_v, hz, we, grid, cfg, scheme)
    if u.device.type != "cuda":
        raise ValueError(f"uv_rhs: no kernel for {u.device}")
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
    lib = _build.library()
    fn = (lib.roms_uv_rhs_f64 if u.dtype == torch.float64
          else lib.roms_uv_rhs_f32)
    p = _build.ptr
    err = fn(p(u), p(v), p(flx_u), p(flx_v), p(hz), p(we), p(grid.fomn),
             p(grid.dndx) if curv else None, p(grid.dmde) if curv else None,
             p(grid.umask), p(grid.vmask), p(ru), p(rv),
             nz, jy, ix, int(scheme is AdvScheme.UPSTREAM3), int(cor),
             int(curv), int(cfg.uv_adv), int(cfg.masking),
             int(cfg.ew_periodic), int(cfg.ns_periodic), _owned(grid.own_w),
             _owned(grid.own_e), _owned(grid.own_s), _owned(grid.own_n), tj,
             smem, _build.stream(u))
    _build.check(err, "uv_rhs")
    uv_rhs.launches += 1
    reads = (u, v, flx_u, flx_v, hz, we, grid.fomn) + (
        (grid.dndx, grid.dmde) if curv else ()) + (
        (grid.umask, grid.vmask) if cfg.masking and cfg.uv_adv else ())
    uv_rhs.last_bytes = _build.compulsory_bytes(reads, (ru, rv))
    return ru, rv


uv_rhs.launches = 0
uv_rhs.plain_calls = 0
uv_rhs.last_bytes = 0


def occupancy(dtype: torch.dtype, nz: int, scheme: AdvScheme) -> dict:
    """The kernel's launch configuration for (dtype, nz, scheme) on the
    current card: tile rows, threads and shared memory per block,
    resident blocks and warps per SM
    (`cudaOccupancyMaxActiveBlocksPerMultiprocessor`), registers and
    stack bytes per thread."""
    elem = torch.empty((), dtype=dtype).element_size()
    tj, smem = launch_plan(elem, nz)
    out = (ctypes.c_int * 5)()
    _build.check(_build.library().roms_uv_rhs_occupancy(
        int(dtype == torch.float64), int(scheme is AdvScheme.UPSTREAM3), tj,
        nz, smem, out), "uv_rhs occupancy")
    return {"tile_rows": tj, **_build.occupancy_dict(out)}


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
