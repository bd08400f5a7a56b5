"""One tracer stage for all tracers: the CUDA kernel and its plain
PyTorch version (counterpart of roms_tpu/ops/pallas_tracer.py).

    t_new = IMPLICIT( hz_pre*(c_tk*tk + c_sec*t_sec)
                      - dtau*pmn*div_h(FX, FE)
                      - dtau*pmn*div_v(spline_iface * We)
                      [+ dtau*stflx at the surface] )  [+ t3dmix tendency]

`tracer_stage` launches `csrc/tracer_stage.cu` for a CUDA tensor and calls
`tracer_stage_plain` for a CPU tensor; any other device raises.  Its
`launches` counts the launches and `last_bytes` holds the compulsory
bytes of the last one.  `launch_plan` picks the kernel's tile (rows of
TILE_I columns, two threads a column) for a (type, nz): the block keeps
two per-level arrays of its columns in shared memory, so nz is capped at
NZ_MAX.  `occupancy` reports a launch configuration on the card.  The
plain version composes the port's `advection` and `vmix` functions, as
tests/test_pallas_tracer.py composes the JAX ones, plus the fused t3dmix
tendency of the TPU kernel.
"""

from __future__ import annotations

import ctypes
import types

import torch

from roms_tpu_torch.config import AdvScheme, ModelConfig
from roms_tpu_torch.ops import _build
from roms_tpu_torch.ops import advection as adv
from roms_tpu_torch.ops import vmix
from roms_tpu_torch.parallel.halo import shift

_SCHEME_ID = {AdvScheme.CENTERED4: 0, AdvScheme.UPSTREAM3: 1,
              AdvScheme.AKIMA: 2}

TILE_I = 32                  # columns of a tile along i (one warp)
TILE_J = (4, 2, 1)           # tile rows the kernel takes, largest first
NZ_MAX = 192                 # deepest column the kernel takes
RING = 3                     # ring slots of the level tiles (NB in the .cu)
SMEM_BLOCK = 232_448         # dynamic shared memory of one block, sm_90
SMEM_SM = 233_472            # shared memory of one SM (228 KB) ...
SMEM_RESERVED = 1_024        # ... of which each resident block reserves 1 KB
THREADS_SM = 768             # the kernel's register cap leaves 768 an SM


def smem_bytes(tj: int, nz: int, elem: int, mix: bool) -> int:
    """Shared memory of one block of `tj` tile rows (the layout of
    csrc/tracer_stage.cu:layout): the face fluxes (twice with mix); two
    buffers of one level's r.h.s.; RING slots of one level's tiles: tk,
    (tj+6) x (TILE_I+6) with the three-cell halo, and with mix tj+2 rows
    of Hz(n+1); the two per-level arrays CF and FC, nz levels of tj*TILE_I
    columns."""
    wt = (tj + 6) * (TILE_I + 6)
    ncol = tj * TILE_I
    faces = tj * (TILE_I + 1) + (tj + 1) * TILE_I
    m = int(mix)
    slot = wt + m * (tj + 2) * (TILE_I + 6)
    return ((1 + m) * faces + 2 * ncol + RING * slot + 2 * nz * ncol) * elem


def launch_plan(elem: int, nz: int, mix: bool) -> tuple[int, int]:
    """(tile rows, shared-memory bytes) of a launch: the tile that keeps
    the most columns resident on an SM (blocks of 2 * 32 * rows threads,
    limited by shared memory and by the threads the register cap allows);
    among those, one that leaves at least two blocks per SM (one block's
    barriers then do not idle the SM), and then the tallest (its halo
    costs least).  Raises ValueError outside 2 <= nz <= NZ_MAX."""
    if not 2 <= nz <= NZ_MAX:
        raise ValueError(f"tracer_stage: the kernel takes 2 <= nz <= "
                         f"{NZ_MAX}, got nz={nz}")
    best = None
    for tj in TILE_J:
        b = smem_bytes(tj, nz, elem, mix)
        if b > SMEM_BLOCK:
            continue
        blocks = min(SMEM_SM // (b + SMEM_RESERVED),
                     THREADS_SM // (2 * tj * TILE_I))
        key = (blocks * tj, min(blocks, 2), tj)
        if best is None or key > best[0]:
            best = (key, tj, b)
    return best[1], best[2]


def usable(cfg: ModelConfig) -> bool:
    """Whether the fused stage covers this configuration's tracer stage
    (as roms_tpu/ops/pallas_tracer.py:usable)."""
    return (not cfg.river_source
            and not cfg.adv_isoneutral and not cfg.upscale_output
            and not cfg.tracer_diagnostics
            and cfg.pad_e == 0 and cfg.pad_n == 0)


def _hz_roles(mode: str, hz_a, hz_b):
    """(hz_pre, hz_spl, hz_imp): pred takes hz_a=Hz(n), hz_b=flx_div
    (Hz_bak, Hz(n), Hz_fwd); corr takes hz_a=Hz(n), hz_b=Hz(n+1)."""
    if mode == "pred":
        return hz_a + hz_b, hz_a, hz_a - hz_b
    if mode == "corr":
        return hz_a, hz_b, hz_b
    raise ValueError(f"mode must be 'pred' or 'corr', got {mode!r}")


def _own_flag(f):
    """Ownership flag for the plain path: None/True = owned."""
    if f is None or isinstance(f, torch.Tensor):
        return f
    return bool(f)


def tracer_stage(tk, t_sec, flx_u, flx_v, hz_a, hz_b, we, wi, akt,
                 pmn, rmask, umask, vmask, cfg: ModelConfig,
                 scheme: AdvScheme, dtau: float, c_tk: float, c_sec: float,
                 apply_mask: bool, mode: str, stflx=None, mix=None,
                 own=None):
    """Fused tracer stage over all tracers -> t_new (nt, nz, jy, ix).

    mode='pred': hz_a=Hz(n), hz_b=flx_div; mode='corr': hz_a=Hz(n),
    hz_b=Hz(n+1).  akt: the raw mixing table (n_akt, nz+1, jy, ix);
    tracer i uses row min(i, i_t_and_s-1).  mix (corr only): dict with
    diff2 (nt, jy, ix), pmon_u, pnom_v (jy, ix); adds the t3dmix tendency
    built from tk.  own: (own_w, own_e, own_s, own_n) edge ownership, None
    = single block, which owns every edge."""
    if mix is not None and mode != "corr":
        raise ValueError("tracer_stage: mix is a corrector-stage option")
    if tk.device.type == "cpu":
        return tracer_stage_plain(tk, t_sec, flx_u, flx_v, hz_a, hz_b, we,
                                  wi, akt, pmn, rmask, umask, vmask, cfg,
                                  scheme, dtau, c_tk, c_sec, apply_mask,
                                  mode, stflx=stflx, mix=mix, own=own)
    nt, nz, jy, ix = tk.shape
    tj, smem = launch_plan(tk.element_size(), nz, mix is not None)
    if tk.device.type != "cuda":
        raise ValueError(f"tracer_stage: no kernel for {tk.device}")
    if mode not in ("pred", "corr"):
        raise ValueError(f"mode must be 'pred' or 'corr', got {mode!r}")
    imix = max(cfg.i_t_and_s, 1)
    if jy < 4 or ix < 4:
        raise ValueError("tracer_stage: jy, ix >= 4 required")
    if (nz + 1) * jy * ix >= 2**31:
        raise ValueError("tracer_stage: (nz + 1) * jy * ix must be < 2**31 "
                         "(the kernel's offsets within a field are ints)")
    if akt.dim() != 4 or akt.shape[0] < imix:
        raise ValueError(f"tracer_stage: akt needs >= {imix} rows")
    shapes = {"tk": (tk, (nt, nz, jy, ix)), "t_sec": (t_sec, (nt, nz, jy, ix)),
              "flx_u": (flx_u, (nz, jy, ix)), "flx_v": (flx_v, (nz, jy, ix)),
              "hz_a": (hz_a, (nz, jy, ix)), "hz_b": (hz_b, (nz, jy, ix)),
              "we": (we, (nz + 1, jy, ix)), "wi": (wi, (nz + 1, jy, ix)),
              "akt": (akt, (akt.shape[0], nz + 1, jy, ix)),
              "pmn": (pmn, (jy, ix)), "rmask": (rmask, (jy, ix)),
              "umask": (umask, (jy, ix)), "vmask": (vmask, (jy, ix))}
    if stflx is not None:
        shapes["stflx"] = (stflx, (nt, jy, ix))
    if mix is not None:
        shapes["diff2"] = (mix["diff2"], (nt, jy, ix))
        shapes["pmon_u"] = (mix["pmon_u"], (jy, ix))
        shapes["pnom_v"] = (mix["pnom_v"], (jy, ix))
    _build.check_inputs(shapes, tk)
    own_i = [1 if f is None else int(bool(f)) for f in
             (own if own is not None else (None,) * 4)]

    out = torch.empty_like(tk)
    lib = _build.library()
    fn = (lib.roms_tracer_stage_f64 if tk.dtype == torch.float64
          else lib.roms_tracer_stage_f32)
    p = _build.ptr
    mx = mix if mix is not None else {}
    err = fn(p(tk), p(t_sec), p(flx_u), p(flx_v), p(hz_a), p(hz_b), p(we),
             p(wi), p(akt), p(pmn), p(rmask), p(umask), p(vmask), p(stflx),
             p(mx.get("diff2")), p(mx.get("pmon_u")), p(mx.get("pnom_v")),
             p(out),
             nt, nz, jy, ix, imix, _SCHEME_ID[scheme], int(mode == "corr"),
             int(cfg.masking), int(cfg.ew_periodic), int(cfg.ns_periodic),
             *own_i, int(apply_mask), tj, smem,
             float(dtau), float(c_tk), float(c_sec),
             torch.cuda.current_stream(tk.device).cuda_stream)
    _build.check(err, "tracer_stage")
    tracer_stage.launches += 1
    tracer_stage.last_bytes = _build.compulsory_bytes(
        (tk, t_sec, flx_u, flx_v, hz_a, hz_b, we, wi, akt[:imix], pmn, rmask,
         umask, vmask, stflx, *mx.values()), (out,))
    return out


tracer_stage.launches = 0
tracer_stage.last_bytes = 0


def occupancy(dtype: torch.dtype, nz: int, scheme: AdvScheme,
              mix: bool) -> dict:
    """The kernel's launch configuration for (dtype, nz, scheme, mix) on
    the current card: tile rows, threads and shared memory per block,
    resident blocks and warps per SM
    (`cudaOccupancyMaxActiveBlocksPerMultiprocessor`), registers and
    stack bytes per thread."""
    elem = torch.empty((), dtype=dtype).element_size()
    tj, smem = launch_plan(elem, nz, mix)
    out = (ctypes.c_int * 3)()
    _build.check(_build.library().roms_tracer_stage_occupancy(
        int(dtype == torch.float64), _SCHEME_ID[scheme], int(mix), tj, nz,
        smem, out), "tracer_stage occupancy")
    return {"tile_rows": tj, "threads": 2 * tj * TILE_I, "smem": smem,
            "blocks_per_sm": out[0], "warps_per_sm": out[0] * 2 * tj,
            "registers": out[1], "stack": out[2]}


def tracer_stage_plain(tk, t_sec, flx_u, flx_v, hz_a, hz_b, we, wi, akt,
                       pmn, rmask, umask, vmask, cfg: ModelConfig,
                       scheme: AdvScheme, dtau: float, c_tk: float,
                       c_sec: float, apply_mask: bool, mode: str,
                       stflx=None, mix=None, own=None):
    """Plain PyTorch version of `tracer_stage` (same arguments)."""
    hz_pre, hz_spl, hz_imp = _hz_roles(mode, hz_a, hz_b)
    own = own if own is not None else (None,) * 4
    grid = types.SimpleNamespace(
        umask=umask, vmask=vmask, own_w=_own_flag(own[0]),
        own_e=_own_flag(own[1]), own_s=_own_flag(own[2]),
        own_n=_own_flag(own[3]))
    fx, fe = adv.horiz_tracer_flux(tk, flx_u, flx_v, grid, cfg, scheme)
    div = pmn[None] * (shift(fx, 0, 1) - fx + shift(fe, 1, 0) - fe)
    rhs = hz_pre * (c_tk * tk + c_sec * t_sec) - dtau * div
    fc = adv.vert_tracer_flux_spline(tk, hz_spl, we)
    rhs = rhs - dtau * pmn[None] * (fc[:, 1:] - fc[:, :-1])
    if stflx is not None:
        rhs[:, -1] = rhs[:, -1] + dtau * stflx
    t_new = vmix.tracer_implicit_all(rhs, hz_imp, vmix.gather_akt(akt, cfg),
                                     wi, pmn, dtau, rmask, cfg,
                                     apply_mask=apply_mask)
    if mix is not None:
        t_new = t_new + _t3dmix_tendency(tk, hz_b, mix, umask, vmask, pmn,
                                         dtau, cfg)
    return t_new


def _t3dmix_tendency(tk, hz_new, mix, umask, vmask, pmn, dtau,
                     cfg: ModelConfig):
    """Laplacian diffusion along sigma surfaces from the tk window,
    divided by Hz(n+1) (reference: t3dmix_S.F:45-99; the TPU kernel's
    fused form, pallas_tracer.py:265-297)."""
    d2 = mix["diff2"][:, None]                       # (nt, 1, jy, ix)
    fx = (0.25 * (d2 + shift(d2, 0, -1)) * mix["pmon_u"]
          * (hz_new + shift(hz_new, 0, -1)) * (tk - shift(tk, 0, -1)))
    fe = (0.25 * (d2 + shift(d2, -1, 0)) * mix["pnom_v"]
          * (hz_new + shift(hz_new, -1, 0)) * (tk - shift(tk, -1, 0)))
    if cfg.masking:
        fx = fx * umask
        fe = fe * vmask
    div = shift(fx, 0, 1) - fx + shift(fe, 1, 0) - fe
    return dtau * pmn * div / hz_new
