"""One tracer stage for all tracers: the CUDA kernel and its plain
PyTorch version (counterpart of roms_tpu/ops/pallas_tracer.py).

    t_new = IMPLICIT( hz_pre*(c_tk*tk + c_sec*t_sec)
                      - dtau*pmn*div_h(FX, FE)
                      - dtau*pmn*div_v(spline_iface * We)
                      [+ dtau*stflx at the surface] )  [+ t3dmix tendency]

`tracer_stage` launches `csrc/tracer_stage.cu` for a CUDA tensor and calls
`tracer_stage_plain` for a CPU tensor; any other device raises.  Its
`launches` counts the launches and `last_bytes` holds the compulsory
bytes of the last one.  The
plain version composes the port's `advection` and `vmix` functions, as
tests/test_pallas_tracer.py composes the JAX ones, plus the fused t3dmix
tendency of the TPU kernel.
"""

from __future__ import annotations

import types

import torch

from roms_tpu_torch.config import AdvScheme, ModelConfig
from roms_tpu_torch.ops import _build
from roms_tpu_torch.ops import advection as adv
from roms_tpu_torch.ops import vmix
from roms_tpu_torch.parallel.halo import shift

_SCHEME_ID = {AdvScheme.CENTERED4: 0, AdvScheme.UPSTREAM3: 1,
              AdvScheme.AKIMA: 2}


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
    if tk.device.type != "cuda":
        raise ValueError(f"tracer_stage: no kernel for {tk.device}")
    if mode not in ("pred", "corr"):
        raise ValueError(f"mode must be 'pred' or 'corr', got {mode!r}")
    nt, nz, jy, ix = tk.shape
    imix = max(cfg.i_t_and_s, 1)
    if nz < 2 or jy < 4 or ix < 4:
        raise ValueError("tracer_stage: nz >= 2 and jy, ix >= 4 required")
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
    scratch = torch.empty((2,) + tuple(tk.shape), dtype=tk.dtype,
                          device=tk.device)
    lib = _build.library()
    fn = (lib.roms_tracer_stage_f64 if tk.dtype == torch.float64
          else lib.roms_tracer_stage_f32)
    p = _build.ptr
    mx = mix if mix is not None else {}
    err = fn(p(tk), p(t_sec), p(flx_u), p(flx_v), p(hz_a), p(hz_b), p(we),
             p(wi), p(akt), p(pmn), p(rmask), p(umask), p(vmask), p(stflx),
             p(mx.get("diff2")), p(mx.get("pmon_u")), p(mx.get("pnom_v")),
             p(out), p(scratch),
             nt, nz, jy, ix, imix, _SCHEME_ID[scheme], int(mode == "corr"),
             int(cfg.masking), int(cfg.ew_periodic), int(cfg.ns_periodic),
             *own_i, int(apply_mask),
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
