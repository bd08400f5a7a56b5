"""The fused tracer stage over the tracers or a block of them, plain
PyTorch (a frozen copy of `tracer_stage_plain` and its helpers from
roms_tpu_torch/ops/cuda_tracer.py).

    t_new = IMPLICIT( hz_pre*(c_tk*tk + c_sec*t_sec)
                      - dtau*pmn*div_h(FX, FE)
                      - dtau*pmn*div_v(spline_iface * We)
                      [+ dtau*stflx at the surface] )  [+ t3dmix tendency]
"""

from __future__ import annotations

import types

import torch

from bench_h100.reference.config import AdvScheme, ModelConfig
from bench_h100.reference.ops import advection as adv
from bench_h100.reference.ops import vmix
from bench_h100.reference.parallel.halo import shift


def usable(cfg: ModelConfig) -> bool:
    """Whether the fused stage covers this configuration's tracer stage;
    the others take the batched tracer branch of `stepper.step_impl`."""
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


def tracer_stage_plain(tk, t_sec, flx_u, flx_v, hz_a, hz_b, we, wi, akt,
                       pmn, rmask, umask, vmask, cfg: ModelConfig,
                       scheme: AdvScheme, dtau: float, c_tk: float,
                       c_sec: float, apply_mask: bool, mode: str,
                       stflx=None, mix=None, own=None,
                       tracers: slice = slice(None)):
    """One tracer stage -> t_new (nt, nz, jy, ix).

    mode='pred': hz_a=Hz(n), hz_b=flx_div; mode='corr': hz_a=Hz(n),
    hz_b=Hz(n+1).  akt: the raw mixing table (n_akt, nz+1, jy, ix);
    tracer i uses row min(i, i_t_and_s-1).  mix (corr only): dict with
    diff2 (nt, jy, ix), pmon_u, pnom_v (jy, ix); adds the t3dmix tendency
    built from tk.  own: (own_w, own_e, own_s, own_n) edge ownership, None
    = single block, which owns every edge.  tracers: which of the
    configuration's tracers tk, t_sec, stflx and diff2 hold (all by
    default); it picks their rows of akt."""
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
    t_new = vmix.tracer_implicit_all(rhs, hz_imp,
                                     vmix.gather_akt(akt, cfg, tracers),
                                     wi, pmn, dtau, rmask, cfg,
                                     apply_mask=apply_mask)
    if mix is not None:
        t_new = t_new + _t3dmix_tendency(tk, hz_b, mix, umask, vmask, pmn,
                                         dtau, cfg)
    return t_new


def _t3dmix_tendency(tk, hz_new, mix, umask, vmask, pmn, dtau,
                     cfg: ModelConfig):
    """Laplacian diffusion along sigma surfaces from the tk window,
    divided by Hz(n+1) (reference: t3dmix_S.F:45-99)."""
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
