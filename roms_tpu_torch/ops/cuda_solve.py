"""Implicit vertical momentum solve: the CUDA kernel and its plain
PyTorch version (counterpart of roms_tpu/ops/pallas_solve.py).

`momentum_implicit` launches `csrc/momentum_solve.cu` for a CUDA tensor
and calls `momentum_implicit_plain` for a CPU tensor; any other device
raises.  Its `launches` counts the launches and `last_bytes` holds the
compulsory bytes of the last one.  The plain version mirrors roms_tpu/ops/vmix.py:momentum_implicit
(reference: pre_step3d4S.F:377-424 / step3d_uv1.F:146-206).
"""

from __future__ import annotations

import torch

from roms_tpu_torch.config import ModelConfig
from roms_tpu_torch.ops import _build


def momentum_implicit(rhs, hz_face, akv_face, wi_face, dc0, dtau, sstr,
                      cfg: ModelConfig, bottom_drag_coeff=None):
    """Implicit vertical viscosity + implicit vertical advection solve for
    one momentum component at its staggered points; returns the velocity
    (nz, jy, ix).  Inputs as in `momentum_implicit_plain`."""
    if rhs.device.type == "cpu":
        return momentum_implicit_plain(rhs, hz_face, akv_face, wi_face, dc0,
                                       dtau, sstr, cfg, bottom_drag_coeff)
    if rhs.device.type != "cuda":
        raise ValueError(f"momentum_implicit: no kernel for {rhs.device}")
    nz, jy, ix = rhs.shape
    if nz < 2:
        raise ValueError("momentum_implicit: nz >= 2 required")
    shapes = {"rhs": (rhs, (nz, jy, ix)), "hz_face": (hz_face, (nz, jy, ix)),
              "akv_face": (akv_face, (nz + 1, jy, ix)),
              "wi_face": (wi_face, (nz + 1, jy, ix)), "dc0": (dc0, (jy, ix)),
              "sstr": (sstr, (jy, ix))}
    if bottom_drag_coeff is not None:
        shapes["bottom_drag_coeff"] = (bottom_drag_coeff, (jy, ix))
    _build.check_inputs(shapes, rhs)
    out = torch.empty_like(rhs)
    cf = torch.empty_like(rhs)
    fn = (_build.library().roms_momentum_solve_f64
          if rhs.dtype == torch.float64
          else _build.library().roms_momentum_solve_f32)
    err = fn(_build.ptr(rhs), _build.ptr(hz_face), _build.ptr(akv_face),
             _build.ptr(wi_face), _build.ptr(dc0), _build.ptr(sstr),
             _build.ptr(bottom_drag_coeff), _build.ptr(out), _build.ptr(cf),
             nz, jy, ix, float(dtau),
             torch.cuda.current_stream(rhs.device).cuda_stream)
    _build.check(err, "momentum_solve")
    momentum_implicit.launches += 1
    momentum_implicit.last_bytes = _build.compulsory_bytes(
        (rhs, hz_face, akv_face, wi_face, dc0, sstr, bottom_drag_coeff),
        (out,))
    return out


momentum_implicit.launches = 0
momentum_implicit.last_bytes = 0


def momentum_implicit_plain(rhs, hz_face, akv_face, wi_face, dc0, dtau,
                            sstr, cfg: ModelConfig, bottom_drag_coeff=None):
    """Plain PyTorch version.

    rhs:      (nz, ..) Hz-weighted momentum content (incl. dc0*ru)
    hz_face:  (nz, ..) face-averaged grid-box heights
    akv_face: (nz+1, ..) face-averaged Akv at W-levels
    wi_face:  (nz+1, ..) face-averaged Wi
    dc0:      dtau*0.25*(pm+pm_m)*(pn+pn_m)
    sstr:     surface stress, added as dtau*sstr to the top-cell rhs
    bottom_drag_coeff: adds dtau*coeff to the bottom diagonal
                (IMPLCT_NO_SLIP_BTTM_BC, set_global_definitions.h:73)
    """
    nz = rhs.shape[0]
    fcv = 2.0 * dtau * akv_face[1:nz] / (hz_face[1:] + hz_face[:-1])
    wcv = dc0[None] * wi_face[1:nz]
    wc_p = torch.clamp(wcv, min=0.0)
    wc_m = torch.clamp(wcv, max=0.0)

    # top cell c = nz-1: CF at interface nz-1 and DC[nz-1]
    cff = 1.0 / (hz_face[nz - 1] + fcv[nz - 2] - wc_m[nz - 2])
    cf = [None] * nz
    dc = [None] * nz
    cf[nz - 1] = cff * (fcv[nz - 2] + wc_p[nz - 2])
    dc[nz - 1] = cff * (rhs[nz - 1] + dtau * sstr)

    # downward elimination, cells c = nz-2..1
    for c in range(nz - 2, 0, -1):
        cff = 1.0 / (hz_face[c]
                     + fcv[c - 1] - wc_m[c - 1]
                     + fcv[c] + wc_p[c]
                     - cf[c + 1] * (fcv[c] - wc_m[c]))
        cf[c] = cff * (fcv[c - 1] + wc_p[c - 1])
        dc[c] = cff * (rhs[c] + dc[c + 1] * (fcv[c] - wc_m[c]))

    denom = hz_face[0] + fcv[0] + wc_p[0] - cf[1] * (fcv[0] - wc_m[0])
    if bottom_drag_coeff is not None:
        denom = denom + dtau * bottom_drag_coeff
    out = [(rhs[0] + dc[1] * (fcv[0] - wc_m[0])) / denom]
    # upward back substitution
    for c in range(1, nz):
        out.append(dc[c] + cf[c] * out[c - 1])
    return torch.stack(out, dim=0)
