"""Implicit vertical momentum solve, plain PyTorch (a frozen copy of
`momentum_implicit_plain` from roms_tpu_torch/ops/cuda_solve.py;
reference: pre_step3d4S.F:377-424 / step3d_uv1.F:146-206)."""

from __future__ import annotations

import torch

from bench_h100.reference.config import ModelConfig


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
