"""Implicit vertical momentum solve: the CUDA kernel and its plain
PyTorch version (counterpart of roms_tpu/ops/pallas_solve.py).

`momentum_implicit` launches `csrc/momentum_solve.cu` for a CUDA tensor,
on a mesh block's padded grid too, and calls `momentum_implicit_plain`
for a CPU tensor; any other device raises (`_build.dispatch`).  A block
of the kernel keeps CF and DC of its columns in shared memory, which the
launch sizes from nz, so nz is capped at NZ_MAX, and a deeper column
raises; `occupancy` reports the launch configuration on the card.  The
plain version mirrors roms_tpu/ops/vmix.py:momentum_implicit (reference:
pre_step3d4S.F:377-424 / step3d_uv1.F:146-206).
"""

from __future__ import annotations

import torch

from roms_tpu_torch.config import ModelConfig
from roms_tpu_torch.ops import _build

NZ_MAX = 192                 # deepest column the kernel takes


def launch_bytes(nz: int, jy: int, ix: int, elem: int, drag: bool) -> int:
    """Compulsory bytes of one launch: rhs and hz_face (nz levels),
    akv_face and wi_face (nz + 1), dc0, sstr and the drag, each read once;
    the solution written once."""
    return (3 * nz + 2 * (nz + 1) + 2 + int(drag)) * jy * ix * elem


def momentum_implicit(rhs, hz_face, akv_face, wi_face, dc0, dtau, sstr,
                      cfg: ModelConfig, bottom_drag_coeff=None):
    """Implicit vertical viscosity + implicit vertical advection solve for
    one momentum component at its staggered points; returns the velocity
    (nz, jy, ix).  Inputs as in `momentum_implicit_plain`."""
    return _build.dispatch(
        "momentum_solve", True, momentum_implicit_plain, _launch, rhs,
        hz_face, akv_face, wi_face, dc0, dtau, sstr, cfg, bottom_drag_coeff)


def _launch(rhs, hz_face, akv_face, wi_face, dc0, dtau, sstr,
            cfg: ModelConfig, bottom_drag_coeff=None):
    """The kernel's path of `momentum_implicit` (same arguments)."""
    nz, jy, ix = rhs.shape
    _build.check_nz("momentum_solve", nz, NZ_MAX)
    drag = bottom_drag_coeff is not None
    _build.check_groups(
        rhs, ((nz, jy, ix), "rhs hz_face", (rhs, hz_face)),
        ((nz + 1, jy, ix), "akv_face wi_face", (akv_face, wi_face)),
        ((jy, ix), "dc0 sstr bottom_drag_coeff",
         (dc0, sstr, bottom_drag_coeff) if drag else (dc0, sstr)))
    out = torch.empty_like(rhs)
    p = _build.ptr
    _build.launch("momentum_solve", rhs,
                  [p(rhs), p(hz_face), p(akv_face), p(wi_face), p(dc0),
                   p(sstr), p(bottom_drag_coeff), p(out)], [nz, jy, ix],
                  [float(dtau)])
    return out


def occupancy(dtype: torch.dtype, nz: int) -> dict:
    """The kernel's launch configuration for (dtype, nz) on the current
    card, as the library reports it: threads and shared memory per block,
    resident blocks and warps per SM
    (`cudaOccupancyMaxActiveBlocksPerMultiprocessor`), registers and stack
    bytes per thread."""
    _build.check_nz("momentum_solve", nz, NZ_MAX)
    return _build.occupancy("momentum_solve",
                            [int(dtype == torch.float64), nz])[0]


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
