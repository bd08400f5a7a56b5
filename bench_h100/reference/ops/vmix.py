"""Implicit vertical tracer solve and bottom drag (port of
roms_tpu/ops/vmix.py; reference: src/pre_step3d4S.F:216-263,
src/step3d_t_ISO.F:1007-1100, src/compute_rd_bott_drag.h).

The Thomas recurrences are Python loops over the (small) vertical
dimension carrying whole horizontal planes.  The momentum solve's plain
version lives beside its kernel, in `ops/cuda_solve.py`.

Index conventions (0-based): cells c = 0..nz-1, W-interfaces m = 0..nz;
fcv/wcv entry j stands for interface j+1.
"""

from __future__ import annotations

import torch

from bench_h100.reference.config import ModelConfig
from bench_h100.reference.parallel.halo import shift


def bottom_drag(u, v, hz, cfg: ModelConfig):
    """Dynamic bottom drag coefficient rd at rho points
    (reference: src/compute_rd_bott_drag.h:1-64, log-layer law)."""
    ub = u[0]
    vb = v[0]
    if cfg.zob > 0.0:
        cff = torch.sqrt((1.0 / 3.0) * (
            ub ** 2 + shift(ub, 0, 1) ** 2 + ub * shift(ub, 0, 1)
            + vb ** 2 + shift(vb, 1, 0) ** 2 + vb * shift(vb, 1, 0)))
        return cff * (cfg.von_karman
                      / torch.log(1.0 + 0.5 * hz[0] / cfg.zob)) ** 2
    rd = torch.full_like(ub, cfg.rdrg)
    return torch.minimum(rd, 0.8 * hz[0] / cfg.dt)


def tracer_implicit(t_rhs, hz_col, akt, wi, pmn, dtau, rmask,
                    cfg: ModelConfig, apply_mask: bool):
    """Implicit vertical diffusion + implicit vertical advection.
    t_rhs: (..., nz, jy, ix) Hz-weighted content; akt: (..., nz+1, jy, ix);
    hz_col (nz, ..), wi (nz+1, ..).  Returns the new concentration
    (reference: pre_step3d4S.F:216-263 / step3d_t_ISO.F:1044-1100)."""
    nz = t_rhs.shape[-3]
    dc0 = dtau * pmn
    fcv = 2.0 * dtau * akt[..., 1:nz, :, :] / (hz_col[1:] + hz_col[:-1])
    wcv = dc0[None] * wi[1:nz]
    wc_p = torch.clamp(wcv, min=0.0)
    wc_m = torch.clamp(wcv, max=0.0)

    def lev(a, k):
        return a[..., k, :, :]

    # forward (bottom-up) elimination over cells c = 0..nz-2
    cf, dc = [], []
    for c in range(nz - 1):
        if c > 0:
            up = lev(fcv, c - 1) + wc_p[c - 1]
            below = lev(fcv, c - 1) - wc_m[c - 1] - cf[c - 1] * up
            extra = dc[c - 1] * up
        else:
            below = extra = 0.0
        cff = 1.0 / (hz_col[c] + lev(fcv, c) + wc_p[c] + below)
        cf.append(cff * (lev(fcv, c) - wc_m[c]))
        dc.append(cff * (lev(t_rhs, c) + extra))

    mask = rmask if (apply_mask and cfg.masking) else None
    up = lev(fcv, nz - 2) + wc_p[nz - 2]
    t_top = ((lev(t_rhs, nz - 1) + dc[nz - 2] * up)
             / (hz_col[nz - 1] + lev(fcv, nz - 2) - wc_m[nz - 2]
                - cf[nz - 2] * up))
    if mask is not None:
        t_top = t_top * mask
    out = [None] * nz
    out[nz - 1] = t_top
    for c in range(nz - 2, -1, -1):
        t_c = dc[c] + cf[c] * out[c + 1]
        if mask is not None:
            t_c = t_c * mask
        out[c] = t_c
    return torch.stack(out, dim=-3)


def tracer_implicit_all(t_rhs, hz_col, akt_b, wi, pmn, dtau, rmask,
                        cfg: ModelConfig, apply_mask: bool):
    """`tracer_implicit` over the leading tracer axis: t_rhs (nt, nz, ..),
    akt_b (nt, nz+1, ..) per-tracer diffusivity."""
    if t_rhs.dim() != 4 or akt_b.shape[0] != t_rhs.shape[0]:
        raise ValueError("tracer_implicit_all: t_rhs (nt, nz, jy, ix) and "
                         "akt_b (nt, nz+1, jy, ix) expected")
    return tracer_implicit(t_rhs, hz_col, akt_b, wi, pmn, dtau, rmask, cfg,
                           apply_mask)


def gather_akt(akt, cfg: ModelConfig, tracers: slice = slice(None)):
    """Per-tracer diffusivity table (nt, nz+1, ..) of the tracers in
    `tracers` (all by default): tracer i uses akt[min(i, iTandS-1)]
    (reference: src/tracers.F iTandS clamp)."""
    idx = torch.tensor([min(i, cfg.i_t_and_s - 1)
                        for i in range(cfg.nt)[tracers]],
                       dtype=torch.long, device=akt.device)
    return akt[idx]
