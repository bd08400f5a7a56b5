"""Grid-box face fluxes and S-coordinate vertical velocity (port of
roms_tpu/ops/kinematics.py; reference: src/set_depth.F:190-422,
src/omega.F).

The bottom-up vertical integral in `omega` is a `torch.cumsum`
(sequential), where the JAX package uses `lax.associative_scan` (tree
order): the two agree to round-off, not bitwise.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from bench_h100.reference.config import ModelConfig
from bench_h100.reference.parallel.halo import band, eset, shift


def hz_u(hz):
    """0.5*(Hz(i,j)+Hz(i-1,j)) at u-points."""
    return 0.5 * (hz + shift(hz, 0, -1))


def hz_v(hz):
    return 0.5 * (hz + shift(hz, -1, 0))


def set_huv(u, v, hz, grid):
    """FlxU = Hz_u*dy_u*u, FlxV = Hz_v*dx_v*v (reference: set_depth.F:214-230)."""
    flx_u = hz_u(hz) * grid.dn_u[None] * u
    flx_v = hz_v(hz) * grid.dm_v[None] * v
    return flx_u, flx_v


class Huv1Out(NamedTuple):
    u: torch.Tensor
    v: torch.Tensor
    flx_u: torch.Tensor
    flx_v: torch.Tensor


def set_huv1(u, v, hz, du_avg1, dv_avg1, du_avg2, dv_avg2,
             du_avg_bak, dv_avg_bak, grid, cfg: ModelConfig,
             first_step: bool) -> Huv1Out:
    """Remove the barotropic mismatch from the predictor velocities and
    recompute face fluxes (reference: src/set_depth.F:252-422, set_HUV1)."""
    dcu = hz_u(hz) * grid.dn_u[None]
    dcv = hz_v(hz) * grid.dm_v[None]
    du_col = torch.sum(dcu, dim=0)
    dv_col = torch.sum(dcv, dim=0)
    fu_col = torch.sum(dcu * u, dim=0)
    fv_col = torch.sum(dcv * v, dim=0)

    if first_step:
        mis_u = (fu_col - du_avg1) / du_col
        mis_v = (fv_col - dv_avg1) / dv_col
    else:
        now, mid, bak = cfg.extrap_now, cfg.extrap_mid, cfg.extrap_bak
        mis_u = (fu_col - now * du_avg1 + mid * du_avg2 - bak * du_avg_bak) / du_col
        mis_v = (fv_col - now * dv_avg1 + mid * dv_avg2 - bak * dv_avg_bak) / dv_col

    u_new = u - mis_u[None]
    v_new = v - mis_v[None]
    if cfg.masking:
        u_new = u_new * grid.umask[None]
        v_new = v_new * grid.vmask[None]
    return Huv1Out(u=u_new, v=v_new, flx_u=dcu * u_new, flx_v=dcv * v_new)


class OmegaOut(NamedTuple):
    we: torch.Tensor   # explicit vertical flux (nz+1, ..)
    wi: torch.Tensor   # implicit remainder   (nz+1, ..)


# split thresholds (reference: omega.F:60-62)
CU_MIN, CU_MAX = 0.6, 1.0
_CMNX = CU_MIN / CU_MAX
_CUTOFF = 2.0 - _CMNX
_R4CMX = 0.25 / (1.0 - _CMNX)


def pipe_profile_3d(forcing, nz: int):
    """Per-cell vertical source distribution pipe_flx * pipe_prf[pipe_idx]
    (nz, jy, ix) (reference: omega.F:102-108, step3d_t_ISO.F:927-934)."""
    npip = forcing.pipe_prf.shape[0]
    idx = forcing.pipe_idx.long().clamp(0, npip - 1)
    cell_prf = forcing.pipe_prf[idx].movedim(-1, 0)   # (nz, jy, ix)
    return cell_prf * forcing.pipe_flx[None]


def omega(flx_u, flx_v, z_w, hz, swflx, grid, dtau: float,
          cfg: ModelConfig = None, forcing=None) -> OmegaOut:
    """S-coordinate vertical velocity [m^3/s] with the adaptive
    explicit/implicit split by vertical Courant number
    (reference: src/omega.F:17-169)."""
    nz = hz.shape[0]
    div = (shift(flx_u, 0, 1) - flx_u + shift(flx_v, 1, 0) - flx_v)
    incr = -div
    if cfg is not None and cfg.pipe_source:
        incr = incr + pipe_profile_3d(forcing, nz)
    wi_body = torch.cumsum(incr, dim=0)
    cx = (torch.clamp(shift(flx_u, 0, 1), min=0.0)
          - torch.clamp(flx_u, max=0.0)
          + torch.clamp(shift(flx_v, 1, 0), min=0.0)
          - torch.clamp(flx_v, max=0.0))

    wi_top = wi_body[nz - 1] + swflx * grid.dm_r * grid.dn_r  # rain water
    wrk = wi_top / (z_w[nz] - z_w[0])
    # remove grid "breathing" (reference: omega.F:125-127)
    wi_mid = wi_body[:nz - 1] - wrk[None] * (z_w[1:nz] - z_w[0][None])

    cx0 = dtau * grid.pm * grid.pn
    c2d = torch.maximum(cx[:nz - 1], cx[1:])
    dh = torch.minimum(hz[:nz - 1], hz[1:])
    cw_max = CU_MAX * dh - c2d * cx0[None]
    cw_max2 = cw_max * cw_max
    cw_min = cw_max * _CMNX
    cw = torch.abs(wi_mid) * cx0[None]
    cff = torch.where(cw < cw_min, cw_max2,
                      torch.where(cw < _CUTOFF * cw_max,
                                  cw_max2 + _R4CMX * (cw - cw_min) ** 2,
                                  cw_max * cw))
    pos = cw_max > 0.0
    we_mid = torch.where(pos, cw_max2 * wi_mid / cff, 0.0)
    wi_mid = torch.where(pos, wi_mid - we_mid, wi_mid)

    zero = torch.zeros_like(wrk)[None]
    we = torch.cat([zero, we_mid, zero], dim=0)
    wi = torch.cat([zero, wi_mid, zero], dim=0)

    # physical-edge ghost copies incl. corners (reference: omega.F:171-231)
    if cfg is not None and not cfg.fully_periodic:
        pe, pn = cfg.pad_e, cfg.pad_n

        def edge_copy(a):
            if not cfg.ew_periodic:
                a = eset(a, (Ellipsis, slice(None), 1), a[..., :, 2],
                         grid.own_w)
                a = eset(a, (Ellipsis, slice(None), -2 - pe),
                         a[..., :, -3 - pe], grid.own_e)
            if not cfg.ns_periodic:
                a = eset(a, (Ellipsis, 1, slice(None)), a[..., 2, :],
                         grid.own_s)
                a = eset(a, (Ellipsis, -2 - pn, slice(None)),
                         a[..., -3 - pn, :], grid.own_n)
            if not cfg.ew_periodic and not cfg.ns_periodic:
                a = eset(a, (Ellipsis, 1, 1), a[..., 2, 2],
                         band(grid.own_s, grid.own_w))
                a = eset(a, (Ellipsis, 1, -2 - pe), a[..., 2, -3 - pe],
                         band(grid.own_s, grid.own_e))
                a = eset(a, (Ellipsis, -2 - pn, 1), a[..., -3 - pn, 2],
                         band(grid.own_n, grid.own_w))
                a = eset(a, (Ellipsis, -2 - pn, -2 - pe),
                         a[..., -3 - pn, -3 - pe],
                         band(grid.own_n, grid.own_e))
            return a

        we = edge_copy(we)
        wi = edge_copy(wi)
    return OmegaOut(we=we, wi=wi)
