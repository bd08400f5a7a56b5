"""Horizontal and vertical advection operators (port of
roms_tpu/ops/advection.py; reference: src/compute_horiz_tracer_fluxes.h,
src/compute_horiz_rhs_uv_terms.h, src/compute_vert_rhs_uv_terms.h,
src/compute_vert_tracer_fluxes.h).

The tracer operators take any number of leading batch dimensions before
(nz, jy, ix), so all tracers move through one call, as `jax.vmap` does in
the JAX package.
"""

from __future__ import annotations

import torch

from bench_h100.reference.config import AdvScheme, ModelConfig
from bench_h100.reference.parallel.halo import eset, shift

# literal constants copied from the reference sources
DELTA_UV = 0.1666666666666667     # (reference: pre_step3d4S.F:84)
GAMMA_UV = 0.3333333333333333     # (reference: pre_step3d4S.F:86)
C_UP3_TS = 0.1666666666666666     # (reference: compute_horiz_tracer_fluxes.h:106)
C_CEN4_TS = 0.3333333333333333    # (reference: compute_horiz_tracer_fluxes.h:110)
EPSIL = 1.0e-33


def _pos(a):
    return torch.clamp(a, min=0.0)


def _neg(a):
    return torch.clamp(a, max=0.0)


def horiz_tracer_flux(tk, flx_u, flx_v, grid, cfg: ModelConfig,
                      scheme: AdvScheme):
    """FX (u-points), FE (v-points) advective fluxes; tk (..., nz, jy, ix)."""
    # XI direction
    dx = tk - shift(tk, 0, -1)
    if cfg.masking:
        dx = dx * grid.umask[None]
    if not cfg.ew_periodic:
        # (reference: compute_horiz_tracer_fluxes.h:74-83)
        dx = eset(dx, (Ellipsis, slice(None), 1), dx[..., :, 2], grid.own_w)
        pe = cfg.pad_e
        dx = eset(dx, (Ellipsis, slice(None), -1 - pe), dx[..., :, -2 - pe],
                  grid.own_e)
    if scheme is AdvScheme.UPSTREAM3:
        curv = shift(dx, 0, 1) - dx
        fx = (0.5 * (tk + shift(tk, 0, -1)) * flx_u
              - C_UP3_TS * (shift(curv, 0, -1) * _pos(flx_u)
                            + curv * _neg(flx_u)))
    elif scheme is AdvScheme.AKIMA:
        cff = 2.0 * shift(dx, 0, 1) * dx
        grad = torch.where(cff > EPSIL, cff / (shift(dx, 0, 1) + dx), 0.0)
        fx = 0.5 * (tk + shift(tk, 0, -1)
                    - C_CEN4_TS * (grad - shift(grad, 0, -1))) * flx_u
    else:  # CENTERED4
        grad = 0.5 * (shift(dx, 0, 1) + dx)
        fx = 0.5 * (tk + shift(tk, 0, -1)
                    - C_CEN4_TS * (grad - shift(grad, 0, -1))) * flx_u
    # ETA direction
    de = tk - shift(tk, -1, 0)
    if cfg.masking:
        de = de * grid.vmask[None]
    if not cfg.ns_periodic:
        # (reference: compute_horiz_tracer_fluxes.h:155-164)
        de = eset(de, (Ellipsis, 1, slice(None)), de[..., 2, :], grid.own_s)
        pn = cfg.pad_n
        de = eset(de, (Ellipsis, -1 - pn, slice(None)), de[..., -2 - pn, :],
                  grid.own_n)
    if scheme is AdvScheme.UPSTREAM3:
        curv = shift(de, 1, 0) - de
        fe = (0.5 * (tk + shift(tk, -1, 0)) * flx_v
              - C_UP3_TS * (shift(curv, -1, 0) * _pos(flx_v)
                            + curv * _neg(flx_v)))
    elif scheme is AdvScheme.AKIMA:
        cff = 2.0 * shift(de, 1, 0) * de
        grad = torch.where(cff > EPSIL, cff / (shift(de, 1, 0) + de), 0.0)
        fe = 0.5 * (tk + shift(tk, -1, 0)
                    - C_CEN4_TS * (grad - shift(grad, -1, 0))) * flx_v
    else:
        grad = 0.5 * (shift(de, 1, 0) + de)
        fe = 0.5 * (tk + shift(tk, -1, 0)
                    - C_CEN4_TS * (grad - shift(grad, -1, 0))) * flx_v
    return fx, fe


def coriolis_rhs(u, v, hz, grid, cfg: ModelConfig):
    """Coriolis (+ curvilinear metric) contribution to (ru, rv)
    (reference: compute_horiz_rhs_uv_terms.h:1-38)."""
    cff = grid.fomn[None]
    if cfg.curvgrid and cfg.uv_adv:
        cff = cff + 0.5 * ((v + shift(v, 1, 0)) * grid.dndx[None]
                           - (u + shift(u, 0, 1)) * grid.dmde[None])
    cff = 0.5 * hz * cff
    ufx = cff * (v + shift(v, 1, 0))
    vfe = cff * (u + shift(u, 0, 1))
    ru = 0.5 * (ufx + shift(ufx, 0, -1))
    rv = -0.5 * (vfe + shift(vfe, -1, 0))
    return ru, rv


def horiz_uv_adv_rhs(u, v, flx_u, flx_v, grid, cfg: ModelConfig,
                     scheme: AdvScheme):
    """Horizontal momentum advection divergence added to (ru, rv)
    (reference: compute_horiz_rhs_uv_terms.h:42-291)."""
    upstream = scheme is AdvScheme.UPSTREAM3

    def fix_we(a, dst_w=2, src_w=3, dst_e=-2, src_e=-3):
        if not cfg.ew_periodic:
            a = eset(a, (Ellipsis, slice(None), dst_w), a[..., :, src_w],
                     grid.own_w)
            a = eset(a, (Ellipsis, slice(None), dst_e - cfg.pad_e),
                     a[..., :, src_e - cfg.pad_e], grid.own_e)
        return a

    def fix_ns(a, dst_s=2, src_s=3, dst_n=-2, src_n=-3):
        if not cfg.ns_periodic:
            a = eset(a, (Ellipsis, dst_s, slice(None)), a[..., src_s, :],
                     grid.own_s)
            a = eset(a, (Ellipsis, dst_n - cfg.pad_n, slice(None)),
                     a[..., src_n - cfg.pad_n, :], grid.own_n)
        return a

    # UFx: diagonal u-flux at rho points (reference: :65-101)
    uxx = shift(u, 0, -1) - 2.0 * u + shift(u, 0, 1)
    huxx = shift(flx_u, 0, -1) - 2.0 * flx_u + shift(flx_u, 0, 1)
    uxx = fix_we(uxx)
    huxx = fix_we(huxx)
    if upstream:
        cff = flx_u + shift(flx_u, 0, 1) - DELTA_UV * (huxx + shift(huxx, 0, 1))
        ufx = 0.25 * (cff * (u + shift(u, 0, 1))
                      - GAMMA_UV * (_pos(cff) * uxx
                                    + _neg(cff) * shift(uxx, 0, 1)))
    else:
        ufx = 0.25 * ((u + shift(u, 0, 1) - DELTA_UV * (uxx + shift(uxx, 0, 1)))
                      * (flx_u + shift(flx_u, 0, 1)
                         - DELTA_UV * (huxx + shift(huxx, 0, 1))))

    # VFe: diagonal v-flux at rho points (reference: :122-158)
    vee = shift(v, -1, 0) - 2.0 * v + shift(v, 1, 0)
    hvee = shift(flx_v, -1, 0) - 2.0 * flx_v + shift(flx_v, 1, 0)
    vee = fix_ns(vee)
    hvee = fix_ns(hvee)
    if upstream:
        cff = flx_v + shift(flx_v, 1, 0) - DELTA_UV * (hvee + shift(hvee, 1, 0))
        vfe = 0.25 * (cff * (v + shift(v, 1, 0))
                      - GAMMA_UV * (_pos(cff) * vee
                                    + _neg(cff) * shift(vee, 1, 0)))
    else:
        vfe = 0.25 * ((v + shift(v, 1, 0) - DELTA_UV * (vee + shift(vee, 1, 0)))
                      * (flx_v + shift(flx_v, 1, 0)
                         - DELTA_UV * (hvee + shift(hvee, 1, 0))))

    # UFe: off-diagonal u-flux at psi points (reference: :179-217)
    uee = shift(u, -1, 0) - 2.0 * u + shift(u, 1, 0)
    uee = fix_ns(uee, dst_s=1, src_s=2, dst_n=-2, src_n=-3)
    hvxx = shift(flx_v, 0, -1) - 2.0 * flx_v + shift(flx_v, 0, 1)
    if upstream:
        cff = flx_v + shift(flx_v, 0, -1) - DELTA_UV * (hvxx + shift(hvxx, 0, -1))
        ufe = 0.25 * (cff * (u + shift(u, -1, 0))
                      - GAMMA_UV * (_pos(cff) * shift(uee, -1, 0)
                                    + _neg(cff) * uee))
    else:
        ufe = 0.25 * ((u + shift(u, -1, 0) - DELTA_UV * (uee + shift(uee, -1, 0)))
                      * (flx_v + shift(flx_v, 0, -1)
                         - DELTA_UV * (hvxx + shift(hvxx, 0, -1))))

    # VFx: off-diagonal v-flux at psi points (reference: :238-276)
    vxx = shift(v, 0, -1) - 2.0 * v + shift(v, 0, 1)
    vxx = fix_we(vxx, dst_w=1, src_w=2, dst_e=-2, src_e=-3)
    huee = shift(flx_u, -1, 0) - 2.0 * flx_u + shift(flx_u, 1, 0)
    if upstream:
        cff = flx_u + shift(flx_u, -1, 0) - DELTA_UV * (huee + shift(huee, -1, 0))
        vfx = 0.25 * (cff * (v + shift(v, 0, -1))
                      - GAMMA_UV * (_pos(cff) * shift(vxx, 0, -1)
                                    + _neg(cff) * vxx))
    else:
        vfx = 0.25 * ((v + shift(v, 0, -1) - DELTA_UV * (vxx + shift(vxx, 0, -1)))
                      * (flx_u + shift(flx_u, -1, 0)
                         - DELTA_UV * (huee + shift(huee, -1, 0))))

    ru = -(ufx - shift(ufx, 0, -1)) - (shift(ufe, 1, 0) - ufe)
    rv = -(shift(vfx, 0, 1) - vfx) - (vfe - shift(vfe, -1, 0))
    return ru, rv


def _spline_interfaces(dc, q):
    """Parabolic-spline interface values of q given layer weights dc
    (reference: compute_vert_rhs_uv_terms.h:8-37, non-NEUMANN branch).
    q: (..., nz, jy, ix); dc broadcasts against it.  Returns (..., nz+1,
    jy, ix), entry k at W-level k."""
    nz = q.shape[-3]

    def lev(a, k):
        return a[..., k, :, :]

    cf = [torch.ones_like(lev(q, 0))]            # CF[1] = 1
    fc = [2.0 * lev(q, 0)]                       # FC[0] = 2*q[1]
    for k in range(nz - 1):
        d0, d1 = lev(dc, k), lev(dc, k + 1)
        cff = 1.0 / (2.0 * d0 + d1 * (2.0 - cf[k]))
        cf.append(cff * d0)
        fc.append(cff * (3.0 * (d0 * lev(q, k + 1) + d1 * lev(q, k))
                         - d1 * fc[k]))
    fc_top = (2.0 * lev(q, nz - 1) - fc[nz - 1]) / (1.0 - cf[nz - 1])
    iface = [None] * (nz + 1)
    iface[nz] = fc_top
    for k in range(nz - 1, -1, -1):
        iface[k] = fc[k] - cf[k] * iface[k + 1]
    return torch.stack(iface, dim=-3)


def vert_tracer_flux_spline(tk, hz, we):
    """SPLINE_TS vertical advective flux FC (..., nz+1, jy, ix): interface
    tracer values times We, zero top and bottom
    (reference: compute_vert_tracer_fluxes.h:37-71)."""
    flux = _spline_interfaces(hz, tk) * we
    flux[..., 0, :, :] = 0.0
    flux[..., -1, :, :] = 0.0
    return flux


def vert_uv_rhs_spline(q, hz, we, mask, grid, cfg: ModelConfig, stagger: str):
    """SPLINE_UV vertical momentum advection r.h.s. contribution (nz, ..)
    (reference: compute_vert_rhs_uv_terms.h SPLINE_UV branch)."""
    if stagger == "u":
        dc = (0.5625 * (hz + shift(hz, 0, -1))
              - 0.0625 * (shift(hz, 0, 1) + shift(hz, 0, -2)))
        if cfg.masking:
            wavg = 0.5 * (we + shift(we, 0, -1) - 0.125 * (
                (shift(we, 0, 1) - we) * shift(mask, 0, 1)[None]
                - (shift(we, 0, -1) - shift(we, 0, -2)) * shift(mask, 0, -1)[None]))
        else:
            wavg = (0.5625 * (we + shift(we, 0, -1))
                    - 0.0625 * (shift(we, 0, 1) + shift(we, 0, -2)))
    else:
        dc = (0.5625 * (hz + shift(hz, -1, 0))
              - 0.0625 * (shift(hz, 1, 0) + shift(hz, -2, 0)))
        if cfg.masking:
            wavg = 0.5 * (we + shift(we, -1, 0) - 0.125 * (
                (shift(we, 1, 0) - we) * shift(mask, 1, 0)[None]
                - (shift(we, -1, 0) - shift(we, -2, 0)) * shift(mask, -1, 0)[None]))
        else:
            wavg = (0.5625 * (we + shift(we, -1, 0))
                    - 0.0625 * (shift(we, 1, 0) + shift(we, -2, 0)))

    flux = _spline_interfaces(dc, q) * wavg
    # zero top and bottom fluxes; ru[k] = -(flux[k+1] - flux[k])
    flux[-1] = 0.0
    flux[0] = 0.0
    return -(flux[1:] - flux[:-1])
