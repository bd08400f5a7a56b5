"""Rotated (isoneutral) biharmonic tracer diffusion (port of
roms_tpu/ops/isoneutral.py; reference: cppdefs ADV_ISONEUTRAL;
src/step3d_t_ISO.F:255-850, the two rotated Laplacian passes with
SW_TRIADS upwinded slope triads and the STABILIZE implicit/explicit
vertical split; slope ingredients from src/prsgrd.F:306-336 dRdx/dRde
and src/step3d_uv2.F:571-683 diff3u/diff3v + idRz).

Where the JAX package vmaps the increment over the tracers, this module
takes every tracer in one pass: a tracer field is (..., nz, jy, ix) with
the levels on axis -3, while the slope fields are (nz, jy, ix) and
broadcast.  The STABILIZE diffusivity Akz depends on the slope fields
alone, so it is computed once for all tracers.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from bench_h100.reference.config import ModelConfig
from bench_h100.reference.ops.eos import QP2
from bench_h100.reference.parallel.halo import eset, shift

GAMMA = 0.0833333333333   # hyperdiffusivity scale (step3d_uv2.F:77)
ALPHA_MAX = 2.0           # max isoneutral slope factor (step3d_uv2.F:76)
EPSIL = 1e-33
SW_WGT = (0.0, 1.0, 0.5, 1.0 / 3.0, 0.25)
BL_THICK = 50.0           # boundary-layer taper floor [m] (step3d_uv2.F:662)


class IsoFields(NamedTuple):
    drdx: torch.Tensor    # (nz, jy, ix) adiabatic x density slope term at u
    drde: torch.Tensor    # at v
    idrz: torch.Tensor    # (nz-1, jy, ix) limited inverse d(rho)/dz
    diff3u: torch.Tensor  # sqrt of the hyperdiffusivity at u (nz, jy, ix)
    diff3v: torch.Tensor


def _lo(a):
    """Levels 0..n-2 of a field with the levels on axis -3."""
    return a[..., :-1, :, :]


def _hi(a):
    """Levels 1..n-1 of a field with the levels on axis -3."""
    return a[..., 1:, :, :]


def _adiabatic_dx(rho, rho1, qp1, z_r, sh, cfg):
    """Adiabatic elementary density difference (SPLIT_EOS aware,
    reference: prsgrd.F rx)."""
    if cfg.nonlin_eos:
        dpth = -0.5 * (z_r + sh(z_r, -1))
        return (rho1 - sh(rho1, -1)
                + (qp1 - sh(qp1, -1)) * dpth * (1.0 - QP2 * dpth))
    return rho - sh(rho, -1)


def slope_fields(rho, rho1, qp1, z_r, z_w, hz, hbls, hbbl,
                 u_new, v_new, grid, cfg: ModelConfig) -> IsoFields:
    """All geometric and coefficient inputs of the rotated operator."""
    r0g = cfg.rho0 / cfg.g
    nz = cfg.nz

    # dRdx at u points (reference: prsgrd.F:316-329)
    def shx(a, d):
        return shift(a, 0, d)

    def she(a, d):
        return shift(a, d, 0)

    rx = _adiabatic_dx(rho, rho1, qp1, z_r, shx, cfg)
    if cfg.masking:
        rx = rx * grid.umask[None]
    f_u2 = (0.5 * (grid.f + shx(grid.f, -1))) ** 2
    drdx = grid.pm_u[None] * (
        r0g * f_u2[None] * (z_r - shx(z_r, -1))
        - 0.5 * rx - 0.25 * (shx(rx, -1) + shx(rx, 1)))

    re = _adiabatic_dx(rho, rho1, qp1, z_r, she, cfg)
    if cfg.masking:
        re = re * grid.vmask[None]
    f_v2 = (0.5 * (grid.f + she(grid.f, -1))) ** 2
    drde = grid.pn_v[None] * (
        r0g * f_v2[None] * (z_r - she(z_r, -1))
        - 0.5 * re - 0.25 * (she(re, -1) + she(re, 1)))

    # idRz at the interfaces k=1..N-1 (reference: step3d_uv2.F:622-683)
    if cfg.nonlin_eos:
        dpth = -0.5 * (z_r[1:] + z_r[:-1])
        drz = (rho1[:-1] - rho1[1:]
               + (qp1[:-1] - qp1[1:]) * dpth * (1.0 - 2.0 * QP2 * dpth))
    else:
        drz = rho[:-1] - rho[1:]
    dz = z_r[1:] - z_r[:-1]
    drz = torch.clamp_min(drz, 0.0) + r0g * grid.f[None] ** 2 * dz

    adx = drdx.abs()
    ade = drde.abs()
    adx_if = torch.maximum(adx[:-1], adx[1:])    # max over cells k, k+1
    ade_if = torch.maximum(ade[:-1], ade[1:])
    drx_max = torch.maximum(
        torch.maximum(grid.dm_u[None] * adx_if,
                      shx(grid.dm_u, 1)[None] * shx(adx_if, 1)),
        torch.maximum(grid.dn_v[None] * ade_if,
                      she(grid.dn_v, 1)[None] * she(ade_if, 1)))

    zw_if = z_w[1:nz]     # interface heights k=1..N-1
    if cfg.lmd_kpp:
        cfs = torch.clamp_max((z_w[nz][None] - zw_if)
                              / torch.clamp_min(hbls, BL_THICK)[None], 1.0)
        cfb = torch.clamp_max((zw_if - z_w[0][None])
                              / torch.clamp_min(hbbl, BL_THICK)[None], 1.0)
    else:
        cfs = torch.clamp_max((z_w[nz][None] - zw_if) / BL_THICK, 1.0)
        cfb = torch.clamp_max((zw_if - z_w[0][None]) / BL_THICK, 1.0)
    cff = ALPHA_MAX * cfs * (2.0 - cfs) * cfb * (2.0 - cfb)
    idrz = cff / torch.clamp_min(torch.maximum(cff * drz, drx_max), EPSIL)

    # sqrt hyperdiffusivities (reference: step3d_uv2.F:571-618)
    diff3u = torch.sqrt(GAMMA * u_new.abs() * grid.dm_u[None]) \
        * grid.dm_u[None]
    diff3v = torch.sqrt(GAMMA * v_new.abs() * grid.dn_v[None]) \
        * grid.dn_v[None]
    return IsoFields(drdx=drdx, drde=drde, idrz=idrz,
                     diff3u=diff3u, diff3v=diff3v)


def _interfaces(T, iso: IsoFields, z_r):
    """dT/dz (scaled by idRz) at all nz+1 interfaces of T (..., nz, jy,
    ix), and the FSC metric (nz+1, jy, ix) (reference:
    step3d_t_ISO.F:317-345)."""
    dt_in = iso.idrz * (_hi(T) - _lo(T))
    dt_if = torch.cat([dt_in[..., :1, :, :], dt_in, dt_in[..., -1:, :, :]],
                      dim=-3)
    zero = torch.zeros_like(iso.idrz[:1])
    fsc_m = torch.cat([zero, iso.idrz * (z_r[1:] - z_r[:-1]), zero])
    return dt_if, fsc_m


def _stabilization(iso: IsoFields, hz, fsc_m, grid, cfg: ModelConfig):
    """The implicit stabilization diffusivity Akz (nz-1, jy, ix) of the
    second pass, which depends on the slope fields alone (reference:
    step3d_t_ISO.F:653-720)."""
    def shx(a):
        return shift(a, 0, 1)

    def she(a):
        return shift(a, 1, 0)

    dR_lo, dR_hi = iso.drdx[:-1], iso.drdx[1:]
    dR_lo_e, dR_hi_e = shx(dR_lo), shx(dR_hi)
    d3_lo, d3_hi = iso.diff3u[:-1], iso.diff3u[1:]
    d3_lo_e, d3_hi_e = shx(d3_lo), shx(d3_hi)
    dE_lo, dE_hi = iso.drde[:-1], iso.drde[1:]
    dE_lo_n, dE_hi_n = she(dE_lo), she(dE_hi)
    e3_lo, e3_hi = iso.diff3v[:-1], iso.diff3v[1:]
    e3_lo_n, e3_hi_n = she(e3_lo), she(e3_hi)

    s2 = fsc_m[1:-1] ** 2
    s2_xll = s2 * dR_lo ** 2
    s2_xlu = s2 * dR_hi ** 2
    s2_xru = s2 * dR_hi_e ** 2
    s2_xrl = s2 * dR_lo_e ** 2
    s2_ell = s2 * dE_lo ** 2
    s2_elu = s2 * dE_hi ** 2
    s2_eru = s2 * dE_hi_n ** 2
    s2_erl = s2 * dE_lo_n ** 2
    cff2 = (2.0 / (hz[1:] + hz[:-1])) ** 2
    cffx = grid.pm[None] ** 2
    cffe = grid.pn[None] ** 2
    mx = torch.maximum
    if cfg.sw_triads:
        m1 = mx(mx(d3_lo * s2_xll, d3_lo_e * s2_xrl),
                mx(d3_hi * s2_xlu, d3_hi_e * s2_xru))
        m2 = mx(mx(e3_lo * s2_ell, e3_lo_n * s2_erl),
                mx(e3_hi * s2_elu, e3_hi_n * s2_eru))
        m3 = mx(mx(d3_lo * (cffx + cff2 * s2_xll),
                   d3_hi * (cffx + cff2 * s2_xlu)),
                mx(d3_hi_e * (cffx + cff2 * s2_xru),
                   d3_lo_e * (cffx + cff2 * s2_xrl)))
        m4 = mx(mx(e3_lo * (cffe + cff2 * s2_ell),
                   e3_hi * (cffe + cff2 * s2_elu)),
                mx(e3_hi_n * (cffe + cff2 * s2_eru),
                   e3_lo_n * (cffe + cff2 * s2_erl)))
        return 15.0 * (m1 + m2) * (m3 + m4)
    a1 = (d3_lo * s2_xll + d3_lo_e * s2_xrl + d3_hi * s2_xlu
          + d3_hi_e * s2_xru + e3_lo * s2_ell + e3_lo_n * s2_erl
          + e3_hi * s2_elu + e3_hi_n * s2_eru)
    a2 = (d3_lo * (cffx + cff2 * s2_xll)
          + d3_hi * (cffx + cff2 * s2_xlu)
          + d3_hi_e * (cffx + cff2 * s2_xru)
          + d3_lo_e * (cffx + cff2 * s2_xrl)
          + e3_lo * (cffe + cff2 * s2_ell)
          + e3_hi * (cffe + cff2 * s2_elu)
          + e3_hi_n * (cffe + cff2 * s2_eru)
          + e3_lo_n * (cffe + cff2 * s2_erl))
    return 0.5 * a1 * a2


def _cross_terms(d3_lo, d3_hi, dR_lo, dR_hi, dtd_lo, dtd_hi, dz_if, sh):
    """The four triad terms of one direction at the interior interfaces:
    below and above the interface, on this face and on the next one
    (reference: step3d_t_ISO.F:420-470)."""
    d3_lo_e, d3_hi_e = sh(d3_lo), sh(d3_hi)
    dR_lo_e, dR_hi_e = sh(dR_lo), sh(dR_hi)
    return (
        (dR_lo, d3_lo * dR_lo * (dR_lo * dz_if - dtd_lo)),
        (dR_hi, d3_hi * dR_hi * (dR_hi * dz_if - dtd_hi)),
        (dR_hi_e, d3_hi_e * dR_hi_e * (dR_hi_e * dz_if - sh(dtd_hi))),
        (dR_lo_e, d3_lo_e * dR_lo_e * (dR_lo_e * dz_if - sh(dtd_lo))))


def _rot_fluxes(T, iso: IsoFields, hz, z_r, grid, cfg: ModelConfig,
                sign: float, t_stab=None):
    """One rotated Laplacian's fluxes of T (..., nz, jy, ix): FX (u), FE
    (v) per cell and FSC at the interfaces (reference: step3d_t_ISO.F
    first pass :305-512, second pass with sign=-1 :620-825).  With
    cfg.stabilize and t_stab given (second pass), also returns the
    implicit stabilization diffusivity Akz (nz-1, jy, ix), else None."""
    def shx(a, d=1):
        return shift(a, 0, d)

    def she(a, d=1):
        return shift(a, d, 0)

    dt_if, fsc_m = _interfaces(T, iso, z_r)

    dtdx = grid.pm_u[None] * (T - shx(T, -1))
    dtde = grid.pn_v[None] * (T - she(T, -1))
    if cfg.masking:
        dtdx = dtdx * grid.umask[None]
        dtde = dtde * grid.vmask[None]

    lo, hi = _lo(dt_if), _hi(dt_if)          # per-cell interface pair
    dt_if_w = shx(dt_if, -1)
    if cfg.sw_triads:
        trx = 0.5 * (torch.clamp_max(iso.drdx, 0.0) * (_lo(dt_if_w) + hi)
                     + torch.clamp_min(iso.drdx, 0.0) * (_hi(dt_if_w) + lo))
    else:
        trx = 0.25 * iso.drdx * (_lo(dt_if_w) + hi + _hi(dt_if_w) + lo)
    del dt_if_w
    fx = sign * iso.diff3u * 0.5 * (hz + shx(hz, -1)) * grid.dn_u[None] \
        * (dtdx - trx)
    del trx
    dt_if_s = she(dt_if, -1)
    if cfg.sw_triads:
        tre = 0.5 * (torch.clamp_max(iso.drde, 0.0) * (_lo(dt_if_s) + hi)
                     + torch.clamp_min(iso.drde, 0.0) * (_hi(dt_if_s) + lo))
    else:
        tre = 0.25 * iso.drde * (_lo(dt_if_s) + hi + _hi(dt_if_s) + lo)
    del dt_if_s
    fe = sign * iso.diff3v * 0.5 * (hz + she(hz, -1)) * grid.dm_v[None] \
        * (dtde - tre)
    del tre

    # vertical cross flux at the interfaces kw = 1..N-1, from the cell
    # quantities below (kw-1) and above (kw) each interface
    dz_if = dt_if[..., 1:-1, :, :]           # dTdz at interior interfaces
    tx = _cross_terms(iso.diff3u[:-1], iso.diff3u[1:], iso.drdx[:-1],
                      iso.drdx[1:], _lo(dtdx), _hi(dtdx), dz_if, shx)
    te = _cross_terms(iso.diff3v[:-1], iso.diff3v[1:], iso.drde[:-1],
                      iso.drde[1:], _lo(dtde), _hi(dtde), dz_if, she)
    del dtdx, dtde, dt_if, dz_if
    if cfg.sw_triads:
        # a triad enters where its slope points down its side: below the
        # interface for a negative slope on this face, and so on
        cx = [tx[0][0] < 0.0, tx[1][0] > 0.0, tx[2][0] < 0.0,
              tx[3][0] > 0.0]
        ce = [te[0][0] < 0.0, te[1][0] > 0.0, te[2][0] < 0.0,
              te[3][0] > 0.0]
        sum_x = sum(torch.where(c, t, 0.0) for c, (_, t) in zip(cx, tx))
        sum_e = sum(torch.where(c, t, 0.0) for c, (_, t) in zip(ce, te))
        del tx, te
        wgt = torch.tensor(SW_WGT, dtype=T.dtype, device=T.device)
        wx = wgt[sum(c.long() for c in cx)]
        we = wgt[sum(c.long() for c in ce)]
        fsc_in = fsc_m[1:-1] * (sum_x * wx + sum_e * we)
        del sum_x, sum_e
    else:
        fsc_in = fsc_m[1:-1] * 0.25 * (tx[0][1] + tx[1][1] + tx[2][1]
                                       + tx[3][1] + te[0][1] + te[1][1]
                                       + te[2][1] + te[3][1])
        del tx, te
    fsc_in = sign * fsc_in

    akz = None
    if t_stab is not None and cfg.stabilize:
        # implicit/explicit stabilization split (reference:
        # step3d_t_ISO.F:653-720 Akz + :809-811 explicit part)
        akz = _stabilization(iso, hz, fsc_m, grid, cfg)
        cff = 2.0 / (hz[1:] + hz[:-1])
        fsc_in = fsc_in - cff * akz * (_hi(t_stab) - _lo(t_stab))

    zero = torch.zeros_like(fsc_in[..., :1, :, :])
    fsc = torch.cat([zero, fsc_in, zero], dim=-3)
    return fx, fe, fsc, akz


def _lap_bc(lap, grid, cfg: ModelConfig):
    """Ghost values of the intermediate Laplacian, any leading axes
    (reference: step3d_t_ISO.F:521-570): 0 at walls, gradient at open
    boundaries."""
    pe, pn = cfg.pad_e, cfg.pad_n
    if not cfg.ew_periodic:
        lap = eset(lap, (Ellipsis, slice(None), 1),
                   lap[..., :, 2] if cfg.obc_west else 0.0 * lap[..., :, 1],
                   grid.own_w)
        lap = eset(lap, (Ellipsis, slice(None), -2 - pe),
                   lap[..., :, -3 - pe] if cfg.obc_east
                   else 0.0 * lap[..., :, -2 - pe],
                   grid.own_e)
    if not cfg.ns_periodic:
        lap = eset(lap, (Ellipsis, 1, slice(None)),
                   lap[..., 2, :] if cfg.obc_south else 0.0 * lap[..., 1, :],
                   grid.own_s)
        lap = eset(lap, (Ellipsis, -2 - pn, slice(None)),
                   lap[..., -3 - pn, :] if cfg.obc_north
                   else 0.0 * lap[..., -2 - pn, :],
                   grid.own_n)
    return lap


def isoneutral_increment(t_nstp, iso: IsoFields, hz, z_r, grid,
                         cfg: ModelConfig, halo):
    """Hz-weighted increment of the rotated biharmonic of every tracer of
    t_nstp (..., nz, jy, ix), to be added (already times dt) to the
    tracer r.h.s., and the Akz stabilization diffusivity (nz-1, jy, ix)
    for the implicit solve, or None without cfg.stabilize (reference:
    step3d_t_ISO.F two-pass structure)."""
    pmn = (grid.pm * grid.pn)[None]
    fx, fe, fsc, _ = _rot_fluxes(t_nstp, iso, hz, z_r, grid, cfg,
                                 sign=1.0)
    lap = (pmn * (shift(fx, 0, 1) - fx + shift(fe, 1, 0) - fe)
           + _hi(fsc) - _lo(fsc)) / hz
    del fx, fe, fsc
    lap = halo(_lap_bc(lap, grid, cfg))

    fx, fe, fsc, akz = _rot_fluxes(lap, iso, hz, z_r, grid, cfg,
                                   sign=-1.0, t_stab=t_nstp)
    del lap
    incr = cfg.dt * (pmn * (shift(fx, 0, 1) - fx + shift(fe, 1, 0) - fe)
                     + _hi(fsc) - _lo(fsc))
    return incr, akz
