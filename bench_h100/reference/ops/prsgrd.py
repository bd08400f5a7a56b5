"""Density-Jacobian pressure gradient (port of roms_tpu/ops/prsgrd.py;
reference: src/prsgrd.F, Shchepetkin & McWilliams 2003).

The downward hydrostatic integral is a reversed `torch.cumsum`
(sequential), where the JAX package uses `lax.associative_scan`: the two
agree to round-off.
"""

from __future__ import annotations

import torch

from bench_h100.reference.config import ModelConfig
from bench_h100.reference.ops.eos import QP2
from bench_h100.reference.parallel.halo import eset, shift

ONE_FIFTH = 0.2
ONE_TWELFTH = 1.0 / 12.0


def _harmonic(a, b, guard: bool):
    """2ab/(a+b) where (guard: 2ab>0) else 0 (reference: prsgrd.F:186-195)."""
    cff = 2.0 * a * b
    if guard:
        return torch.where(cff > 0.0, cff / (a + b), 0.0)
    return cff / (a + b)


def prsgrd(rho, rho1, qp1, z_r, z_w, hz, grid, cfg: ModelConfig, ptide=None):
    """Return (ru, rv): finite-volume pressure-gradient r.h.s. [m^4/s^2]."""
    nz = cfg.nz
    grho = cfg.g / cfg.rho0
    half_grho = 0.5 * grho
    split = cfg.nonlin_eos

    # vertical elementary differences at W-points (reference: :160-183)
    dz_el = z_r[1:] - z_r[:-1]
    if split:
        dpth_w = -0.5 * (z_r[1:] + z_r[:-1])
        dr_el = (rho1[1:] - rho1[:-1]
                 + (qp1[1:] - qp1[:-1]) * dpth_w * (1.0 - QP2 * dpth_w))
    else:
        dr_el = rho[1:] - rho[:-1]
    dz_ext = torch.cat([dz_el[:1], dz_el, dz_el[-1:]], dim=0)
    dr_ext = torch.cat([dr_el[:1], dr_el, dr_el[-1:]], dim=0)
    dZ = _harmonic(dz_ext[1:], dz_ext[:-1], guard=False)
    dR = _harmonic(dr_ext[1:], dr_ext[:-1], guard=True)
    if split:
        dpth_r = -z_r
        dR = dR - qp1 * dZ * (1.0 - 2.0 * QP2 * dpth_r)

    # hydrostatic pressure integral (reference: :205-225)
    p_top = cfg.g * z_w[nz] + grho * (
        rho[nz - 1] + 0.5 * (rho[nz - 1] - rho[nz - 2])
        * (z_w[nz] - z_r[nz - 1]) / (z_r[nz - 1] - z_r[nz - 2])
    ) * (z_w[nz] - z_r[nz - 1])
    if ptide is not None:
        p_top = p_top - cfg.g * ptide

    # increment from level k+1 down to k, all k at once
    r1, r0 = rho[1:], rho[:-1]
    z1, z0 = z_r[1:], z_r[:-1]
    R1, R0 = dR[1:], dR[:-1]
    Z1, Z0 = dZ[1:], dZ[:-1]
    incr = half_grho * (
        (r1 + r0) * (z1 - z0)
        - ONE_FIFTH * (
            (R1 - R0) * (z1 - z0 - ONE_TWELFTH * (Z1 + Z0))
            - (Z1 - Z0) * (r1 - r0 - ONE_TWELFTH * (R1 + R0))))
    p_below = p_top[None] + torch.flip(
        torch.cumsum(torch.flip(incr, [0]), dim=0), [0])
    P = torch.cat([p_below, p_top[None]], dim=0)

    def horiz_component(ax):
        """ax=1: XI (u-points); ax=0: ETA (v-points)."""
        if ax == 1:
            def sh(a, d):
                return shift(a, 0, d)
            mask = grid.umask[None]
            dn = grid.dn_u[None]
            hz_face = 0.5 * (hz + shift(hz, 0, -1))
        else:
            def sh(a, d):
                return shift(a, d, 0)
            mask = grid.vmask[None]
            dn = grid.dm_v[None]
            hz_face = 0.5 * (hz + shift(hz, -1, 0))

        FC = (z_r - sh(z_r, -1))
        if cfg.masking:
            FC = FC * mask
        if split:
            dpth = -0.5 * (z_r + sh(z_r, -1))
            rx = (rho1 - sh(rho1, -1)
                  + (qp1 - sh(qp1, -1)) * dpth * (1.0 - QP2 * dpth))
        else:
            rx = rho - sh(rho, -1)
        if cfg.masking:
            rx = rx * mask

        # extrapolate elementary differences near physical boundaries
        # (reference: prsgrd.F:256-269, :369-382)
        pe, pn = cfg.pad_e, cfg.pad_n
        if ax == 1 and not cfg.ew_periodic:
            FC = eset(FC, (Ellipsis, slice(None), 2), FC[..., :, 3],
                      grid.own_w)
            FC = eset(FC, (Ellipsis, slice(None), -2 - pe),
                      FC[..., :, -3 - pe], grid.own_e)
            rx = eset(rx, (Ellipsis, slice(None), 2), rx[..., :, 3],
                      grid.own_w)
            rx = eset(rx, (Ellipsis, slice(None), -2 - pe),
                      rx[..., :, -3 - pe], grid.own_e)
        if ax == 0 and not cfg.ns_periodic:
            FC = eset(FC, (Ellipsis, 2, slice(None)), FC[..., 3, :],
                      grid.own_s)
            FC = eset(FC, (Ellipsis, -2 - pn, slice(None)),
                      FC[..., -3 - pn, :], grid.own_n)
            rx = eset(rx, (Ellipsis, 2, slice(None)), rx[..., 3, :],
                      grid.own_s)
            rx = eset(rx, (Ellipsis, -2 - pn, slice(None)),
                      rx[..., -3 - pn, :], grid.own_n)

        dZx = _harmonic(FC, sh(FC, 1), guard=True)
        dRx = _harmonic(rx, sh(rx, 1), guard=True)
        if split:
            dRx = dRx - qp1 * dZx * (1.0 + 2.0 * QP2 * z_r)

        return hz_face * dn * (
            sh(P, -1) - P - half_grho * (
                (rho + sh(rho, -1)) * (z_r - sh(z_r, -1))
                - ONE_FIFTH * (
                    (dRx - sh(dRx, -1)) * (z_r - sh(z_r, -1)
                                           - ONE_TWELFTH * (dZx + sh(dZx, -1)))
                    - (dZx - sh(dZx, -1)) * (rho - sh(rho, -1)
                                             - ONE_TWELFTH * (dRx + sh(dRx, -1))))))

    return horiz_component(1), horiz_component(0)
