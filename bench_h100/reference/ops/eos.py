"""Equation of state (port of roms_tpu/ops/eos.py; reference:
src/rho_eos.F): linear EOS and the Jackett & McDougall (1995) split EOS,
the VAR_RHO_2D moments rhoS/rhoA and the Brunt-Vaisala frequency.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from bench_h100.reference.config import ModelConfig

QP2 = 0.0000172  # (reference: src/eos_vars.F)

# JM95 coefficients (reference: rho_eos.F:163-184)
R00, R01, R02 = 999.842594, 6.793952e-2, -9.095290e-3
R03, R04, R05 = 1.001685e-4, -1.120083e-6, 6.536332e-9
R10, R11, R12 = 0.824493, -4.08990e-3, 7.64380e-5
R13, R14 = -8.24670e-7, 5.38750e-9
RS0, RS1, RS2 = -5.72466e-3, 1.02270e-4, -1.65460e-6
R20 = 4.8314e-4
K00, K01, K02 = 19092.56, 209.8925, -3.041638
K03, K04 = -1.852732e-3, -1.361629e-5
K10, K11, K12, K13 = 104.4077, -6.500517, 0.1553190, 2.326469e-4
KS0, KS1, KS2 = -5.587545, +0.7390729, -1.909078e-2


class EosOut(NamedTuple):
    rho: torch.Tensor
    rho1: Optional[torch.Tensor]
    qp1: Optional[torch.Tensor]
    rho_s: Optional[torch.Tensor]
    rho_a: Optional[torch.Tensor]
    bvf: Optional[torch.Tensor]


def _k0(Tt, Ts, sqrtTs):
    return (Tt * (K01 + Tt * (K02 + Tt * (K03 + Tt * K04)))
            + Ts * (K10 + Tt * (K11 + Tt * (K12 + Tt * K13))
                    + sqrtTs * (KS0 + Tt * (KS1 + Tt * KS2))))


def rho_eos(t, z_r, z_w, hz, rmask, cfg: ModelConfig,
            need_bvf: bool = False) -> EosOut:
    """Density from tracers at one time level.
    t: (nt, nz, jy, ix); z_r/hz: (nz, ..); z_w: (nz+1, ..)."""
    Tt = t[cfg.itemp]
    if cfg.nonlin_eos:
        # JM95 split EOS (reference: rho_eos.F:197-266)
        if cfg.salinity:
            Ts = t[cfg.isalt]
            sqrtTs = torch.sqrt(torch.clamp(Ts, min=0.0))
        else:
            Ts = torch.full_like(Tt, 34.5)
            sqrtTs = torch.sqrt(Ts)
        dr00 = R00 - cfg.rho0
        rho1 = (dr00 + Tt * (R01 + Tt * (R02 + Tt * (R03 + Tt * (R04 + Tt * R05))))
                + Ts * (R10 + Tt * (R11 + Tt * (R12 + Tt * (R13 + Tt * R14)))
                        + sqrtTs * (RS0 + Tt * (RS1 + Tt * RS2)) + Ts * R20))
        if cfg.masking:
            rho1 = rho1 * rmask[None]
        K0 = _k0(Tt, Ts, sqrtTs)
        # DUKO_2001 reference profile (reference: rho_eos.F:198-204)
        Tt0, Ts0 = 3.8, 34.5
        K0_duk = _k0(Tt0, Ts0, torch.sqrt(torch.tensor(
            Ts0, dtype=Tt.dtype, device=Tt.device)))
        qp1 = 0.1 * (cfg.rho0 + rho1) * (K0_duk - K0) / (
            (K00 + K0) * (K00 + K0_duk))
        if cfg.masking:
            qp1 = qp1 * rmask[None]
        dpth = -z_r
        rho = rho1 + qp1 * dpth * (1.0 - QP2 * dpth)
        bvf = None
        if need_bvf:
            cff = cfg.g / cfg.rho0
            dpth_w = -0.5 * (z_r[1:] + z_r[:-1])
            dbv = -cff * (rho1[1:] - rho1[:-1]
                          + (qp1[1:] - qp1[:-1]) * dpth_w * (1.0 - QP2 * dpth_w)
                          ) / (z_r[1:] - z_r[:-1])
            if cfg.masking:
                dbv = dbv * rmask[None]
            bvf = torch.cat([dbv[:1], dbv, dbv[-1:]], dim=0)
    else:
        # linear EOS (reference: rho_eos.F:309-353)
        cff = cfg.tcoef * cfg.t0
        if cfg.salinity:
            cff = cff - cfg.scoef * cfg.s0
        rho = cff - cfg.tcoef * Tt
        if cfg.salinity:
            rho = rho + cfg.scoef * t[cfg.isalt]
        if cfg.masking:
            rho = rho * rmask[None]
        rho1 = qp1 = bvf = None
        if need_bvf:
            c = cfg.g / cfg.rho0
            dbv = c * (rho[:-1] - rho[1:]) / (z_r[1:] - z_r[:-1])
            bvf = torch.cat([dbv[:1], dbv, dbv[-1:]], dim=0)

    rho_s = rho_a = None
    if cfg.var_rho_2d:
        # sequential top-down accumulation in the reference's order
        # (reference: rho_eos.F:364-394)
        cffk = hz * rho
        nz = cfg.nz
        rs = 0.5 * cffk[nz - 1] * hz[nz - 1]
        ra = cffk[nz - 1]
        for kk in range(nz - 2, -1, -1):
            c = cffk[kk]
            rs = rs + hz[kk] * (ra + 0.5 * c)
            ra = ra + c
        cff1 = 1.0 / cfg.rho0
        cffd = 1.0 / (z_w[-1] - z_w[0])
        rho_a = cffd * cff1 * ra
        rho_s = 2.0 * cffd * cffd * cff1 * rs

    return EosOut(rho=rho, rho1=rho1, qp1=qp1, rho_s=rho_s, rho_a=rho_a,
                  bvf=bvf)
