"""COARE 3.0 bulk air-sea flux parameterization (port of
roms_tpu/ops/bulk.py; reference: src/bulk_frc.F:142-914, Fairall et al.
1996/2003 lineage).

One function over the whole grid: meteorological inputs (10 m wind, air
temperature, specific humidity, precipitation, downward longwave,
shortwave) and the sea-surface state -> kinematic wind stress, net
surface heat flux, solar flux and freshwater flux in the model's
kinematic units.  The Monin-Obukhov iteration is a fixed 3-pass loop with
the reference's very-stable early exit (IterMax=1 when Zetu > 50,
reference: bulk_frc.F:608-612) reproduced by a freeze mask, so nothing
branches on a tensor's value.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from roms_tpu_torch.config import ModelConfig
from roms_tpu_torch.parallel.halo import shift

# constants (reference: bulk_frc.F:225-251, scalars.F:128-129)
BLK_RGAS = 287.1
BLK_ZW = 10.0
BLK_ZT = 10.0
BLK_ZQ = 10.0
BLK_ZABL = 600.0
BLK_BETA = 1.2
BLK_CPA = 1004.67
EMISS_LW = 0.985
SIGMA_SB = 5.6697e-8
RHO_W = 1000.0
PATM = 1010.0
EPS = 1e-20
R3 = 1.0 / 3.0
CP = 3985.0          # seawater specific heat [J/kg/degC]
CMDAY2MS = 0.01 / 86400.0
CFB_SLOPE = -0.0029  # current-feedback stress correction
CFB_OFFSET = 0.008
CFB_WSPD_MIN = 3.0
CFB_STAU_REF = -0.0027
S3 = math.sqrt(3.0)


def bulk_psiu(zol):
    """Momentum stability function (reference: bulk_frc.F:916-976)."""
    pi = math.pi
    zneg = torch.clamp(zol, max=0.0)
    zpos = torch.clamp(zol, min=0.0)
    x = (1.0 - 15.0 * zneg) ** 0.25
    psik = (2.0 * torch.log(0.5 * (1.0 + x)) + torch.log(0.5 * (1.0 + x * x))
            - 2.0 * torch.atan(x) + 0.5 * pi)
    y = (1.0 - 10.15 * zneg) ** R3
    psic = (1.5 * torch.log(R3 * (1.0 + y + y * y))
            - S3 * torch.atan((1.0 + 2.0 * y) / S3) + pi / S3)
    fw = zol * zol / (1.0 + zol * zol)
    unstable = (1.0 - fw) * psik + fw * psic
    cff = torch.clamp(0.35 * zpos, max=50.0)
    stable = -((1.0 + zpos) + 0.6667 * (zpos - 14.28) / torch.exp(cff)
               + 8.525)
    return torch.where(zol < 0.0, unstable, stable)


def bulk_psit(zol):
    """Heat/moisture stability function (reference: bulk_frc.F:978-1036)."""
    pi = math.pi
    zneg = torch.clamp(zol, max=0.0)
    x = torch.sqrt(1.0 - 15.0 * zneg)
    psik = 2.0 * torch.log(0.5 * (1.0 + x))
    y = (1.0 - 34.15 * zneg) ** R3
    psic = (1.5 * torch.log(R3 * (1.0 + y + y * y))
            - S3 * torch.atan((1.0 + 2.0 * y) / S3) + pi / S3)
    fw = zol * zol / (1.0 + zol * zol)
    unstable = (1.0 - fw) * psik + fw * psic
    zp = torch.clamp(zol, min=0.0)
    cff = torch.clamp(0.35 * zp, max=50.0)
    stable = -((1.0 + 2.0 * zp) ** 1.5
               + 0.6667 * (zp - 14.28) / torch.exp(cff) + 8.525)
    return torch.where(zol < 0.0, unstable, stable)


class BulkFluxes(NamedTuple):
    sustr: torch.Tensor      # kinematic wind stress at u-points [m^2/s^2]
    svstr: torch.Tensor      # at v-points
    stflx_temp: torch.Tensor  # net kinematic heat flux [degC m/s]
    srflx: torch.Tensor      # kinematic solar flux [degC m/s]
    swflx: torch.Tensor      # freshwater (P-E) flux [m/s], positive = input
    evap: torch.Tensor       # evaporation [m/s]


def bulk_flux(uwnd, vwnd, tair, qair, prate, radlw_down, radsw,
              sst, u_sfc, v_sfc, grid, cfg: ModelConfig) -> BulkFluxes:
    """COARE 3.0 fluxes (reference: bulk_frc.F:142-914).

    uwnd/vwnd: 10 m wind at rho points [m/s]; tair [degC]; qair specific
    humidity [kg/kg]; prate precipitation [cm/day]; radlw_down downward
    longwave [W/m2]; radsw shortwave [W/m2]; sst [degC]; u_sfc/v_sfc
    surface-level model currents at their native staggers (for the
    current-feedback stress correction, reference: bulk_frc.F:802-912).
    """
    g = cfg.g
    vonkar = cfg.von_karman
    rho0i = 1.0 / cfg.rho0
    cpi = 1.0 / CP

    wspd0 = torch.sqrt(uwnd * uwnd + vwnd * vwnd)
    tair_k = tair + 273.16
    tsea_k = sst + 273.16
    srflx = radsw * rho0i * cpi
    radlw = radlw_down * rho0i * cpi
    # net longwave: downward minus sea-surface emission (bulk_frc.F:481-482)
    hflw = radlw - EMISS_LW * rho0i * cpi * SIGMA_SB * tsea_k ** 4

    # saturation specific humidity at the sea surface, salinity-reduced
    # (reference: bulk_frc.F:545-554)
    esat = (1.0007 + 3.46e-6 * PATM) * 6.1121 * torch.exp(
        17.502 * sst / (240.97 + sst)) * 0.98
    qsea = 0.62197 * esat / (PATM - 0.378 * esat)

    q = qair
    rho_air = PATM * 100.0 / (BLK_RGAS * tair_k * (1.0 + 0.61 * q))
    vis_air = 1.326e-5 * (1.0 + tair * (6.542e-3 + tair
                                        * (8.301e-6 - 4.84e-9 * tair)))
    hlv = (2.501 - 0.00237 * sst) * 1.0e6

    # neutral first guess (reference: bulk_frc.F:578-632)
    wgus = 0.5
    del_w = torch.sqrt(wspd0 * wspd0 + wgus * wgus)
    del_q = qsea - q
    del_t = sst - tair
    zo_w = 0.0001
    u10 = del_w * math.log(10.0 / zo_w) / math.log(BLK_ZW / zo_w)
    wstar = 0.035 * u10
    zo10 = 0.011 * wstar * wstar / g + 0.11 * vis_air / wstar
    cd10 = (vonkar / torch.log(10.0 / zo10)) ** 2
    ct10 = 0.00115 / torch.sqrt(cd10)
    zot10 = 10.0 / torch.exp(vonkar / ct10)
    cd = (vonkar / torch.log(BLK_ZW / zo10)) ** 2
    ct = vonkar / torch.log(BLK_ZT / zot10)
    cc = vonkar * ct / cd
    ribcu = -BLK_ZW / (BLK_ZABL * 0.004 * BLK_BETA ** 3)
    ri = -g * BLK_ZW * (del_t + 0.61 * tair_k * del_q) / (
        tair_k * del_w * del_w)
    zetu = torch.where(ri < 0.0, cc * ri / (1.0 + ri / ribcu),
                       cc * ri / (1.0 + 3.0 * ri / cc))
    l10 = BLK_ZW / zetu
    freeze = zetu > 50.0  # IterMax=1 for very stable (bulk_frc.F:608-612)

    wstar = del_w * vonkar / (torch.log(BLK_ZW / zo10)
                              - bulk_psiu(BLK_ZW / l10))
    tstar = -del_t * vonkar / (torch.log(BLK_ZT / zot10)
                               - bulk_psit(BLK_ZT / l10))
    qstar = -del_q * vonkar / (torch.log(BLK_ZQ / zot10)
                               - bulk_psit(BLK_ZQ / l10))

    charn = torch.where(del_w > 18.0, 0.018,
                        torch.where(del_w > 10.0,
                                    0.011 + 0.125 * (0.018 - 0.011)
                                    * (del_w - 10.0), 0.011))

    def one_iter(carry):
        wstar, tstar, qstar, del_w, wgus = carry
        zo_w = charn * wstar * wstar / g + 0.11 * vis_air / (wstar + EPS)
        rr = zo_w * wstar / vis_air
        zo_q = torch.clamp(5.5e-5 / rr ** 0.6, max=1.15e-4)
        zo_t = zo_q
        zol = vonkar * g * BLK_ZW * (
            tstar * (1.0 + 0.61 * q) + 0.61 * tair_k * qstar) / (
            tair_k * wstar * wstar * (1.0 + 0.61 * q) + EPS)
        ll = BLK_ZW / (zol + EPS)
        wpsi = bulk_psiu(zol)
        tpsi = bulk_psit(BLK_ZT / ll)
        qpsi = bulk_psit(BLK_ZQ / ll)
        wstar_n = torch.clamp(del_w * vonkar
                              / (torch.log(BLK_ZW / zo_w) - wpsi), min=EPS)
        tstar_n = -del_t * vonkar / (torch.log(BLK_ZT / zo_t) - tpsi)
        qstar_n = -del_q * vonkar / (torch.log(BLK_ZQ / zo_q) - qpsi)
        bff = -g / tair_k * wstar_n * (tstar_n + 0.61 * tair_k * qstar_n)
        wgus_n = torch.where(bff > 0.0,
                             BLK_BETA * (bff * BLK_ZABL) ** R3, 0.2)
        del_w_n = torch.sqrt(wspd0 * wspd0 + wgus_n * wgus_n)
        return wstar_n, tstar_n, qstar_n, del_w_n, wgus_n

    carry = one_iter((wstar, tstar, qstar, del_w, wgus))
    for _ in range(2):
        new = one_iter(carry)
        carry = tuple(torch.where(freeze, c, n) for c, n in zip(carry, new))
    wstar, tstar, qstar, del_w, wgus = carry

    # fluxes (reference: bulk_frc.F:674-754)
    wmag = torch.sqrt(wspd0 * wspd0 + wgus * wgus)
    cd = wstar * wstar / (wmag * wmag + EPS)
    hfsen = -BLK_CPA * rho_air * wstar * tstar
    hflat = -hlv * rho_air * wstar * qstar
    upvel = (-1.61 * wstar * qstar
             - (1.0 + 1.61 * q) * wstar * tstar / tair_k)
    hflat = hflat + rho_air * hlv * upvel * q
    hflat_k = -hflat * rho0i * cpi       # kinematic, positive down
    hfsen_k = -hfsen * rho0i * cpi
    stflx_temp = srflx + hflw + hflat_k + hfsen_k
    evap = -CP * hflat_k / hlv
    swflx = prate * CMDAY2MS - evap
    if cfg.masking:
        stflx_temp = stflx_temp * grid.rmask

    # kinematic stress at rho points + current feedback
    # (reference: bulk_frc.F:753-769, :829-912)
    aer = rho_air * wmag * rho0i
    sustr_r = aer * cd * uwnd
    svstr_r = aer * cd * vwnd
    if cfg.masking:
        sustr_r = sustr_r * grid.rmask
        svstr_r = svstr_r * grid.rmask
    s_tau = torch.where(wspd0 > CFB_WSPD_MIN,
                        CFB_SLOPE * wspd0 + CFB_OFFSET, CFB_STAU_REF)
    # surface current averaged to rho points: 0.5*(u(i)+u(i+1))
    u_r = 0.5 * (u_sfc + shift(u_sfc, 0, 1))
    v_r = 0.5 * (v_sfc + shift(v_sfc, 1, 0))
    sustr_r = sustr_r + s_tau * u_r * rho0i
    svstr_r = svstr_r + s_tau * v_r * rho0i
    # average to velocity points: sustr(i) = (sustr_r(i-1)+sustr_r(i))/2
    sustr = 0.5 * (sustr_r + shift(sustr_r, 0, -1))
    svstr = 0.5 * (svstr_r + shift(svstr_r, -1, 0))
    if cfg.masking:
        sustr = sustr * grid.umask
        svstr = svstr * grid.vmask

    return BulkFluxes(sustr=sustr, svstr=svstr, stflx_temp=stflx_temp,
                      srflx=srflx, swflx=swflx, evap=evap)


def diurnal_modulation(srflx, time, lonr, latr):
    """Diurnal-cycle modulation of daily-mean shortwave
    (reference: bulk_frc.F:366-418, DIURNAL_SRFLUX with UTC_CORRECTION).

    time [s] since initialization (UTC), a tensor; lonr/latr in degrees.
    """
    deg2rad = math.pi / 180.0
    tdays = time / 86400.0
    year2day = 365.25
    cos_h = torch.cos(2.0 * math.pi * (tdays + 0.5 - torch.floor(tdays + 0.5))
                      + deg2rad * lonr)
    dec = -0.406 * torch.cos(deg2rad * (tdays - torch.floor(tdays / year2day)
                                        * year2day))
    cos_d, sin_d, tan_d = torch.cos(dec), torch.sin(dec), torch.tan(dec)
    phi = deg2rad * latr
    h0 = torch.arccos(torch.clamp(-torch.tan(phi) * tan_d, -1.0, 1.0))
    csph = cos_d * torch.cos(phi)
    snph = sin_d * torch.sin(phi)
    ampl = torch.clamp(math.pi * (cos_h * csph + snph)
                       / (torch.sin(h0) * csph + h0 * snph), min=0.0)
    return srflx * ampl
