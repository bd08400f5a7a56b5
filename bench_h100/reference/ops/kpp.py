"""LMD (Large-McWilliams-Doney 1994) vertical mixing: interior shear /
convective mixing, KPP surface and bottom boundary layers, two-band solar
absorption (port of roms_tpu/ops/kpp.py; the plain reference of the
`csrc/kpp_vmix.cu` kernel, see `cuda_kpp.py`).

References into the Fortran source:
  interior mixing:     src/lmd_vmix.F:31-433 (LMD_RIMIX + SMOOTH_RIG +
                       LMD_CONVEC, bottom turbulence suppression, vertical
                       smoothing, Akx_bak padding)
  KPP boundary layers: src/lmd_kpp.F:7-651 (INT_AT_RHO_POINTS bulk
                       Richardson integral, SMOOTH_HBL, surface + bottom
                       layers, nonlocal transport ghat)
  stability functions: src/lmd_wscale_ws_only.h, lmd_wscale_wm_and_ws.h
  solar absorption:    src/lmd_swr_frac.F (Paulson & Simpson 1977)
  alpha/beta:          src/alfabeta.F (Jackett & McDougall 1992)

torch has no cube root, so `_cbrt` is sign(x)*|x|**(1/3); it differs
from `jnp.cbrt` by a few ulp, inside the 1e-12 float64 bound the tests
hold this module to.  The JAX package's `lax.scan`s are Python loops
over levels, its `lax.associative_scan` a reversed `torch.cumsum` (a
sequential sum where XLA sums in tree order: round-off only).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from bench_h100.reference.config import ModelConfig
from bench_h100.reference.parallel.halo import eset, shift

# ---- KPP constants (reference: lmd_kpp.F:60-84) --------------------------
RICR = 0.15
RI_INV = 1.0 / RICR
EPSSFC = 0.1
BETAT = -0.2
NUBL = 0.01
NU0C = 0.1
CV = 1.8
C_MO = 1.0
C_EK = 258.0
CSTAR = 10.0
ZETA_M = -0.2
A_M = 1.257
C_M = 8.360
ZETA_S = -1.0
A_S = -28.86
C_S = 98.96
EPS_KPP = 1.0e-20

# ---- interior mixing constants (reference: lmd_vmix.F:64-91) -------------
RI0 = 0.7
NU0M = 1.0e-2
NU0S = 1.0e-2
NUWM = 1.0e-4
NUWS = 0.1e-4
LTURB = 10.0


def _cbrt(x):
    """Real cube root: sign(x) * |x|**(1/3)."""
    return torch.sign(x) * torch.abs(x) ** (1.0 / 3.0)


def surface_constants(cfg: ModelConfig):
    """(cg, vtc): the nonlocal-flux and unresolved-shear coefficients
    (reference: lmd_kpp.F:238-245), host floats."""
    vk = cfg.von_karman
    cg = CSTAR * vk * (C_S * vk * EPSSFC) ** (1.0 / 3.0)
    vtc = CV * math.sqrt(-BETAT / (C_S * EPSSFC)) / (RICR * vk ** 2)
    return cg, vtc


def alfabeta(t_surf, cfg: ModelConfig):
    """Thermal expansion alpha and saline contraction beta at the surface
    (reference: src/alfabeta.F)."""
    if not cfg.nonlin_eos:
        # linear EOS: alpha=|Tcoef|, beta=|Scoef| (reference: alfabeta.F:73-78)
        alpha = torch.full_like(t_surf[cfg.itemp], abs(cfg.tcoef))
        beta = torch.full_like(alpha, abs(cfg.scoef) if cfg.salinity else 0.0)
        return alpha, beta
    r01, r02, r03, r04, r05 = (6.793952e-2, -9.095290e-3, 1.001685e-4,
                               -1.120083e-6, 6.536332e-9)
    r10, r11, r12, r13, r14 = (0.824493, -4.08990e-3, 7.64380e-5,
                               -8.24670e-7, 5.38750e-9)
    rS0, rS1, rS2, r20 = -5.72466e-3, 1.02270e-4, -1.65460e-6, 4.8314e-4
    cff = 1.0 / cfg.rho0
    Tt = t_surf[cfg.itemp]
    alpha = -(r01 + Tt * (2 * r02 + Tt * (3 * r03 + Tt * (4 * r04 + Tt * 5 * r05))))
    if cfg.salinity:
        Ts = t_surf[cfg.isalt]
        sqrtTs = torch.sqrt(torch.clamp(Ts, min=0.0))
        alpha = alpha - Ts * (r11 + Tt * (2 * r12 + Tt * (3 * r13 + Tt * 4 * r14))
                              + sqrtTs * (rS1 + Tt * 2 * rS2))
        beta = cff * (r10 + Tt * (r11 + Tt * (r12 + Tt * (r13 + Tt * r14)))
                      + 1.5 * (rS0 + Tt * (rS1 + Tt * rS2)) * sqrtTs
                      + 2 * r20 * Ts)
    else:
        beta = torch.zeros_like(Tt)
    return cff * alpha, beta


def swr_frac(hz, cfg: ModelConfig):
    """Fraction of shortwave radiation penetrating to each W-level;
    two-band Jerlov type 1 (reference: src/lmd_swr_frac.F:38-95).
    Returns (nz+1, ..)."""
    mu1, mu2, r1 = 0.35, 23.0, 0.58
    attn1 = -1.0 / mu1
    attn2 = -1.0 / mu2
    nz = hz.shape[0]
    ones = torch.ones_like(hz[0])
    s1, s2 = r1 * ones, (1.0 - r1) * ones
    fr = [None] * (nz + 1)
    fr[nz] = ones
    for k in range(nz - 1, -1, -1):      # downward from the surface
        xi1 = attn1 * hz[k]
        xi2 = attn2 * hz[k]
        s1 = torch.where(xi1 > -20.0, s1 * torch.exp(xi1), 0.0)
        s2 = torch.where(xi2 > -20.0, s2 * torch.exp(xi2), 0.0)
        fr[k] = s1 + s2
    return torch.stack(fr, dim=0)


def _smooth2d(wrk, grid, cfg: ModelConfig):
    """Masked isotropic Laplacian smoother, cff=1/12, cff1=3/16
    (reference: src/lmd_kpp_smooth_hbl.h).  Physical-edge ghosts must be
    pre-filled by the caller."""
    cff, cff1 = 1.0 / 12.0, 3.0 / 16.0
    fx = (wrk - shift(wrk, 0, -1))
    fe1 = (wrk - shift(wrk, -1, 0))
    if cfg.masking:
        fx = fx * grid.umask
        fe1 = fe1 * grid.vmask
    fe = fe1 + cff * (shift(fx, 0, 1) + shift(fx, -1, 0)
                      - fx - shift(fx, -1, 1))
    fx2 = fx + cff * (shift(fe1, 1, 0) + shift(fe1, 0, -1)
                      - fe1 - shift(fe1, 1, -1))
    out = wrk + cff1 * (shift(fx2, 0, 1) - fx2 + shift(fe, 1, 0) - fe)
    if cfg.masking:
        out = out * grid.rmask
    return out


def _fill_phys_edges_2d(a, cfg: ModelConfig, grid=None):
    """Zero-gradient copy into the physical-edge ghost lines, to the full
    halo depth (reference: lmd_kpp.F:545-581 hbls padding).  Depth 2
    matters: the roll-based smoother reaches 2 cells past each output
    point, so the outer ghost line is read when smoothing the first
    interior row/column."""
    ow = oe = os_ = on = None
    if grid is not None:
        ow, oe, os_, on = grid.own_w, grid.own_e, grid.own_s, grid.own_n
    pe, pn = cfg.pad_e, cfg.pad_n
    if not cfg.ew_periodic:
        a = eset(a, (Ellipsis, slice(None), 1), a[..., :, 2], ow)
        a = eset(a, (Ellipsis, slice(None), 0), a[..., :, 2], ow)
        a = eset(a, (Ellipsis, slice(None), -2 - pe), a[..., :, -3 - pe], oe)
        a = eset(a, (Ellipsis, slice(None), -1 - pe), a[..., :, -3 - pe], oe)
    if not cfg.ns_periodic:
        a = eset(a, (Ellipsis, 1, slice(None)), a[..., 2, :], os_)
        a = eset(a, (Ellipsis, 0, slice(None)), a[..., 2, :], os_)
        a = eset(a, (Ellipsis, -2 - pn, slice(None)), a[..., -3 - pn, :], on)
        a = eset(a, (Ellipsis, -1 - pn, slice(None)), a[..., -3 - pn, :], on)
    return a


def _wscale_ws(zscale, bfsfc, ustar, hbl, rmask, cfg: ModelConfig):
    """Turbulent velocity scale ws (reference: src/lmd_wscale_ws_only.h)."""
    zscale = torch.minimum(zscale, hbl * EPSSFC)
    if cfg.masking:
        zscale = zscale * rmask
    zetahat = cfg.von_karman * zscale * bfsfc
    ustar3 = ustar ** 3
    ws_stable = cfg.von_karman * ustar * ustar3 / torch.clamp(
        ustar3 + 5.0 * zetahat, min=EPS_KPP)
    ws_unst = cfg.von_karman * torch.sqrt(torch.clamp(
        (ustar3 - 16.0 * zetahat) / torch.clamp(ustar, min=EPS_KPP), min=0.0))
    ws_conv = cfg.von_karman * _cbrt(A_S * ustar3 - C_S * zetahat)
    return torch.where(zetahat >= 0.0, ws_stable,
                       torch.where(zetahat > ZETA_S * ustar3, ws_unst,
                                   ws_conv))


def _wscale_wm_ws(zscale, bfsfc, ustar, hbl, rmask, cfg: ModelConfig):
    """Both wm and ws (reference: src/lmd_wscale_wm_and_ws.h)."""
    zscale = torch.minimum(zscale, hbl * EPSSFC)
    if cfg.masking:
        zscale = zscale * rmask
    zetahat = cfg.von_karman * zscale * bfsfc
    ustar3 = ustar ** 3
    w_stable = cfg.von_karman * ustar * ustar3 / torch.clamp(
        ustar3 + 5.0 * zetahat, min=EPS_KPP)
    wm_unst = cfg.von_karman * (torch.clamp(
        ustar * (ustar3 - 16.0 * zetahat), min=0.0)) ** 0.25
    wm_conv = cfg.von_karman * _cbrt(A_M * ustar3 - C_M * zetahat)
    ws_unst = cfg.von_karman * torch.sqrt(torch.clamp(
        (ustar3 - 16.0 * zetahat) / torch.clamp(ustar, min=EPS_KPP), min=0.0))
    ws_conv = cfg.von_karman * _cbrt(A_S * ustar3 - C_S * zetahat)
    wm = torch.where(zetahat >= 0.0, w_stable,
                     torch.where(zetahat > ZETA_M * ustar3, wm_unst, wm_conv))
    ws = torch.where(zetahat >= 0.0, w_stable,
                     torch.where(zetahat > ZETA_S * ustar3, ws_unst, ws_conv))
    return wm, ws


class VmixOut(NamedTuple):
    akv: torch.Tensor
    akt: torch.Tensor      # (n_akt, nz+1, ..)
    hbls: torch.Tensor
    hbbl: torch.Tensor
    ghat: torch.Tensor


def interior_mix(u, v, bvf, z_r, z_w, grid, cfg: ModelConfig):
    """Interior Kv/Kt/Ks at W-levels 1..N-1, smoothed Ri, bottom
    suppression, vertical smoothing + background, padded to 0..N
    (reference: lmd_vmix.F:150-404)."""
    nz = u.shape[0]
    dz_w = z_r[1:] - z_r[:-1]
    cffz = 0.5 / dz_w
    dudz = cffz * (u[1:] - u[:-1] + shift(u, 0, 1)[1:] - shift(u, 0, 1)[:-1])
    dvdz = cffz * (v[1:] - v[:-1] + shift(v, 1, 0)[1:] - shift(v, 1, 0)[:-1])
    rig = bvf[1:nz] / (RI0 * torch.clamp(dudz ** 2 + dvdz ** 2, min=1.0e-10))

    # SMOOTH_RIG: edge fill then isotropic smoothing per level
    rig = _fill_phys_edges_2d(rig, cfg, grid)
    cffs, cff1 = 1.0 / 12.0, 3.0 / 16.0
    fx = (rig - shift(rig, 0, -1))
    fe1 = (rig - shift(rig, -1, 0))
    if cfg.masking:
        fx = fx * grid.umask[None]
        fe1 = fe1 * grid.vmask[None]
    fe = fe1 + cffs * (shift(fx, 0, 1) + shift(fx, -1, 0)
                       - fx - shift(fx, -1, 1))
    fx2 = fx + cffs * (shift(fe1, 1, 0) + shift(fe1, 0, -1)
                       - fe1 - shift(fe1, 1, -1))
    rig = rig + cff1 * (shift(fx2, 0, 1) - fx2 + shift(fe, 1, 0) - fe)

    # shear instability + internal waves (+ convective adjustment)
    cffr = torch.clamp(rig, min=0.0, max=1.0)
    nu_sx = (1.0 - cffr * cffr) ** 3
    kv = NUWM + NU0M * nu_sx
    kt = NUWS + NU0S * nu_sx
    kv = torch.where(rig < 0.0, kv + NU0C, kv)   # LMD_CONVEC
    kt = torch.where(rig < 0.0, kt + NU0C, kt)
    ks = kt

    # suppress turbulence near the bottom (reference: lmd_vmix.F:364-378)
    dist = z_w[1:nz] - z_w[0][None]
    mult = torch.where(dist < LTURB,
                       torch.sin(0.5 * math.pi * dist / LTURB), 1.0)
    kv = kv * mult
    kt = kt * mult
    ks = ks * mult

    # pad top/bottom and vertically smooth with background added; the
    # reference loop is in-place ascending, so level k reads the already
    # smoothed k-1 (reference: lmd_vmix.F:396-404)
    def pad_smooth(kk, bak):
        top = kk[-1] + bak
        bot = kk[0] + bak
        full = [bot] + list(kk) + [top]
        out = [bot]
        prev = bot
        for k in range(1, nz):
            prev = 0.5 * full[k] + 0.25 * prev + 0.25 * full[k + 1] + bak
            out.append(prev)
        out.append(top)
        return torch.stack(out, dim=0)

    kv = pad_smooth(kv, cfg.akv_bak)
    kt = pad_smooth(kt, cfg.akt_bak)
    ks = pad_smooth(ks, cfg.akt_bak)
    return kv, kt, ks


def _at(a, idx):
    """a[idx[j, i], j, i]: the level gather of `jnp.take_along_axis`."""
    return torch.take_along_dim(a, idx[None], dim=0)[0]


def lmd_kpp(u, v, t, bvf, z_r, z_w, hz, kv, kt, ks, swrf, forcing,
            hbls_old, hbbl_old, grid, cfg: ModelConfig,
            first_step: bool) -> VmixOut:
    """KPP surface and bottom boundary layers overlaid on the interior
    coefficients (reference: lmd_kpp.F:153-651)."""
    nz = u.shape[0]
    g = cfg.g
    dev = u.device

    alpha, beta = alfabeta(t[:, nz - 1], cfg)
    Bo = g * (alpha * (forcing.stflx[cfg.itemp] - forcing.srflx))
    if cfg.salinity:
        Bo = Bo - g * beta * forcing.stflx[cfg.isalt]
    Bosol = g * alpha * forcing.srflx

    sustr, svstr = forcing.sustr, forcing.svstr
    ustar = torch.sqrt(torch.sqrt((1.0 / 3.0) * (
        sustr ** 2 + shift(sustr, 0, 1) ** 2 + sustr * shift(sustr, 0, 1)
        + svstr ** 2 + shift(svstr, 1, 0) ** 2 + svstr * shift(svstr, 1, 0))))

    hbl = hbls_old
    bbl = hbbl_old

    # ---- bulk Richardson integral FC at W-levels (INT_AT_RHO_POINTS,
    # reference: lmd_kpp.F:202-236) ---------------------------------------
    u_r = 0.5 * (u + shift(u, 0, 1))
    v_r = 0.5 * (v + shift(v, 1, 0))
    du2 = (2 * (u_r[1:] - u_r[:-1])) ** 2 + (2 * (v_r[1:] - v_r[:-1])) ** 2
    hz2 = hz[1:] + hz[:-1]
    cff_up = (z_w[nz][None] - z_w[1:nz]) ** 2
    cff_dn = (z_w[1:nz] - z_w[0][None]) ** 2
    kern = cff_up * cff_dn / ((cff_up + (EPSSFC * hbl[None]) ** 2)
                              * (cff_dn + (EPSSFC * bbl[None]) ** 2))
    incr = kern * (0.5 * du2 / hz2
                   - 0.5 * hz2 * (RI_INV * bvf[1:nz]
                                  + C_EK * (grid.f ** 2)[None]))
    # FC[k] = sum of incr from k..N-1 (downward cumulative), FC[N] = 0
    fc_body = torch.flip(torch.cumsum(torch.flip(incr, [0]), dim=0), [0])
    zero = torch.zeros_like(incr[:1])

    # FC(0): near-bottom kernel (reference: lmd_kpp.F:223-236)
    z_bl0 = z_w[0] + 0.25 * hz[0]
    cu0 = (z_w[nz] - z_bl0) ** 2
    cd0 = (z_bl0 - z_w[0]) ** 2
    kern0 = cu0 * cd0 / ((cu0 + (EPSSFC * hbl) ** 2)
                         * (cd0 + (EPSSFC * bbl) ** 2))
    fc0 = fc_body[0] + kern0 * (
        0.5 * ((2 * u_r[0]) ** 2 + (2 * v_r[0]) ** 2) / hz[0]
        - 0.5 * hz[0] * (RI_INV * bvf[1] + C_EK * grid.f ** 2))
    fc = torch.cat([fc0[None], fc_body, zero], dim=0)

    # ---- surface boundary layer depth (reference: lmd_kpp.F:238-275) ----
    cg, vtc = surface_constants(cfg)

    swdk_r = torch.sqrt(swrf[1:] * swrf[:-1])            # (nz, ..) at rho
    zscale_r = z_w[nz][None] - z_r
    bfsfc_r = Bo[None] + Bosol[None] * (1.0 - swdk_r)
    ws_r = _wscale_ws(zscale_r, bfsfc_r, ustar[None], hbl[None],
                      grid.rmask[None], cfg)
    bvf_below = bvf[0:nz]                                # bvf(k-1) at rho k
    vtsq = 1.8 * vtc * ws_r * torch.sqrt(torch.clamp(bvf_below, min=1.0e-5))
    cr_r = fc[1:] + vtsq                                 # Cr at k=1..N

    kidx = torch.arange(1, nz + 1, device=dev)[:, None, None]
    neg = cr_r < 0.0
    kbls = torch.amax(torch.where(neg, kidx, 0), dim=0)  # largest k, Cr<0
    # interpolate hbl between z_r(k) and z_r(k+1) (clamped gather)
    kb = torch.clamp(kbls, 1, nz)
    kb1 = torch.clamp(kb, 1, nz - 1)
    cr_k = _at(cr_r, kb - 1)
    cr_k1 = _at(cr_r, kb1)
    zr_k = _at(z_r, kb - 1)
    zr_k1 = _at(z_r, kb1)
    hbl_int = z_w[nz] - (zr_k * cr_k1 - zr_k1 * cr_k) / (cr_k1 - cr_k)
    hbl_top = z_w[nz] - z_r[nz - 1]
    hbl_new = torch.where(kbls == 0, z_w[nz] - z_w[0],
                          torch.where(kbls == nz, hbl_top, hbl_int))
    if cfg.masking:
        hbl_new = hbl_new * grid.rmask

    # ---- bottom boundary layer depth (reference: lmd_kpp.F:277-302) -----
    cr_b = fc[1:] - fc0[None]                            # k=1..N
    pos = cr_b > 0.0
    big = nz + 1
    kbbl = torch.amin(torch.where(pos, kidx, big), dim=0)  # smallest k, Cr>0
    kbb = torch.clamp(kbbl, 2, nz)
    crb_k = _at(cr_b, kbb - 1)
    crb_km1 = _at(cr_b, kbb - 2)
    zr_km1 = _at(z_r, kbb - 2)
    zr_kk = _at(z_r, kbb - 1)
    bbl_int = (zr_km1 * crb_k - zr_kk * crb_km1) / (crb_k - crb_km1) - z_w[0]
    bbl_new = torch.where(kbbl == big, z_w[nz] - z_w[0],
                          torch.where(kbbl == 1, z_r[0] - z_w[0], bbl_int))
    if cfg.masking:
        bbl_new = bbl_new * grid.rmask

    # ---- SMOOTH_HBL (reference: lmd_kpp.F:312-327) -----------------------
    hbl_new = _smooth2d(_fill_phys_edges_2d(hbl_new, cfg, grid), grid, cfg)
    bbl_new = _smooth2d(_fill_phys_edges_2d(bbl_new, cfg, grid), grid, cfg)

    if not first_step:   # time filter (reference: lmd_kpp.F:336-349)
        hbl_new = 0.5 * (hbl_new + hbls_old)
        bbl_new = 0.5 * (bbl_new + hbbl_old)

    # ---- surface-layer shape profile (reference: lmd_kpp.F:361-449) -----
    # kbls = smallest k in 1..N-1 with z_w(k) > z_w(N)-hbl, else N
    z_bl = z_w[nz] - hbl_new
    above = z_w[1:nz] > z_bl[None]
    kk = torch.arange(1, nz, device=dev)[:, None, None]
    kbls2 = torch.amin(torch.where(above, kk, nz), dim=0)

    # Bfsfc at the boundary layer depth (reference: lmd_kpp.F:380-397)
    swk = _at(swrf, kbls2)
    swkm1 = _at(swrf, kbls2 - 1)
    zwk = _at(z_w, kbls2)
    zwkm1 = _at(z_w, kbls2 - 1)
    bfs_interp = Bo + Bosol * (1.0 - swkm1 * swk * (zwk - zwkm1)
                               / (swk * (zwk - z_bl)
                                  + swkm1 * (z_bl - zwkm1)))
    bfsfc_bl = torch.where(swkm1 > 0.0, bfs_interp, Bo + Bosol)

    # velocity scales and shape function at every W-level
    zscale_w = z_w[nz][None] - z_w
    wm_w, ws_w = _wscale_wm_ws(zscale_w, bfsfc_bl[None], ustar[None],
                               hbl_new[None], grid.rmask[None], cfg)
    ssgm = (z_w[nz][None] - z_w) / torch.clamp(hbl_new, min=EPS_KPP)[None]
    cff_bl = torch.where(ssgm < 0.07, 0.5 * (ssgm - 0.07) ** 2 / 0.07, 0.0)
    cff_bl = cff_bl + ssgm * (1.0 - ssgm) ** 2
    amp = ssgm ** 2
    in_bl = ssgm < 1.0
    kv_new = torch.where(in_bl, torch.sqrt(
        (amp * kv) ** 2 + (wm_w * hbl_new[None] * cff_bl) ** 2), kv)
    kt_new = torch.where(in_bl, torch.sqrt(
        (amp * kt) ** 2 + (ws_w * hbl_new[None] * cff_bl) ** 2), kt)
    ks_new = torch.where(in_bl, torch.sqrt(
        (amp * ks) ** 2 + (ws_w * hbl_new[None] * cff_bl) ** 2), ks)
    ghat = torch.where(in_bl & (bfsfc_bl[None] < 0.0),
                       -cg * ssgm * (1.0 - ssgm) ** 2, 0.0)

    # ---- bottom boundary layer profile (reference: lmd_kpp.F:452-497) ---
    su0 = shift(u, 0, 1)[0]
    sv0 = shift(v, 1, 0)[0]
    wmb = cfg.von_karman ** 2 * torch.sqrt((1.0 / 3.0) * (
        u[0] ** 2 + su0 ** 2 + u[0] * su0 + v[0] ** 2 + sv0 ** 2 + v[0] * sv0
    )) / torch.log(1.0 + 0.5 * hz[0] / cfg.zob)
    sgmb = (z_w - z_w[0][None] + cfg.zob) / (bbl_new[None] + cfg.zob)
    cff1b = sgmb * (1.0 - sgmb) ** 2
    in_bbl = sgmb < 1.0
    bot = (wmb[None] * bbl_new[None] * cff1b) ** 2
    kv_new = torch.where(in_bbl, torch.sqrt(kv_new ** 2 + bot), kv_new)
    kt_new = torch.where(in_bbl, torch.sqrt(kt_new ** 2 + bot), kt_new)
    ks_new = torch.where(in_bbl, torch.sqrt(ks_new ** 2 + bot), ks_new)

    # ---- finalize under mask (reference: lmd_kpp.F:500-536) --------------
    if cfg.masking:
        water = grid.rmask[None] > 0.5
        kv_new = torch.where(water, kv_new, 0.0)
        kt_new = torch.where(water, kt_new, 0.0)
        ks_new = torch.where(water, ks_new, 0.0)

    hbls = _fill_phys_edges_2d(hbl_new, cfg, grid)
    hbbl = _fill_phys_edges_2d(bbl_new, cfg, grid)
    akt = torch.stack([kt_new, ks_new]) if cfg.salinity else kt_new[None]
    return VmixOut(akv=kv_new, akt=akt, hbls=hbls, hbbl=hbbl, ghat=ghat)
