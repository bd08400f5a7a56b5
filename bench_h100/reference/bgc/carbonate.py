"""Full seawater CO2-system solver, OCMIP co2calc grade (port of
roms_tpu/bgc/carbonate.py; reference: src/bec2_driver.F:3801-4133
co2calc_row, :4141-4246 talk_row, :4249-4382 drtsafe_row).

Every function works on whole fields.  The bracketed Newton for [H+] runs
a FIXED number of iterations as a plain Python loop: no early exit and no
branch on a tensor's value, so the host never waits on the device and the
arithmetic is the JAX package's step for step (its `lax.scan`).  25
safeguarded iterations from the closed-form seed reach the reference's
1e-10 tolerance everywhere in the oceanographic range.

The constants are the published formulations named in the reference's
comments (Weiss 1974 K0; Weiss & Price 1980 fugacity ff; Millero 1995
K1/K2, KW; Dickson 1990 KB, KS; DOE 1994 K1P/K2P/K3P; Yao & Millero 1995
KSi; Dickson & Riley 1979 KF; Uppström 1974 BT; Morris & Riley 1966 ST;
Riley 1965 FT; Mucci 1983 Ksp).  Units follow the reference: tracer
inputs in mmol/m3 (converted to mol/kg with rho_sw = 4.1/3.996), pCO2 in
uatm.  The card runs the model dtype throughout, as the JAX package does
on its chip.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

RHO_SW = 4.1 / 3.996            # (reference: bec2_driver.F:3814)
MASS_TO_VOL = 1.0e6 * RHO_SW    # mol/kg -> mmol/m3
VOL_TO_MASS = 1.0 / MASS_TO_VOL
T0_KELVIN = 273.16


class CO2Consts(NamedTuple):
    ff: torch.Tensor    # CO2 solubility incl. fugacity/water vapour
    k0: torch.Tensor    # CO2 solubility (Weiss 1974)
    k1: torch.Tensor
    k2: torch.Tensor
    kw: torch.Tensor
    kb: torch.Tensor
    ks: torch.Tensor
    kf: torch.Tensor
    k1p: torch.Tensor
    k2p: torch.Tensor
    k3p: torch.Tensor
    ksi: torch.Tensor
    bt: torch.Tensor    # total borate [mol/kg]
    st: torch.Tensor    # total sulfate
    ft: torch.Tensor    # total fluoride


def constants(temp, salt) -> CO2Consts:
    """Equilibrium constants and totals at (SST degC, SSS psu), surface
    pressure (reference: bec2_driver.F:3915-4060)."""
    s = torch.clamp(salt, 1.0e-4, 45.0)
    tk = T0_KELVIN + temp
    tk100 = tk * 1e-2
    tk1002 = tk100 * tk100
    invtk = 1.0 / tk
    dlogtk = torch.log(tk)
    ion = 19.924 * s / (1000.0 - 1.005 * s)
    ion2 = ion * ion
    sqrtis = torch.sqrt(ion)
    sqrts = torch.sqrt(s)
    s15 = s * sqrts
    s2 = s * s
    scl = s / 1.80655

    ff = torch.exp(-162.8301 + 218.2968 / tk100 + 90.9241 * torch.log(tk100)
                   - 1.47696 * tk1002
                   + s * (0.025695 - 0.025225 * tk100 + 0.0049867 * tk1002))
    k0 = torch.exp(93.4517 / tk100 - 60.2409 + 23.3585 * torch.log(tk100)
                   + s * (0.023517 - 0.023656 * tk100 + 0.0047036 * tk1002))
    k1 = 10.0 ** (-(3670.7 * invtk - 62.008 + 9.7944 * dlogtk
                    - 0.0118 * s + 0.000116 * s2))
    k2 = 10.0 ** (-(1394.7 * invtk + 4.777 - 0.0184 * s + 0.000118 * s2))
    kb = torch.exp((-8966.90 - 2890.53 * sqrts - 77.942 * s
                    + 1.728 * s15 - 0.0996 * s2) * invtk
                   + (148.0248 + 137.1942 * sqrts + 1.62142 * s)
                   + (-24.4344 - 25.085 * sqrts - 0.2474 * s) * dlogtk
                   + 0.053105 * sqrts * tk)
    k1p = torch.exp(-4576.752 * invtk + 115.525 - 18.453 * dlogtk
                    + (-106.736 * invtk + 0.69171) * sqrts
                    + (-0.65643 * invtk - 0.01844) * s)
    k2p = torch.exp(-8814.715 * invtk + 172.0883 - 27.927 * dlogtk
                    + (-160.340 * invtk + 1.3566) * sqrts
                    + (0.37335 * invtk - 0.05778) * s)
    k3p = torch.exp(-3070.75 * invtk - 18.141
                    + (17.27039 * invtk + 2.81197) * sqrts
                    + (-44.99486 * invtk - 0.09984) * s)
    ksi = torch.exp(-8904.2 * invtk + 117.385 - 19.334 * dlogtk
                    + (-458.79 * invtk + 3.5913) * sqrtis
                    + (188.74 * invtk - 1.5998) * ion
                    + (-12.1652 * invtk + 0.07871) * ion2
                    + torch.log(1.0 - 0.001005 * s))
    kw = torch.exp(-13847.26 * invtk + 148.9652 - 23.6521 * dlogtk
                   + (118.67 * invtk - 5.977 + 1.0495 * dlogtk) * sqrts
                   - 0.01615 * s)
    ks = torch.exp(-4276.1 * invtk + 141.328 - 23.093 * dlogtk
                   + (-13856.0 * invtk + 324.57 - 47.986 * dlogtk) * sqrtis
                   + (35474.0 * invtk - 771.54 + 114.723 * dlogtk) * ion
                   - 2698.0 * invtk * ion * sqrtis + 1776.0 * invtk * ion2
                   + torch.log(1.0 - 0.001005 * s))
    kf = torch.exp(1590.2 * invtk - 12.641 + 1.525 * sqrtis
                   + torch.log(1.0 - 0.001005 * s)
                   + torch.log(1.0 + (0.1400 / 96.062) * scl / ks))
    bt = 0.000232 * scl / 10.811
    st = 0.14 * scl / 96.062
    ft = 0.000067 * scl / 18.9984
    return CO2Consts(ff=ff, k0=k0, k1=k1, k2=k2, kw=kw, kb=kb, ks=ks,
                     kf=kf, k1p=k1p, k2p=k2p, k3p=k3p, ksi=ksi,
                     bt=bt, st=st, ft=ft)


def ta_residual(h, dic, ta, pt, sit, c: CO2Consts):
    """Total-alkalinity balance f(H) and df/dH, all in mol/kg
    (reference: bec2_driver.F talk_row:4141-4246 —
    fn = hco3 + 2co3 + borate + oh + hpo4 + 2po4 + silicate
         − hfree − hso4 − hf − h3po4 − ta)."""
    x1 = h
    x2 = x1 * x1
    x3 = x2 * x1
    k12 = c.k1 * c.k2
    k12p = c.k1p * c.k2p
    k123p = k12p * c.k3p
    a = x3 + c.k1p * x2 + k12p * x1 + k123p
    a2 = a * a
    da = 3.0 * x2 + 2.0 * c.k1p * x1 + k12p
    b = x2 + c.k1 * x1 + k12
    b2 = b * b
    db = 2.0 * x1 + c.k1
    cc = 1.0 + c.st / c.ks

    fn = (c.k1 * x1 * dic / b
          + 2.0 * dic * k12 / b
          + c.bt / (1.0 + x1 / c.kb)
          + c.kw / x1
          + pt * k12p * x1 / a
          + 2.0 * pt * k123p / a
          + sit / (1.0 + x1 / c.ksi)
          - x1 / cc
          - c.st / (1.0 + c.ks / (x1 / cc))
          - c.ft / (1.0 + c.kf / x1)
          - pt * x3 / a
          - ta)
    df = ((c.k1 * dic * b - c.k1 * x1 * dic * db) / b2
          - 2.0 * dic * k12 * db / b2
          - c.bt / c.kb / (1.0 + x1 / c.kb) ** 2
          - c.kw / x2
          + pt * k12p * (a - x1 * da) / a2
          - 2.0 * pt * k123p * da / a2
          - sit / c.ksi / (1.0 + x1 / c.ksi) ** 2
          - 1.0 / cc
          + c.st * (1.0 + c.ks / (x1 / cc)) ** (-2) * (c.ks * cc / x2)
          + c.ft * (1.0 + c.kf / x1) ** (-2) * c.kf / x2
          - pt * x2 * (3.0 * a - x1 * da) / a2)
    return fn, df


def solve_h(dic, ta, pt, sit, c: CO2Consts, h_init=None,
            ph_lo: float = 5.0, ph_hi: float = 10.0, iters: int = 25):
    """Safeguarded Newton for [H+] (total scale, mol/kg), the `drtsafe`
    analog with a fixed iteration count (reference:
    bec2_driver.F:4249-4382).

    Keeps the bracket [lo, hi]; a Newton step that leaves it is replaced
    by bisection, so the solve converges for any oceanographic input.
    h_init seeds Newton (the closed-form carbonate-alkalinity solution);
    the default is the bracket's midpoint in log space."""
    shape = torch.broadcast_shapes(dic.shape, ta.shape, c.k1.shape)
    dtype = torch.promote_types(torch.promote_types(dic.dtype, ta.dtype),
                                c.k1.dtype)
    lo = torch.full(shape, 10.0 ** (-ph_hi), dtype=dtype, device=dic.device)
    hi = torch.full(shape, 10.0 ** (-ph_lo), dtype=dtype, device=dic.device)
    f_lo, _ = ta_residual(lo, dic, ta, pt, sit, c)
    # the residual decreases in H, so f(lo) > 0 > f(hi); [lo, hi] is the
    # H-interval and the signs are tracked explicitly
    if h_init is None:
        h = torch.sqrt(lo * hi)
    else:
        h = torch.minimum(torch.maximum(h_init, lo), hi)
    for _ in range(iters):
        fn, df = ta_residual(h, dic, ta, pt, sit, c)
        # shrink the bracket by the sign of fn relative to f(lo)
        same_side = (fn * f_lo) > 0.0
        lo = torch.where(same_side, h, lo)
        hi = torch.where(same_side, hi, h)
        h_newton = h - fn / torch.where(torch.abs(df) > 0.0, df, 1.0)
        inside = (h_newton > lo) & (h_newton < hi)
        h = torch.where(inside, h_newton, 0.5 * (lo + hi))
    return h


class CO2Solution(NamedTuple):
    h: torch.Tensor          # [H+] total scale [mol/kg]
    ph: torch.Tensor
    co2star: torch.Tensor    # [mmol/m3]
    hco3: torch.Tensor       # [mmol/m3]
    co3: torch.Tensor        # [mmol/m3]
    pco2: torch.Tensor       # oceanic pCO2 [uatm]
    omega_ca: torch.Tensor   # calcite saturation state
    omega_ar: torch.Tensor   # aragonite saturation state
    k0ff: torch.Tensor       # solubility ff [mol/kg/atm] for the flux


def _ksp_mucci(temp, salt):
    """Calcite/aragonite stoichiometric solubility products, Mucci (1983)
    [mol/kg]^2 (surface pressure)."""
    tk = T0_KELVIN + temp
    s = torch.clamp(salt, 1.0e-4, 45.0)
    sqrts = torch.sqrt(s)
    log10tk = torch.log10(tk)
    lk_ca = (-171.9065 - 0.077993 * tk + 2839.319 / tk + 71.595 * log10tk
             + (-0.77712 + 0.0028426 * tk + 178.34 / tk) * sqrts
             - 0.07711 * s + 0.0041249 * s * sqrts)
    lk_ar = (-171.945 - 0.077993 * tk + 2903.293 / tk + 71.595 * log10tk
             + (-0.068393 + 0.0017276 * tk + 88.135 / tk) * sqrts
             - 0.10018 * s + 0.0059415 * s * sqrts)
    return 10.0 ** lk_ca, 10.0 ** lk_ar


def co2_system(dic_mmol, ta_mmol, temp, salt, po4_mmol=None, sio3_mmol=None,
               h_init=None, iters: int = 25) -> CO2Solution:
    """Solve the full CO2 system from DIC and total alkalinity [mmol/m3]
    and surface T/S, with optional phosphate/silicate contributions (the
    reference passes the PO4/SiO3 tracers, bec2_driver.F:448-456).

    Returns concentrations in mmol/m3 and pCO2 in uatm."""
    c = constants(temp, salt)
    dic = torch.clamp(dic_mmol, min=1.0) * VOL_TO_MASS
    ta = torch.clamp(ta_mmol, min=1.0) * VOL_TO_MASS
    pt = (torch.clamp(po4_mmol, min=0.0) * VOL_TO_MASS
          if po4_mmol is not None else torch.zeros_like(dic))
    sit = (torch.clamp(sio3_mmol, min=0.0) * VOL_TO_MASS
           if sio3_mmol is not None else torch.zeros_like(dic))

    h = solve_h(dic, ta, pt, sit, c, h_init=h_init, iters=iters)

    h2 = h * h
    denom = h2 + c.k1 * h + c.k1 * c.k2
    co2star = dic * h2 / denom
    hco3 = dic * c.k1 * h / denom
    co3 = dic * c.k1 * c.k2 / denom
    # oceanic pCO2 through the fugacity-corrected solubility, as the
    # reference outputs it (bec2_driver.F:4104-4110 pco2oc = co2star/ff)
    pco2 = co2star / c.ff * 1.0e6

    ksp_ca, ksp_ar = _ksp_mucci(temp, salt)
    ca = 0.010285 * torch.clamp(salt, 1.0e-4, 45.0) / 35.0   # mol/kg
    omega_ca = ca * co3 / ksp_ca
    omega_ar = ca * co3 / ksp_ar

    return CO2Solution(h=h, ph=-torch.log10(h),
                       co2star=co2star * MASS_TO_VOL,
                       hco3=hco3 * MASS_TO_VOL,
                       co3=co3 * MASS_TO_VOL,
                       pco2=pco2,
                       omega_ca=omega_ca, omega_ar=omega_ar,
                       k0ff=c.ff)


def co2_flux(dic_mmol, ta_mmol, temp, salt, kw_piston, pco2_air_uatm,
             po4_mmol=None, sio3_mmol=None, atm_pres: float = 1.0,
             h_init=None, iters: int = 25):
    """Air-sea CO2 flux [mmol/m2/s, positive into the ocean] from the
    full-system solve: FG = kw * (co2star_air - co2star_oc) with
    co2star_air = xco2 * ff * atmpres (reference: bec2_driver.F:4094-4101
    dco2star; flux formation at :457-470)."""
    sol = co2_system(dic_mmol, ta_mmol, temp, salt, po4_mmol, sio3_mmol,
                     h_init=h_init, iters=iters)
    co2star_air = (pco2_air_uatm * 1.0e-6) * sol.k0ff * atm_pres \
        * MASS_TO_VOL
    return kw_piston * (co2star_air - sol.co2star), sol
