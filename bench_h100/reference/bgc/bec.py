"""Reduced-BEC ecosystem at the reference's tracer counts (port of
roms_tpu/bgc/bec.py).

Registered variants built from one parameterized rate function:

  * ``bec2``      — the 29-tracer BEC2 + Ncycle_SY tracer set of the
    reference's built-in ecosystem (reference: src/bec2_driver.F
    ecosys_bec2_tile, tests/CDR_parameterized/tracers.opt,
    src/bgc_tracers_indx.opt, src/param.opt:26-30);
  * ``bec2_base`` — BEC2 without Ncycle_SY, 26 tracers (the
    tests/bgc_real cppdefs_BEC.opt configuration);
  * ``marbl32``   — the 32-tracer MARBL-standard set the reference couples
    through libmarbl (reference: src/marbl_driver.F:1210-1329).

The science is the JAX package's reduced, conservative BEC-style model:
three phytoplankton groups (small phyto with CaCO3, diatoms with Si,
diazotrophs), one zooplankton, semi-labile and refractory DOM, O2, the
full carbonate system with air-sea CO2/O2 exchange, iron with deposition
and scavenging, and the Ncycle nitrification/denitrification chain.
Particulate export runs through ballast-model sinking pools (POC with
N/P/Fe riders, CaCO3, SiO2), each a soft and a hard fraction with its own
attenuation length (reference: the P_* sinking particulate types,
src/bec2_vars.F:100-140).

The sinking pools are the only serial part: a sweep over levels from the
surface down.  All twelve sweeps of one interior call (six pools, two
fractions each) take their inputs from the production fields and Hz
alone, so they are stacked along a leading axis with one length each and
share one loop over nz (`_attenuation_column`).  The tendency additions
wait for the sweep and are applied in the JAX package's order, so the
arithmetic of every element is the JAX package's.
"""

from __future__ import annotations

import warnings
from typing import Tuple

import numpy as np
import torch

from bench_h100.reference.bgc import carbonate
from bench_h100.reference.bgc.api import BGCContext, BGCModel, register

# ---- tracer sets ----------------------------------------------------------

BEC2_TRACERS = (
    "PO4", "NO3", "SiO3", "NH4", "Fe", "O2", "DIC", "Alk",
    "DOC", "DON", "DOFE", "DOP", "DOPR", "DONR",
    "ZOOC", "SPC", "SPCHL", "SPFE", "SPCACO3",
    "DIATC", "DIATCHL", "DIATFE", "DIATSI",
    "DIAZC", "DIAZCHL", "DIAZFE",
    "NO2", "N2", "N2O")

MARBL_TRACERS = (
    "PO4", "NO3", "SiO3", "NH4", "Fe", "Lig", "O2",
    "DIC", "DIC_ALT_CO2", "ALK", "ALK_ALT_CO2",
    "DOC", "DON", "DOP", "DOPr", "DONr", "DOCr",
    "zooC", "spChl", "spC", "spP", "spFe", "spCaCO3",
    "diatChl", "diatC", "diatP", "diatFe", "diatSi",
    "diazChl", "diazC", "diazP", "diazFe")

# ---- stoichiometry and rates (BEC lineage, reference: src/bec2_params.F)
Q_CN = 16.0 / 117.0        # mol N / mol C (Redfield, BEC C117)
Q_CP = 1.0 / 117.0         # mol P / mol C
Q_FE = 3.0e-6              # mol Fe / mol C
Q_SI = 0.137               # mol Si / mol C (diatoms)
O2_PER_C = 1.45            # mol O2 per mol C fixed
DAY = 86400.0

PAR_FRAC = 0.45
RHO0_CP = 1027.5 * 3985.0

# per-group parameters: (mu_max [1/d], alpha_chl, kNO3, kNH4, kPO4, kFe,
# kSiO3, theta_max [mg Chl/mmol C], loss [1/d], agg [1/(mmol C/m3 d)])
GROUPS = {
    "sp":   (3.0, 0.35, 0.25, 0.01, 0.01, 0.03e-3, 0.0, 2.5, 0.12, 0.01),
    "diat": (3.3, 0.28, 0.50, 0.05, 0.05, 0.06e-3, 1.0, 3.0, 0.12, 0.02),
    "diaz": (1.2, 0.39, 1.00, 0.15, 0.02, 0.04e-3, 0.0, 2.5, 0.15, 0.01),
}
GRAZE_MAX = {"sp": 3.3, "diat": 3.15, "diaz": 1.2}    # [1/d]
K_GRAZE = 1.05              # [mmol C/m3]
Z_EFF = 0.3                 # zoo growth efficiency
Z_LOSS = 0.1                # zoo linear loss [1/d]
Z_LOSS2 = 0.4               # zoo quadratic loss [1/(mmol C/m3 d)]
DOM_FRAC = 0.34             # routed to semi-labile DOM
DOC_REMIN = 1.0 / 100.0     # [1/d] semi-labile DOM remin
DOR_REMIN = 1.0 / 10000.0   # [1/d] refractory
DOR_FRAC = 0.02             # fraction of remin routed to refractory pools
CACO3_FRAC = 0.07           # CaCO3 production / sp photosynthesis
CACO3_DISS = 1.0 / 30.0     # [1/d] of the SPCACO3 pool
FE_SCAV = 1.0 / 180.0       # [1/d] free-iron scavenging
DUST_TO_FE = 0.035 * 1.0e6 / 55.85  # kg dust/m2/s -> mmol Fe/m2/s
NITRIF1 = 1.0 / 15.0        # NH4 -> NO2 [1/d]
NITRIF2 = 1.0 / 7.0         # NO2 -> NO3 [1/d]
PAR_NITRIF_INHIB = 1.0      # W/m2 threshold (photoinhibition)
O2_SUBOXIC = 4.0            # [mmol/m3]
DENITR = 1.0 / 20.0         # suboxic NO3->NO2->N2O->N2 chain [1/d]
N2O_YIELD = 0.06
LIG_PROD = 5.0e-5           # ligand production per remin C
LIG_LOSS = 1.0 / 1000.0     # [1/d]
Q10 = 1.7
EPS = 1.0e-30


def _tfunc(temp):
    return Q10 ** ((temp - 30.0) / 10.0)


def _par(ctx: BGCContext, forc):
    """PAR [W/m2] at rho levels from the model's penetrative solar
    profile; the DAILYPAR variants use the low-frequency swrad
    climatology when present (reference: bgc.opt nc_swrad_avg)."""
    if forc is not None and "swrad_LFreq" in forc:
        sw = forc["swrad_LFreq"][None]          # already W/m2
    else:
        sw = ctx.srflx[None] * RHO0_CP
    frac_r = 0.5 * (ctx.swr_frac[1:] + ctx.swr_frac[:-1])
    return PAR_FRAC * torch.clamp(sw, min=0.0) * frac_r


# ---- carbonate system ------------------------------------------------------

def _co2_equilibrium(dic, alk, temp, salt):
    """Closed-form seawater CO2 system from DIC and carbonate alkalinity
    (Weiss 1974 K0, Lueker et al. 2000 K1/K2): the seed of the full
    solve.  dic/alk in mmol/m3; returns (pco2 [uatm], ph, co2star
    [mmol/m3])."""
    tk = temp + 273.15
    tk100 = tk / 100.0
    s = torch.clamp(salt, 1.0, 45.0)
    lnk0 = (-60.2409 + 93.4517 / tk100 + 23.3585 * torch.log(tk100)
            + s * (0.023517 - 0.023656 * tk100 + 0.0047036 * tk100 ** 2))
    k0 = torch.exp(lnk0)                     # mol/kg/atm
    pk1 = (3633.86 / tk - 61.2172 + 9.6777 * torch.log(tk)
           - 0.011555 * s + 0.0001152 * s * s)
    pk2 = (471.78 / tk + 25.929 - 3.16967 * torch.log(tk)
           - 0.01781 * s + 0.0001122 * s * s)
    k1 = 10.0 ** (-pk1)
    k2 = 10.0 ** (-pk2)

    # mmol/m3 -> mol/kg (rho ~ 1025); carbonate alkalinity ~ 96 % of the
    # total (borate correction)
    c = dic * 1.0e-3 / 1025.0
    a = torch.clamp(alk * 1.0e-3 / 1025.0 * 0.96, min=1.0e-6)
    c = torch.clamp(c, min=1.0e-6)

    # CA = [HCO3] + 2[CO3]; DIC = [CO2*] + [HCO3] + [CO3]; with x = [H+]
    # the standard quadratic (Follows et al. 2006)
    g = c / a
    disc = ((1.0 - g) * (1.0 - g) * k1 * k1
            - 4.0 * k1 * k2 * (1.0 - 2.0 * g))
    h = 0.5 * ((g - 1.0) * k1 + torch.sqrt(torch.clamp(disc, min=0.0)))
    h = torch.clamp(h, min=1.0e-12)
    co2star = c * h * h / (h * h + k1 * h + k1 * k2)  # mol/kg
    pco2 = co2star / k0 * 1.0e6                        # uatm
    ph = -torch.log10(h)
    return pco2, ph, co2star * 1025.0 * 1.0e3          # mmol/m3


def o2_saturation(temp, salt):
    ts = torch.log(torch.clamp((298.15 - temp) / (273.15 + temp), min=1e-6))
    a = (2.00907 + 3.22014 * ts + 4.05010 * ts ** 2 + 4.94457 * ts ** 3
         - 0.256847 * ts ** 4 + 3.88767 * ts ** 5)
    b = salt * (-6.24523e-3 - 7.37614e-3 * ts - 1.03410e-2 * ts ** 2
                - 8.17083e-3 * ts ** 3) - 4.88682e-7 * salt * salt
    return torch.exp(a + b) * 44.6596  # ml/L fit -> mmol/m3


# Wanninkhof-style gas transfer (reference: bec2_driver.F:107 a=8.6e-7 s/m;
# XKW = a*ws^2 at :194; PV = XKW * sqrt(660/Sc))
XKW_COEFF = 8.6e-7   # [s/m]
SC_REF = 660.0


def schmidt_o2(temp):
    """Schmidt number of O2(SST) (reference: bec2_driver.F CSCHMIDT_O2,
    Keeling et al. 1998)."""
    return 1638.0 + temp * (-81.83 + temp * (1.483 + temp * (-0.008004)))


def schmidt_co2(temp):
    """Schmidt number of CO2(SST) (reference: bec2_driver.F CSCHMIDT_CO2,
    Wanninkhof 1992)."""
    return 2073.1 + temp * (-125.62 + temp * (3.6276 + temp * (-0.043219)))


def wind_speed_from_stress(sustr_r, svstr_r, rho0):
    """10 m wind speed from the kinematic stress at rho points: invert
    ustar^2 = ws*(c1 + ws*(c2 + ws*c3)) with 3 Newton iterations from a
    constant-Cd guess (reference: bec2_driver.F:3228-3322 WS())."""
    rho_air = 1.2
    c1, c2, c3, cd = 0.0027, 0.000142, 0.0000764, 1.7e-3
    ust2 = torch.sqrt(sustr_r ** 2 + svstr_r ** 2) * rho0 / rho_air
    ws = torch.sqrt(ust2 / cd)
    for _ in range(3):
        f = ws * (c1 + ws * (c2 + ws * c3)) - ust2
        fp = c1 + ws * (2.0 * c2 + ws * 3.0 * c3)
        ws = ws - f / torch.clamp(fp, min=1e-12)
    return torch.clamp(ws, min=0.0)


def gas_transfer_velocity(ws, schmidt):
    """Piston velocity kw = a*ws^2*sqrt(660/Sc) [m/s]."""
    return XKW_COEFF * ws * ws * torch.sqrt(
        SC_REF / torch.clamp(schmidt, min=1.0))


# ---- sinking particulate pools (ballast model) -----------------------------
#
# Each class is a two-fraction exponential attenuation: the soft fraction
# remineralizes with the class's dissolution length, the hard fraction
# sinks with an effectively conservative length and remineralizes at the
# sea floor; exactly conservative per column (reference: bec2_vars.F:100-140,
# Armstrong et al. 2002 as used by Moore et al. 2004).
# (soft dissolution length [m], hard fraction, hard length [m])
PART_POC = (130.0, 0.03, 40000.0)
PART_CACO3 = (600.0, 0.55, 40000.0)
PART_SIO2 = (220.0, 0.37, 40000.0)
PART_DUST = (600.0, 0.97, 40000.0)


def _attenuation_column(prod, hz, lengths):
    """Downward flux and per-cell absorption of stacked sinking pools.

    prod: (npool, nz, ..) volumetric production [conc/s], k=0 bottom;
    lengths: one attenuation length per pool.  One sweep over the levels,
    from the surface down, serves every pool.  Returns (remin (npool, nz,
    ..) [conc*m/s per cell, not yet divided by hz], flux (npool, nz+1, ..)
    downward flux at W-interfaces with flux[:, nz] = 0 at the surface,
    f_bot (npool, ..) the flux through the sea floor)."""
    npool, nz = prod.shape[:2]
    length = torch.tensor(lengths, dtype=prod.dtype, device=prod.device)
    length = length.reshape((npool,) + (1,) * (prod.dim() - 1))
    pdz = prod * hz[None]
    att = torch.exp(-hz[None] / length)
    remin = torch.empty_like(prod)
    flux = torch.zeros((npool, nz + 1) + tuple(prod.shape[2:]),
                       dtype=prod.dtype, device=prod.device)
    f = flux[:, nz]
    for k in range(nz - 1, -1, -1):
        above = f + pdz[:, k]
        torch.mul(above, att[:, k], out=flux[:, k])
        torch.sub(above, flux[:, k], out=remin[:, k])
        f = flux[:, k]
    return remin, flux, f


def particulate_fluxes(prods, hz, klasses):
    """Two-fraction ballast-model column solves of several particulate
    classes in one sweep: [(remin [conc/s per cell], flux_w (nz+1, ..)
    total downward interface flux [conc*m/s], f_bot (..) sea-floor flux)]
    per (production, class) pair.  The sea-floor flux is also
    remineralized into the bottom cell of `remin`, so the column integral
    of remin equals that of prod."""
    pools, lengths = [], []
    for prod, (soft_len, hard_frac, hard_len) in zip(prods, klasses):
        pools += [prod * (1.0 - hard_frac), prod * hard_frac]
        lengths += [soft_len, hard_len]
    r, f, b = _attenuation_column(torch.stack(pools), hz, lengths)
    hz_c = torch.clamp(hz, min=1e-12)
    out = []
    for i in range(len(prods)):
        remin = r[2 * i] + r[2 * i + 1]
        f_bot = b[2 * i] + b[2 * i + 1]
        remin[0] += f_bot                 # sea-floor remineralization
        out.append((remin / hz_c, f[2 * i] + f[2 * i + 1], f_bot))
    return out


def particulate_flux(prod, hz, klass):
    """`particulate_fluxes` of one class (roms_tpu/bgc/bec.py's
    `particulate_flux`)."""
    return particulate_fluxes([prod], hz, [klass])[0]


def make_interior(names: Tuple[str, ...]):
    idx = {n.upper(): i for i, n in enumerate(names)}
    has = lambda n: n.upper() in idx   # noqa: E731
    I = lambda n: idx[n.upper()]       # noqa: E731,E741
    ncycle = has("NO2")
    marbl = has("LIG")

    def kernel(trc, ctx: BGCContext, saved, forc=None):
        """Shared rate function: returns (tendencies, diagnostics dict)."""
        def get(n):
            return torch.clamp(trc[I(n)], min=0.0)

        po4, no3, sio3, nh4, fe = (get("PO4"), get("NO3"), get("SiO3"),
                                   get("NH4"), get("Fe"))
        o2 = get("O2")
        doc, don, dop = get("DOC"), get("DON"), get("DOP")
        zoo = get("ZOOC")
        tf = _tfunc(ctx.temp)
        par = _par(ctx, forc)

        diags = {"PAR": par}
        # tendency additions in order; a callable stands for a value the
        # particulate sweep has not produced yet
        adds = []

        def add(n, v):
            adds.append((I(n), v))

        def clampt(x, lo):
            return torch.clamp(x, min=lo)

        zero = torch.zeros_like(po4)
        photo_tot = zero        # total C fixation [mmolC/m3/s]
        no3_up = zero
        nh4_up = zero
        nfix = zero
        graze_tot = zero
        loss_poc = zero         # -> implicit particulates
        loss_pon = zero
        loss_pop = zero
        loss_pofe = zero
        loss_posi = zero
        dom_c = zero
        sinking = []            # (production, class) of the sweep
        ca = None

        for g in ("sp", "diat", "diaz"):
            cn = {"sp": "SPC", "diat": "DIATC", "diaz": "DIAZC"}[g]
            chn = {"sp": "SPCHL", "diat": "DIATCHL", "diaz": "DIAZCHL"}[g]
            fen = {"sp": "SPFE", "diat": "DIATFE", "diaz": "DIAZFE"}[g]
            (mu0, alpha, kno3, knh4, kpo4, kfe, ksi, th_max, mort,
             agg) = GROUPS[g]
            c = get(cn)
            chl = get(chn)
            cfe = get(fen)

            # nutrient limitation (Liebig minimum, BEC style)
            vno3 = (no3 / kno3) / (1.0 + no3 / kno3 + nh4 / knh4)
            vnh4 = (nh4 / knh4) / (1.0 + no3 / kno3 + nh4 / knh4)
            vn = vno3 + vnh4
            vn_eff = torch.ones_like(vn) if g == "diaz" else vn
            vp = po4 / (kpo4 + po4)
            vfe = fe / (kfe + fe)
            lims = [vn_eff, vp, vfe]
            if g == "diat":
                lims.append(sio3 / (ksi + sio3))
            vtot = lims[0]
            for lim in lims[1:]:
                vtot = torch.minimum(vtot, lim)

            theta = chl / clampt(c, EPS)     # mg Chl / mmol C
            mu_max = mu0 / DAY * tf
            pcmax = mu_max * vtot
            light = 1.0 - torch.exp(-alpha / DAY * theta * par
                                    / clampt(pcmax, 1e-12))
            mu = pcmax * light               # [1/s]
            photo = mu * c
            photo_tot = photo_tot + photo
            diags[f"photoC_{g}"] = photo

            # chlorophyll synthesis toward a light-regulated theta
            theta_t = th_max / (1.0 + alpha * theta * par
                                / clampt(2.0 * pcmax * DAY, 1e-12))
            chl_syn = mu * c * theta_t
            add(chn, chl_syn - mort / DAY * tf * chl)

            # N source split
            if g == "diaz":
                nfix = nfix + photo * Q_CN
            else:
                wno3 = vno3 / clampt(vn, 1e-12)
                no3_up = no3_up + photo * Q_CN * wno3
                nh4_up = nh4_up + photo * Q_CN * (1.0 - wno3)

            # grazing (Holling III on each group)
            gr = (GRAZE_MAX[g] / DAY * tf * zoo
                  * c * c / (K_GRAZE * K_GRAZE + c * c))
            # mortality + aggregation
            mo = mort / DAY * tf * c + agg / DAY * c * c
            add(cn, photo - gr - mo)
            graze_tot = graze_tot + gr
            # chl and Fe pools follow their carbon ratio losses
            add(chn, -(gr + mo) * theta)
            qfe = cfe / clampt(c, EPS)
            fe_up = photo * Q_FE
            add(fen, fe_up - (gr + mo) * qfe)
            add("FE", -fe_up)
            loss_pofe = loss_pofe + ((1.0 - DOM_FRAC) * (1.0 - Z_EFF) * gr
                                     + (1.0 - DOM_FRAC) * mo) * qfe

            # route losses: non-assimilated grazing (1-Z_EFF) and mortality
            # split DOM_FRAC : (1-DOM_FRAC) between DOM and sinking particles
            dom_c = dom_c + DOM_FRAC * (mo + (1.0 - Z_EFF) * gr)
            loss_poc = loss_poc + (1.0 - DOM_FRAC) * mo \
                + (1.0 - DOM_FRAC) * (1.0 - Z_EFF) * gr

            if g == "diat":
                qsi = get("DIATSI") / clampt(c, EPS)
                si_up = photo * Q_SI
                add("DIATSI", si_up - (gr + mo) * qsi)
                add("SIO3", -si_up)
                loss_posi = loss_posi + (gr + mo) * qsi
            if g == "sp" and has("SPCACO3"):
                caco3_prod = CACO3_FRAC * photo
                qca = get("SPCACO3") / clampt(c, EPS)
                diss = CACO3_DISS / DAY * get("SPCACO3")
                add("SPCACO3", caco3_prod - (gr + mo) * qca - diss)
                add("DIC", -caco3_prod + diss)
                add("ALK", -2.0 * caco3_prod + 2.0 * diss)
                # grazed/dead CaCO3 sinks through the ballast-model column
                # (reference: P_CaCO3, bec2_vars.F)
                ca = len(sinking)
                sinking.append(((gr + mo) * qca, PART_CACO3))
                add("DIC", lambda res: res[ca][0])
                add("ALK", lambda res: 2.0 * res[ca][0])
                diags["CaCO3_prod"] = caco3_prod
                diss_ca = diss

        # zooplankton
        z_mort = Z_LOSS / DAY * tf * zoo + Z_LOSS2 / DAY * zoo * zoo
        add("ZOOC", Z_EFF * graze_tot - z_mort)
        dom_c = dom_c + DOM_FRAC * z_mort
        loss_poc = loss_poc + (1.0 - DOM_FRAC) * z_mort
        loss_pon = loss_pon + loss_poc * Q_CN
        loss_pop = loss_pop + loss_poc * Q_CP

        # DOM production & remineralization
        remin_doc = DOC_REMIN / DAY * tf * doc
        remin_don = DOC_REMIN / DAY * tf * don
        remin_dop = DOC_REMIN / DAY * tf * dop
        add("DOC", dom_c - remin_doc)
        add("DON", dom_c * Q_CN - remin_don)
        add("DOP", dom_c * Q_CP - remin_dop)
        if has("DOFE"):
            dofe = get("DOFE")
            remin_dofe = DOC_REMIN / DAY * tf * dofe
            add("DOFE", dom_c * Q_FE - remin_dofe)
            add("FE", remin_dofe)
        # refractory pools
        for lab, ref_n, q in (("DOC", "DOCR", 1.0), ("DON", "DONR", Q_CN),
                              ("DOP", "DOPR", Q_CP)):
            if has(ref_n):
                ref = get(ref_n)
                remin_ref = DOR_REMIN / DAY * tf * ref
                add(ref_n, DOR_FRAC * dom_c * q - remin_ref)
                add(lab, -DOR_FRAC * dom_c * q)
                if ref_n == "DOCR":
                    add("DIC", remin_ref)
                    add("O2", -remin_ref * O2_PER_C)
                elif ref_n == "DONR":
                    add("NH4", remin_ref)
                else:
                    add("PO4", remin_ref)

        # sinking particulate pools: one sweep for every class
        # (reference: POC/P_CaCO3/P_SiO2/P_iron types, bec2_vars.F:100-140;
        # N/P/Fe ride the POC class as in the reference)
        i0 = len(sinking)
        sinking += [(loss_poc, PART_POC), (loss_pon, PART_POC),
                    (loss_pop, PART_POC), (loss_pofe, PART_POC),
                    (loss_posi, PART_SIO2)]
        res = particulate_fluxes([p for p, _ in sinking], ctx.hz,
                                 [k for _, k in sinking])
        remin_poc, poc_flux, poc_bot = res[i0]
        remin_pon = res[i0 + 1][0]
        remin_pop = res[i0 + 2][0]
        remin_pofe = res[i0 + 3][0]
        remin_posi, posi_flux, _ = res[i0 + 4]
        if ca is not None:
            ca_remin, ca_flux, ca_bot = res[ca]
            diags["CaCO3_remin"] = ca_remin + diss_ca
            diags["CaCO3_flux"] = ca_flux
            diags["CaCO3_bot_flux"] = ca_bot
        diags["POC_prod"] = loss_poc
        diags["POC_remin"] = remin_poc
        diags["POC_flux"] = poc_flux
        diags["POC_bot_flux"] = poc_bot
        diags["SiO2_prod"] = loss_posi
        diags["SiO2_remin"] = remin_posi
        diags["SiO2_flux"] = posi_flux

        add("SIO3", remin_posi)
        add("FE", remin_pofe - FE_SCAV / DAY * fe)
        diags["Fe_scavenge"] = FE_SCAV / DAY * fe
        if marbl:
            lig = get("LIG")
            add("LIG", LIG_PROD * (remin_poc + remin_doc)
                - LIG_LOSS / DAY * lig)

        # carbon / oxygen bookkeeping
        total_remin_c = remin_poc + remin_doc
        add("DIC", total_remin_c - photo_tot)
        add("O2", O2_PER_C * (photo_tot - total_remin_c))
        diags["photoC_tot"] = photo_tot
        diags["graze_tot"] = graze_tot
        diags["zoo_loss"] = z_mort
        diags["DOC_prod"] = dom_c
        diags["DOC_remin"] = remin_doc
        diags["N_fix"] = nfix
        diags["NO3_uptake"] = no3_up
        diags["NH4_uptake"] = nh4_up

        # nitrogen cycle
        add("NO3", -no3_up)
        add("NH4", -nh4_up + remin_pon + remin_don)
        # alkalinity from N transformations: +1 per NO3 uptake, -1 per NH4
        # uptake/production asymmetry (BEC convention)
        add("ALK", no3_up - (remin_pon + remin_don))
        inhib = torch.exp(-par / PAR_NITRIF_INHIB)
        if ncycle:
            no2 = get("NO2")
            nit1 = NITRIF1 / DAY * inhib * nh4
            nit2 = NITRIF2 / DAY * inhib * no2
            diags["NITRIF_NH4_NO2"] = nit1
            diags["NITRIF_NO2_NO3"] = nit2
            add("NH4", -nit1)
            add("NO2", nit1 - nit2)
            add("NO3", nit2)
            add("O2", -1.5 * nit1 - 0.5 * nit2)
            add("ALK", -nit1)
            # suboxic denitrification chain
            sub = (o2 < O2_SUBOXIC).to(trc.dtype)
            den1 = DENITR / DAY * sub * no3
            den2 = DENITR / DAY * sub * no2
            diags["DENITRIF"] = den1 + den2
            diags["N2O_prod"] = 0.5 * N2O_YIELD * den2
            add("NO3", -den1)
            add("NO2", den1 - den2)
            add("N2O", 0.5 * N2O_YIELD * den2)
            add("N2", 0.5 * (1.0 - N2O_YIELD) * den2)
            add("ALK", den1)
            # N2 fixation draws down dissolved N2 (mmol N2 = 2 N)
            add("N2", -0.5 * nfix)
        else:
            nit = NITRIF1 / DAY * inhib * nh4
            diags["NITRIF_NH4_NO3"] = nit
            add("NH4", -nit)
            add("NO3", nit)
            add("O2", -2.0 * nit)
            add("ALK", -2.0 * nit)

        # phosphorus closure
        add("PO4", remin_pop + remin_dop - photo_tot * Q_CP)

        d = torch.zeros_like(trc)
        for i, v in adds:
            d[i] += v(res) if callable(v) else v
        # the ALT_CO2 mirror tracers share the biological DIC/ALK tendencies
        if has("DIC_ALT_CO2"):
            d[I("DIC_ALT_CO2")] += d[I("DIC")]
            d[I("ALK_ALT_CO2")] += d[I("ALK")]
        if has("SPP"):
            # explicit per-group P pools (MARBL): slaved to the group's
            # carbon tendency at Redfield
            for cn, pn in (("SPC", "SPP"), ("DIATC", "DIATP"),
                           ("DIAZC", "DIAZP")):
                d[I(pn)] += d[I(cn)] * Q_CP

        # no persisted saved state: the closed-form seed needs none, so
        # restarts carry no extra BGC state
        return d * ctx.rmask[None, None], diags

    def interior(trc, ctx: BGCContext, saved, forc=None):
        d, _ = kernel(trc, ctx, saved, forc)
        return d, None

    interior.kernel = kernel
    return interior


def _surface_co2(trc, I, has, temp, salt, kw_co2, forc, pairs):
    """Air-sea CO2 flux of each (DIC, ALK, pco2 forcing key) in `pairs`,
    stacked along a leading axis so that one carbonate solve serves every
    pair: the full OCMIP-grade system (total alkalinity with borate,
    water, phosphate and silicate; safeguarded Newton), seeded by the
    closed-form carbonate-alkalinity solution.  The phosphate/silicate
    contributions enter as the reference passes the PO4/SiO3 tracers to
    co2calc (reference: bec2_driver.F:448-456).  Returns (fluxes, the
    solution), each stacked over the pairs."""
    dic = torch.stack([trc[I(d)][-1] for d, _, _ in pairs])
    alk = torch.stack([trc[I(a)][-1] for _, a, _ in pairs])
    pco2_air = torch.stack([forc[k] if forc.get(k) is not None
                            else torch.full_like(temp, 420.0)
                            for _, _, k in pairs])
    _, ph0, _ = _co2_equilibrium(dic, alk, temp, salt)
    return carbonate.co2_flux(
        dic, alk, temp, salt, kw_co2, pco2_air,
        po4_mmol=trc[I("PO4")][-1] if has("PO4") else None,
        sio3_mmol=trc[I("SIO3")][-1] if has("SIO3") else None,
        h_init=10.0 ** (-ph0))


def _surface_ts(ctx: BGCContext):
    temp = ctx.temp[-1]
    salt = ctx.salt[-1] if ctx.salt is not None \
        else torch.full_like(temp, 35.0)
    return temp, salt


def make_surface_flux(names: Tuple[str, ...]):
    idx = {n.upper(): i for i, n in enumerate(names)}
    has = lambda n: n.upper() in idx   # noqa: E731
    I = lambda n: idx[n.upper()]       # noqa: E731,E741

    def surface_flux(trc, ctx: BGCContext, forc):
        """Air-sea gas exchange (O2, CO2) and atmospheric deposition
        (dust->Fe, iron, NOx->NO3, NHy->NH4) (reference: src/bgc_forces.F,
        the bec2_driver gas-exchange sections).  Returns (nbgc, jy, ix)
        kinematic fluxes [conc * m/s], positive into the ocean."""
        nb = trc.shape[0]
        flx = torch.zeros((nb,) + tuple(ctx.srflx.shape), dtype=trc.dtype,
                          device=trc.device)
        forc = forc or {}
        temp, salt = _surface_ts(ctx)

        # wind-speed-dependent piston velocities (reference:
        # bec2_driver.F:194 XKW = a*ws^2, then sqrt(660/Sc) per gas); the
        # stepper always passes "wspd" (bulk, or inverted from the stress)
        ws = forc.get("wspd")
        if ws is None:
            warnings.warn(
                "BEC surface_flux called without a 'wspd' forcing entry: "
                "air-sea O2/CO2 gas exchange is ZERO (calm-air limit). "
                "Pass wspd (10 m wind speed, m/s) — the model stepper "
                "injects it automatically; direct callers must supply it "
                "or pass wspd=0 explicitly to silence this warning.",
                stacklevel=2)
            ws = torch.zeros_like(temp)
        kw_o2 = gas_transfer_velocity(ws, schmidt_o2(temp))
        kw_co2 = gas_transfer_velocity(ws, schmidt_co2(temp))

        o2 = trc[I("O2")][-1]
        flx[I("O2")] = kw_o2 * (o2_saturation(temp, salt) - o2)

        pairs = [("DIC", "ALK", "pco2_air")]
        if has("DIC_ALT_CO2"):
            pairs.append(("DIC_ALT_CO2", "ALK_ALT_CO2", "pco2_air_alt"))
        fg, _ = _surface_co2(trc, I, has, temp, salt, kw_co2, forc, pairs)
        for (dic_n, _, _), f in zip(pairs, fg):
            flx[I(dic_n)] += f

        if "dust" in forc:
            flx[I("FE")] += forc["dust"] * DUST_TO_FE * 1.0e-3
        if "iron" in forc:
            # nmol/cm2/s -> mmol/m2/s = 1e-9 mol/1e-4 m2 = 1e-5 mol/m2/s
            flx[I("FE")] += forc["iron"] * 1.0e-2
        if "nox" in forc:
            flx[I("NO3")] += forc["nox"] * 1.0e-2
        if "nhy" in forc:
            flx[I("NH4")] += forc["nhy"] * 1.0e-2
        return flx * ctx.rmask[None]

    return surface_flux


def make_init_tracers(names: Tuple[str, ...]):
    def init_tracers(cfg, z_r, dtype=torch.float64, device=None):
        raise NotImplementedError(
            "initial BGC profiles are inputs that the benchmark makes; "
            "the reference steps them and does not make them")
    return init_tracers


def make_diagnose(names: Tuple[str, ...]):
    """Full diagnostic evaluation: interior rates and the surface carbonate
    and gas-exchange fields (reference: the bgc_io.F output set — FG_CO2,
    pCO2, pH, PAR, production/remin/flux rates), at output cadence only;
    returns {name: (nz|nz+1|2D, jy, ix)}."""
    interior0 = make_interior(names)
    idx = {n.upper(): i for i, n in enumerate(names)}
    has = lambda n: n.upper() in idx   # noqa: E731
    I = lambda n: idx[n.upper()]       # noqa: E731,E741

    def diagnose(trc, ctx: BGCContext, forc=None):
        _, diags = interior0.kernel(trc, ctx, None, forc)
        forc = dict(forc or {})
        temp, salt = _surface_ts(ctx)
        ws = forc.get("wspd")
        if ws is None:
            ws = torch.zeros_like(temp)
        kw_o2 = gas_transfer_velocity(ws, schmidt_o2(temp))
        kw_co2 = gas_transfer_velocity(ws, schmidt_co2(temp))
        o2 = torch.clamp(trc[I("O2")][-1], min=0.0)
        o2sat = o2_saturation(temp, salt)
        # the monitoring set of the full carbonate system (pCO2, pH, CO3,
        # saturation states), from the clamped DIC and ALK
        pos = torch.clamp(trc, min=0.0)
        fg, sol = _surface_co2(pos, I, has, temp, salt, kw_co2, forc,
                               [("DIC", "ALK", "pco2_air")])
        diags.update({
            "pCO2_oc": sol.pco2[0], "pH_surf": sol.ph[0],
            "CO3_surf": sol.co3[0], "HCO3_surf": sol.hco3[0],
            "CO2STAR_surf": sol.co2star[0],
            "Omega_calcite": sol.omega_ca[0],
            "Omega_aragonite": sol.omega_ar[0],
            "FG_CO2": fg[0],
            "FG_O2": kw_o2 * (o2sat - o2),
            "O2_saturation": o2sat, "wspd_10m": ws,
        })
        m = ctx.rmask
        return {k: v * (m if v.dim() == 2 else m[None])
                for k, v in diags.items()}

    return diagnose


def _build(name, tracers):
    return BGCModel(
        name=name, tracer_names=tracers,
        interior_tendency=make_interior(tracers),
        surface_flux=make_surface_flux(tracers),
        init_tracers=make_init_tracers(tracers),
        init_saved=lambda cfg, shape, dtype: None,
        diagnose=make_diagnose(tracers))


@register("bec2")
def build_bec2() -> BGCModel:
    return _build("bec2", BEC2_TRACERS)


@register("bec2_base")
def build_bec2_base() -> BGCModel:
    """BEC2 without the Ncycle_SY extension (26 tracers — reference:
    param.opt:26-30 `ntrc_bio=26` when Ncycle_SY is undefined, the
    tests/bgc_real cppdefs_BEC.opt configuration)."""
    return _build("bec2_base", BEC2_TRACERS[:-3])


@register("marbl32")
def build_marbl32() -> BGCModel:
    return _build("marbl32", MARBL_TRACERS)
