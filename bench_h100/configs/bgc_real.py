"""Inputs of the `bgc_real` configuration: UCLA-ROMS's tests/bgc_real, the
MARBL variant, on the USWC sample grid (the port's
roms_tpu_torch/cases/bgc_real.py with `cases/uswc.py`'s analytic inputs),
its formulas restated in torch float64 on the run's device.

`raw_inputs` makes, on the padded layout (padded index = the joined
file's index + 1):
- the grid: a 300 m spherical grid from 121.90 W, 33.40 N, a curving
  coast on the east, tanh shelf-to-slope bathymetry 25-500 m;
- the sponge band's `visc2_r`, `visc2_p` and `diff2` (set_nudgcof.F's
  roof over `sponge_size` points from each open edge);
- the river mouth: three land cells at a third of the grid's height
  discharging westward, and their faces' ±frac + 10*index encoding;
- the geostrophically balanced coastal jet, T, S and MARBL's 32 tracers
  (`BGC_PROFILES`), T and the BGC tracers perturbed by the seed;
- the forcing frozen at one record: surface fluxes from the first bulk
  record's winds and radiation, the BGC surface fields, the open-boundary
  data of all 34 tracers (the initial edge state) with the tides of 10
  constituents added to zeta, ubar and vbar, the river's volume and
  tracers, and the potential tide.

`derive` builds the grid, state and forcing from them with one side's
modules (`inputs.side`), as `experiment.assemble` and `io.input.read_init`
do: set_depth, the fast-averaged transports, swr_frac, set_HUV, omega,
rho_eos.
"""

from __future__ import annotations

import math

import torch

from bench_h100 import inputs
from bench_h100.reference import vcoord
from bench_h100.reference.bgc.bec import MARBL_TRACERS
from bench_h100.reference.parallel.halo import shift

# ---- the USWC sample domain (tests/*/param.opt; cases/uswc.py)
DX = 300.0                      # [m]
LON_W, LAT_S = -121.90, 33.40   # SW corner
HMIN, HMAX = 25.0, 500.0
OMEGA_E = 7.292115e-5
R_EARTH = 6371315.0
D2R = math.pi / 180.0
G = 9.81
# the coastal jet: a Gaussian sea-surface depression offshore of the shelf
ZAMP, ZCENTER, ZSCALE, VDECAY = -0.015, 12.0e3, 9.0e3, 150.0

# BGC profiles, name -> (deep value, surface - deep, e-folding scale [m]):
# conc(z) = deep + delta * exp(z / scale), coastal California magnitudes
# in MARBL units (mmol/m3 unless noted)
BGC_PROFILES = {
    "PO4": (2.2, -2.0, 120.0), "NO3": (28.0, -27.0, 120.0),
    "SIO3": (50.0, -46.0, 120.0), "NH4": (0.01, 0.4, 60.0),
    "FE": (1.0e-3, -0.4e-3, 150.0), "LIG": (1.0e-3, 0.0, 150.0),
    "O2": (60.0, 160.0, 150.0), "DIC": (2300.0, -120.0, 150.0),
    "DIC_ALT_CO2": (2300.0, -120.0, 150.0), "ALK": (2400.0, -110.0, 200.0),
    "ALK_ALT_CO2": (2400.0, -110.0, 200.0), "DOC": (2.0, 40.0, 80.0),
    "DON": (0.4, 3.0, 80.0), "DOP": (0.03, 0.2, 80.0),
    "DOPR": (0.02, 0.0, 80.0), "DONR": (1.0, 0.0, 80.0),
    "DOCR": (20.0, 0.0, 80.0), "ZOOC": (0.01, 1.5, 40.0),
    "SPCHL": (0.005, 0.25, 30.0), "SPC": (0.01, 1.2, 30.0),
    "SPFE": (1.0e-6, 4.0e-5, 30.0), "SPP": (1.0e-4, 1.0e-2, 30.0),
    "SPCACO3": (1.0e-4, 1.0e-2, 30.0), "DIATCHL": (0.005, 0.35, 30.0),
    "DIATC": (0.01, 1.6, 30.0), "DIATFE": (1.0e-6, 5.0e-5, 30.0),
    "DIATP": (1.0e-4, 1.3e-2, 30.0), "DIATSI": (2.0e-4, 2.5e-2, 30.0),
    "DIAZCHL": (0.002, 0.03, 30.0), "DIAZC": (0.005, 0.15, 30.0),
    "DIAZFE": (5.0e-7, 5.0e-6, 30.0), "DIAZP": (5.0e-5, 1.0e-3, 30.0),
}

# ---- the forcing's first records (cases/uswc.py's writers)
# tides: M2 S2 N2 K2 K1 O1 P1 Q1 Mf Mm [rad/s] and elevation amplitudes [m]
TIDE_OMEGA = (1.405189e-4, 1.454441e-4, 1.378797e-4, 1.458423e-4,
              7.292117e-5, 6.759774e-5, 7.252295e-5, 6.495854e-5,
              5.323414e-6, 2.639203e-6)
TIDE_ZAMP = (0.36, 0.11, 0.08, 0.03, 0.35, 0.22, 0.11, 0.04, 0.01, 0.005)
RIVER_VOLUME = 300.0            # [m3/s]
RIVER_T, RIVER_S = 16.0, 2.0    # [degC], [psu]; the BGC tracers 0
# BGC surface climatology's first month (mid-January)
BGC_SEASON = 1.0 + 0.4 * math.cos(2.0 * math.pi * (15.2 / 365.25 - 0.55))
# surface fluxes from the first bulk record (10 m winds uwnd 2.0 m/s,
# vwnd -6 + sin(2 pi latn) m/s, swrad 180 W/m2, rain 0.05 cm/day) with a
# constant drag, and a fixed non-solar heat loss and evaporation
RHO_AIR, CD = 1.22, 1.3e-3
CP = 3985.0                     # [J/kg/degC]
SWRAD, Q_NONSOLAR = 180.0, -130.0   # [W/m2]
RAIN, EVAP = 0.05 * 0.01 / 86400.0, 3.2e-8   # [m/s]

# the seeded perturbations, surface-intensified: T [degC], and the BGC
# tracers as a share of their value
T_PERTURB = 0.05
BGC_PERTURB = 0.01


def _coords(model: dict, device):
    """lon, lat [deg] at the padded rho points, and the spacing dlon."""
    nx, ny, h = model["nx"], model["ny"], model["halo"]
    jy, ix = ny + 2 * h, nx + 2 * h
    f64 = dict(dtype=torch.float64, device=device)
    dlat = DX / (R_EARTH * D2R)
    dlon = DX / (R_EARTH * D2R * math.cos((LAT_S + 0.15) * D2R))
    # padded index p is the joined file's index p - (h - 1)
    lon = LON_W + dlon * (torch.arange(ix, **f64) - (h - 1) - 0.5)
    lat = LAT_S + dlat * (torch.arange(jy, **f64) - (h - 1) - 0.5)
    return lon[None, :].expand(jy, ix), lat[:, None].expand(jy, ix), dlon


def _coast_dist(lon, lat, dlon, nx):
    """Signed cross-shore distance [m], positive in water: a gently
    curving coast west of the east edge, so the eastern ring is land."""
    lon_e = LON_W + dlon * (nx + 1 - 0.5)
    width = 0.02 + 0.012 * (1.0 + torch.sin(2.0 * math.pi * (lat - LAT_S)
                                            / 0.30))
    return (lon_e - width - 1.5 * dlon - lon) * R_EARTH * D2R \
        * torch.cos(lat * D2R)


def _sponge(model: dict, device):
    """set_nudgcof.F's roof: (isp - distance to the nearest open edge) /
    isp, clipped at isp = sponge_size + 1, 0 in the interior."""
    h = model["halo"]
    jy, ix = model["ny"] + 2 * h, model["nx"] + 2 * h
    isp = model["sponge_size"] + 1
    f64 = dict(dtype=torch.float64, device=device)
    i_f = (torch.arange(ix, **f64) - 1)[None, :].expand(jy, ix)
    j_f = (torch.arange(jy, **f64) - 1)[:, None].expand(jy, ix)
    ibnd = torch.full((jy, ix), float(isp), **f64)
    for on, dist in (("obc_west", i_f), ("obc_east", model["nx"] + 1 - i_f),
                     ("obc_south", j_f), ("obc_north", model["ny"] + 1 - j_f)):
        if model[on]:
            ibnd = torch.minimum(ibnd, dist)
    return (isp - ibnd.clamp(0.0, isp)) / isp


def _river_faces(rmask, ny: int, h: int):
    """riv_uflx, riv_vflx: the mouth's cells, the first land cell of
    rows ny//3 - 1 .. ny//3 + 1 (joined), each a third of river 1, their
    share split over their wet faces (river_frc.F:240-280)."""
    m = rmask.cpu()
    uflx = torch.zeros_like(m)
    vflx = torch.zeros_like(m)
    jr = ny // 3 + (h - 1)
    for j in (jr - 1, jr, jr + 1):
        i = max(int(torch.argmax((m[j, h - 1:-(h - 1)] == 0.0).to(
            torch.int64))), 1) + (h - 1)
        frac = 1.0 / 3.0
        faces = float(m[j, i - 1] + m[j, i + 1] + m[j - 1, i] + m[j + 1, i])
        if faces == 0.0 or m[j, i] > 0.0:
            raise ValueError(f"river mouth at {i},{j} has no wet face")
        if m[j, i - 1] > 0:
            uflx[j, i] = -frac / faces + 10.0
        if m[j, i + 1] > 0:
            uflx[j, i + 1] = frac / faces + 10.0
        if m[j - 1, i] > 0:
            vflx[j, i] = -frac / faces + 10.0
        if m[j + 1, i] > 0:
            vflx[j + 1, i] = frac / faces + 10.0
    return uflx.to(rmask.device), vflx.to(rmask.device)


def _harmonic(lon, lat, t: float):
    """The tidal elevation of the 10 constituents summed at time t:
    sum_k Re_k cos(w_k t) - Im_k sin(w_k t), Re + i Im = A_k shape(lat)
    exp(i (phase(lon) + 0.3 k)) (tides.F:127-251; cases/uswc.py)."""
    phase = (lon - LON_W) * D2R * 20.0
    out = torch.zeros_like(lon)
    for k, (om, amp) in enumerate(zip(TIDE_OMEGA, TIDE_ZAMP)):
        shape = (torch.cos(lat * D2R) ** 2 if om > 1e-4
                 else torch.sin(2.0 * lat * D2R))
        re = amp * shape * torch.cos(phase + 0.3 * k)
        im = amp * shape * torch.sin(phase + 0.3 * k)
        out = out + re * math.cos(om * t) - im * math.sin(om * t)
    return out


def _to_u(a):
    """rho-point field to u points (the west face of each cell)."""
    out = 0.5 * (a + torch.roll(a, 1, dims=-1))
    out[..., 0] = out[..., 1]
    return out


def _to_v(a):
    out = 0.5 * (a + torch.roll(a, 1, dims=-2))
    out[..., 0, :] = out[..., 1, :]
    return out


def raw_inputs(model: dict, seed: int, device) -> dict:
    """float64 tensors on `device` (see the module's docstring)."""
    nx, ny, nz, nt, h = (model["nx"], model["ny"], model["nz"], model["nt"],
                         model["halo"])
    if nt != 2 + len(MARBL_TRACERS):
        raise ValueError(f"bgc_real carries T, S and MARBL's "
                         f"{len(MARBL_TRACERS)} tracers, not nt = {nt}")
    jy, ix = ny + 2 * h, nx + 2 * h
    f64 = dict(dtype=torch.float64, device=device)
    gen = inputs.generator(seed, device)

    lon, lat, dlon = _coords(model, device)
    d = _coast_dist(lon, lat, dlon, nx)
    pm = 1.0 / (R_EARTH * D2R * dlon) / torch.cos(lat * D2R)
    pn = torch.full((jy, ix), 1.0 / DX, **f64)
    f = 2.0 * OMEGA_E * torch.sin(lat * D2R)
    hb = HMIN + (HMAX - HMIN) * torch.tanh(d.clamp(min=0.0) / 12.0e3)
    rmask = (d > 0.0).to(torch.float64)

    # rest-state depths for the profiles
    cs_w, cs_r = (torch.as_tensor(c, **f64) for c in vcoord.stretching_curves(
        nz, model["theta_s"], model["theta_b"]))
    _, z, hz = vcoord.set_depth(torch.zeros_like(hb), hb,
                                  1.0 / (hb + model["hc"]), cs_w, cs_r,
                                  model["hc"], nz)

    # the coastal jet in geostrophic balance
    zeta = ZAMP * torch.exp(-((d.clamp(min=0.0) - ZCENTER) / ZSCALE) ** 2) \
        * rmask
    dzdx = torch.zeros_like(zeta)
    dzdy = torch.zeros_like(zeta)
    dzdx[:, 1:-1] = 0.5 * (zeta[:, 2:] - zeta[:, :-2]) * pm[:, 1:-1]
    dzdy[1:-1, :] = 0.5 * (zeta[2:, :] - zeta[:-2, :]) * pn[1:-1, :]
    phi = torch.exp(z / VDECAY) * rmask
    u_r = -(G / f) * dzdy * phi
    v_r = (G / f) * dzdx * phi
    depth = hz.sum(0)
    u, v = _to_u(u_r), _to_v(v_r)
    ubar, vbar = _to_u((u_r * hz).sum(0) / depth), \
        _to_v((v_r * hz).sum(0) / depth)

    # tracers, T and the BGC tracers perturbed by the seed
    n_m = len(inputs.MODES)
    ph = inputs.phases(gen, n_m * (nt - 1), device)
    x = DX * torch.arange(ix, **f64)[None, :]
    y = DX * torch.arange(jy, **f64)[:, None]

    def perturbation(i):
        return inputs.smooth_field(x, y, DX * nx, DX * ny,
                                   ph[i * n_m:(i + 1) * n_m])

    t = torch.empty((nt, nz, jy, ix), **f64)
    t[0] = (7.0 + 11.0 * torch.exp(z / 90.0)
            + 0.25 * torch.exp(z / 60.0)
            * torch.sin(2.0 * math.pi * (lat - LAT_S) / 0.27)
            + T_PERTURB * perturbation(0) * torch.exp(z / 90.0))
    t[1] = 34.4 - 0.8 * torch.exp(z / 130.0)
    for k, name in enumerate(MARBL_TRACERS):
        deep, delta, scale = BGC_PROFILES[name.upper()]
        t[k + 2] = (deep + delta * torch.exp(z / scale)) * (
            1.0 + BGC_PERTURB * perturbation(k + 1) * torch.exp(z / 100.0))

    # the boundary data: the initial edge state, the tides added
    tide = _harmonic(lon, lat, 0.5 * model["dt"])
    bry = {}
    # the edge's last interior rho column or row, and its boundary faces,
    # where the velocity normal to it sits
    edges = {"west": (..., h), "east": (..., -h - 1),
             "south": (..., h, slice(None)),
             "north": (..., -h - 1, slice(None))}
    normal = {"west": (..., h), "east": (..., -h),
              "south": (..., h, slice(None)), "north": (..., -h, slice(None))}
    # tides.py's edge map: (zeta, ubar, vbar), the normal velocity at the
    # boundary faces, the others at the ghost ring
    tidal = {"west": ((..., 1), (..., 2), (..., 1)),
             "east": ((..., -2), (..., -2), (..., -2)),
             "south": ((..., 1, slice(None)), (..., 1, slice(None)),
                       (..., 2, slice(None))),
             "north": ((..., -2, slice(None)), (..., -2, slice(None)),
                       (..., -2, slice(None)))}
    for edge in edges:
        if not model[f"obc_{edge}"]:
            continue
        ew = edge in ("west", "east")
        su = normal[edge] if ew else edges[edge]
        sv = edges[edge] if ew else normal[edge]
        tz, tu, tv = tidal[edge]
        bry[f"zeta_{edge}"] = zeta[edges[edge]] + tide[tz]
        bry[f"ubar_{edge}"] = ubar[su] + 0.05 * tide[tu]
        bry[f"vbar_{edge}"] = vbar[sv] + 0.04 * tide[tv]
        bry[f"u_{edge}"] = u[su]
        bry[f"v_{edge}"] = v[sv]
        bry[f"t_{edge}"] = t[edges[edge]]

    # surface fluxes (kinematic units), frozen
    latn = (lat - LAT_S) / 0.27
    uwnd = torch.full_like(lat, 2.0)
    vwnd = -6.0 + torch.sin(2.0 * math.pi * latn)
    wspd = torch.sqrt(uwnd ** 2 + vwnd ** 2)
    r0 = model["rho0"]
    umask = rmask * torch.roll(rmask, 1, dims=-1)
    vmask = rmask * torch.roll(rmask, 1, dims=-2)
    sustr = _to_u(RHO_AIR * CD * wspd * uwnd / r0) * umask
    svstr = _to_v(RHO_AIR * CD * wspd * vwnd / r0) * vmask
    srflx = torch.full_like(lat, SWRAD / (r0 * CP))
    stflx_t = (SWRAD + Q_NONSOLAR) / (r0 * CP) * rmask
    swflx = (RAIN - EVAP) * rmask
    bgc = {"dust": 6.0e-10 * BGC_SEASON * (1.0 + 0.2 * latn),
           "iron": 1.2e-3 * BGC_SEASON * (1.0 + 0.2 * latn),
           "pco2_air": torch.full_like(lat, 421.0),
           "pco2_air_alt": torch.full_like(lat, 284.0),
           "nox": torch.full_like(lat, 8.0e-11 * BGC_SEASON),
           "nhy": torch.full_like(lat, 5.0e-11 * BGC_SEASON),
           "swrad_LFreq": torch.full_like(lat, 180.0 * BGC_SEASON)}

    # the river: one source of three mouth cells
    riv_uflx, riv_vflx = _river_faces(rmask, ny, h)
    riv_trc = torch.zeros((2, nt), **f64)
    riv_trc[1, 0], riv_trc[1, 1] = RIVER_T, RIVER_S

    wrk = _sponge(model, device)
    vs = model["v_sponge"]
    return {"h": hb, "pm": pm, "pn": pn, "f": f, "rmask": rmask,
            "xr": lon, "yr": lat, "zeta": zeta, "ubar": ubar, "vbar": vbar,
            "u": u, "v": v, "t": t, "bry": bry,
            "sustr": sustr, "svstr": svstr, "srflx": srflx,
            "stflx_t": stflx_t, "swflx": swflx, "bgc": bgc,
            "ptide": 0.10 * tide,
            "riv_uflx": riv_uflx, "riv_vflx": riv_vflx,
            "riv_vol": torch.tensor([0.0, RIVER_VOLUME], **f64),
            "riv_trc": riv_trc,
            "visc2_r": model["visc2"] + vs * wrk,
            "visc2_p": model["visc2"] + 0.25 * vs * (
                wrk + shift(wrk, 0, -1) + shift(wrk, -1, 0)
                + shift(wrk, -1, -1)),
            "diff2": model["tnu2"] + vs * wrk}


def derive(lib, cfg, raw: dict, dtype: torch.dtype, device):
    """(grid, state, forcing) of one side from the raw inputs."""
    def cast(a):
        return a.to(dtype)

    grid = lib.grid.build_grid(
        cfg, *(inputs.host(raw[k]) for k in ("h", "pm", "pn", "f", "rmask")),
        xr=inputs.host(raw["xr"]), yr=inputs.host(raw["yr"]), dtype=dtype,
        device=device)
    if cfg.sponge:
        grid = grid.replace(visc2_r=cast(raw["visc2_r"]),
                            visc2_p=cast(raw["visc2_p"]),
                            diff2=cast(raw["diff2"]).repeat(cfg.nt, 1, 1))

    shift_ = lib.halo.shift
    fill = lib.halo.make_halo_fill(cfg)
    zeta, ubar, vbar, u, v, t = (fill(cast(raw[k])) for k in
                                 ("zeta", "ubar", "vbar", "u", "v", "t"))
    z_w, z_r, hz = (fill(a) for a in lib.vcoord.set_depth(
        zeta, grid.h, grid.hinv, grid.cs_w, grid.cs_r, cfg.hc, cfg.nz))
    # the fast-averaged transports from (zeta, ubar, vbar) and the solar
    # profile from the rest state, as io.input.read_init makes them
    du_avg1 = 0.5 * (grid.h + shift_(grid.h, 0, -1) + zeta
                     + shift_(zeta, 0, -1)) * grid.dn_u * ubar
    dv_avg1 = 0.5 * (grid.h + shift_(grid.h, -1, 0) + zeta
                     + shift_(zeta, -1, 0)) * grid.dm_v * vbar
    _, _, hz0 = lib.vcoord.set_depth(zeta * 0.0, grid.h, grid.hinv,
                                     grid.cs_w, grid.cs_r, cfg.hc, cfg.nz)
    st = lib.state.zeros_state(cfg, dtype, device).replace(
        zeta=zeta, ubar=ubar, vbar=vbar, u=u, v=v, u_prev=u, v_prev=v, t=t,
        t_prev=t, z_w=z_w, z_r=z_r, hz=hz, swrf=lib.kpp.swr_frac(hz0, cfg),
        du_avg1=fill(du_avg1), dv_avg1=fill(dv_avg1))
    flx_u, flx_v = (fill(a) for a in lib.kinematics.set_huv(u, v, hz, grid))
    om = lib.kinematics.omega(flx_u, flx_v, z_w, hz, zeta * 0.0, grid,
                              0.6 * cfg.dt)
    eos0 = lib.eos.rho_eos(t, z_r, z_w, hz, grid.rmask, cfg)
    st = st.replace(flx_u=flx_u, flx_v=flx_v, we=fill(om.we),
                    wi=fill(om.wi), rho=eos0.rho)

    bry = lib.state.zero_boundary(cfg, dtype, device).replace(
        **{k: cast(a).clone() for k, a in raw["bry"].items()})
    stflx = torch.zeros((cfg.nt,) + tuple(grid.h.shape), dtype=dtype,
                        device=device)
    stflx[cfg.itemp] = cast(raw["stflx_t"])
    forcing = lib.state.zero_forcing(cfg, dtype, device).replace(
        bry=bry, sustr=cast(raw["sustr"]), svstr=cast(raw["svstr"]),
        srflx=cast(raw["srflx"]), stflx=stflx, swflx=cast(raw["swflx"]),
        ptide=cast(raw["ptide"]),
        bgc={k: cast(a) for k, a in raw["bgc"].items()},
        riv_uflx=cast(raw["riv_uflx"]), riv_vflx=cast(raw["riv_vflx"]),
        riv_vol=cast(raw["riv_vol"]), riv_trc=cast(raw["riv_trc"]))
    return grid, st, forcing
