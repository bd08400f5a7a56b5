"""USWC-sample synthetic domain + reference-schema input-file generator
(port of roms_tpu/cases/uswc.py: numpy and the port's NCWriter, the same
files, SCHEMA_VERSION and stamp).

The reference's seven "real-data" regression cases (Flux_frc, Rivers_real,
Pipes_real, CDR_parameterized/dp/3d, bgc_real) all run on one 199x99x50
nearshore US-West-Coast sample grid whose input NetCDF files are downloaded
at test time (reference: tests/input_data/get_input_files.sh).  Those files
are not in the reference snapshot, so this module writes every input file
synthetically with the exact variable names, dimension layouts, units and
time conventions the reference readers expect, and each case's frozen
20-step oracle (tests/data/*_oracle.txt) is self-generated (CASES.md).

The domain is analytic and deterministic: a 60 x 30 km nearshore strip
(300 m resolution) with a curving coastline on the east, a shelf-to-slope
tanh bathymetry (25-500 m), a geostrophically balanced coastal current,
and stratified T/S/BGC profiles.  All numbers are smooth closed-form
fields, no RNG, so regenerating the inputs is bit-reproducible.
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from roms_tpu_torch import vcoord
from roms_tpu_torch.io.netcdf import NCWriter

# ---- grid constants (reference: tests/*/param.opt LLm=199, MMm=99, N=50) --
NX, NY, NZ = 199, 99, 50
THETA_S, THETA_B, HC = 6.0, 6.0, 25.0
DX = 300.0                    # [m] target resolution
LON_W, LAT_S = -121.90, 33.40  # SW corner
HMIN, HMAX = 25.0, 500.0
OMEGA_E = 7.292115e-5
R_EARTH = 6371315.0           # (reference: scalars.F Eradius)
D2R = np.pi / 180.0
T0_DAYS = 3654.0              # model start time [days since ref date]
DAY = 86400.0

# coastal jet (geostrophically balanced initial state): a Gaussian
# sea-surface depression centered offshore of the shelf so the shallow
# coastal cells stay quiet
ZAMP = -0.015                 # jet sea-level depression [m]
ZCENTER = 12.0e3              # jet center distance from coast [m]
ZSCALE = 9.0e3                # cross-shore decay [m]
VDECAY = 150.0                # baroclinic vertical decay of the jet [m]

# BGC initial/boundary profiles: name -> (deep value, surface-deep, e-scale)
# conc(z) = deep + delta * exp(z / scale); values are typical coastal
# California magnitudes in BEC/MARBL units (mmol/m3 unless noted).
BGC_PROFILES: Dict[str, Tuple[float, float, float]] = {
    "PO4": (2.2, -2.0, 120.0),
    "NO3": (28.0, -27.0, 120.0),
    "SiO3": (50.0, -46.0, 120.0),
    "NH4": (0.01, 0.4, 60.0),
    "Fe": (1.0e-3, -0.4e-3, 150.0),
    "Lig": (1.0e-3, 0.0, 150.0),
    "O2": (60.0, 160.0, 150.0),
    "DIC": (2300.0, -120.0, 150.0),
    "DIC_ALT_CO2": (2300.0, -120.0, 150.0),
    "ALK": (2400.0, -110.0, 200.0),
    "ALK_ALT_CO2": (2400.0, -110.0, 200.0),
    "DOC": (2.0, 40.0, 80.0),
    "DON": (0.4, 3.0, 80.0),
    "DOP": (0.03, 0.2, 80.0),
    "DOPr": (0.02, 0.0, 80.0),
    "DONr": (1.0, 0.0, 80.0),
    "DOCr": (20.0, 0.0, 80.0),
    "zooC": (0.01, 1.5, 40.0),
    "spChl": (0.005, 0.25, 30.0),
    "spC": (0.01, 1.2, 30.0),
    "spFe": (1.0e-6, 4.0e-5, 30.0),
    "spP": (1.0e-4, 1.0e-2, 30.0),
    "spCaCO3": (1.0e-4, 1.0e-2, 30.0),
    "diatChl": (0.005, 0.35, 30.0),
    "diatC": (0.01, 1.6, 30.0),
    "diatFe": (1.0e-6, 5.0e-5, 30.0),
    "diatP": (1.0e-4, 1.3e-2, 30.0),
    "diatSi": (2.0e-4, 2.5e-2, 30.0),
    "diazChl": (0.002, 0.03, 30.0),
    "diazC": (0.005, 0.15, 30.0),
    "diazFe": (5.0e-7, 5.0e-6, 30.0),
    "diazP": (5.0e-5, 1.0e-3, 30.0),
    # reduced-BEC extras (reference: bec2_vars.F tracer table)
    "NO2": (0.05, 0.3, 60.0),
    "N2O": (0.02, 0.01, 200.0),
    "N2": (0.01, 0.0, 200.0),
}


# ---------------------------------------------------------------------------
# analytic domain
# ---------------------------------------------------------------------------

def _axes():
    """Joined-file rho-point coordinates (index 0..N+1, interior 1..N)."""
    dlat = DX / (R_EARTH * D2R)
    dlon = DX / (R_EARTH * D2R * np.cos((LAT_S + 0.15) * D2R))
    lon1 = LON_W + dlon * (np.arange(NX + 2) - 0.5)
    lat1 = LAT_S + dlat * (np.arange(NY + 2) - 0.5)
    return lon1, lat1, dlon, dlat


def _coast_lon(lat):
    """Coastline longitude: gently curving, always west of the east edge
    so the eastern boundary ring is land (like the USWC sample)."""
    lon1, lat1, dlon, _ = _axes()
    lon_e = lon1[-1]
    width = 0.02 + 0.012 * (1.0 + np.sin(2.0 * np.pi * (lat - LAT_S) / 0.30))
    return lon_e - width - 1.5 * dlon


def _coast_dist(lon2, lat2):
    """Signed cross-shore distance [m]; positive in water (west of coast)."""
    return (_coast_lon(lat2) - lon2) * R_EARTH * D2R * np.cos(lat2 * D2R)


def domain() -> Dict[str, np.ndarray]:
    """All grid-file fields in joined-file (eta_rho, xi_rho) layout."""
    lon1, lat1, dlon, dlat = _axes()
    lon2, lat2 = np.meshgrid(lon1, lat1)
    d = _coast_dist(lon2, lat2)

    pm = np.full_like(lon2, 1.0 / (R_EARTH * D2R * dlon)) / np.cos(lat2 * D2R)
    pn = np.full_like(lon2, 1.0 / (R_EARTH * D2R * dlat))
    f = 2.0 * OMEGA_E * np.sin(lat2 * D2R)

    h = HMIN + (HMAX - HMIN) * np.tanh(np.maximum(d, 0.0) / 12.0e3)
    mask = (d > 0.0).astype(np.float64)

    # river mouth: 3-cell-wide indentation; each mouth cell is the first
    # land cell east of the water at its row, discharging westward
    # (encoding frac + 10*index, reference: river_frc.F:240-280)
    river_flux = np.zeros_like(h)
    jr = NY // 3
    for j in (jr - 1, jr, jr + 1):
        i_land = int(np.argmax(mask[j] == 0.0))
        i_land = max(i_land, 1)
        river_flux[j, i_land] = 1.0 / 3.0 + 10.0 * 1

    # pipe: single wet shelf cell ~2 km offshore at 2/3 of the domain
    jp = (2 * NY) // 3
    ip = int(np.argmin(np.abs(d[jp] - 2.0e3)))
    pipe_index = np.zeros_like(h)
    pipe_fraction = np.zeros_like(h)
    pipe_index[jp, ip] = 1.0
    pipe_fraction[jp, ip] = 1.0

    return dict(lon_rho=lon2, lat_rho=lat2, pm=pm, pn=pn, f=f, h=h,
                mask_rho=mask, angle=np.zeros_like(h),
                river_flux=river_flux, pipe_index=pipe_index,
                pipe_fraction=pipe_fraction, coast_dist=d)


def _sigma_depths(h2d: np.ndarray):
    """Rest-state level depths z_r (NZ, ...) for the joined grid
    (same SM09 transform as the model, reference: src/set_depth.F:17-25)."""
    cs_w, cs_r = vcoord.stretching_curves(NZ, THETA_S, THETA_B)
    cs_r = np.asarray(cs_r)
    k = np.arange(1, NZ + 1)
    sc_r = -1.0 + (k - 0.5) / NZ
    hinv = 1.0 / (h2d + HC)
    cff = (HC * sc_r)[:, None, None]
    cs = cs_r[:, None, None]
    return h2d[None] * hinv[None] * (cff + cs * h2d[None])


def t_profile(z):
    return 7.0 + 11.0 * np.exp(z / 90.0)


def s_profile(z):
    return 34.4 - 0.8 * np.exp(z / 130.0)


_BGC_PROFILES_NORM = {k.upper(): v for k, v in BGC_PROFILES.items()}
_BGC_PROFILES_NORM.setdefault("DOFE", (1.0e-5, 4.0e-5, 80.0))


def bgc_profile(name: str, z):
    """Case-insensitive: the BEC2 table spells tracers 'Alk'/'SPCACO3',
    MARBL spells them 'ALK'/'spCaCO3' (reference: tracers.opt vs
    marbl tracer short names)."""
    deep, delta, scale = _BGC_PROFILES_NORM[name.upper()]
    return deep + delta * np.exp(z / scale)


def initial_state(dom: Dict[str, np.ndarray]):
    """Analytic initial fields in joined-file layout: a geostrophically
    balanced coastal jet over stratification."""
    d = dom["coast_dist"]
    mask = dom["mask_rho"]
    f = dom["f"]
    g = 9.81

    zeta = ZAMP * np.exp(-((np.maximum(d, 0.0) - ZCENTER) / ZSCALE) ** 2) \
        * mask

    # geostrophic velocities at rho points from the analytic zeta:
    # d(zeta)/dx = -zeta/ZSCALE * d(d)/dx etc.; coast_dist gradient via
    # finite differences of the analytic field (smooth, exact enough)
    pm, pn = dom["pm"], dom["pn"]
    dzdx = np.zeros_like(zeta)
    dzdy = np.zeros_like(zeta)
    dzdx[:, 1:-1] = 0.5 * (zeta[:, 2:] - zeta[:, :-2]) * pm[:, 1:-1]
    dzdy[1:-1, :] = 0.5 * (zeta[2:, :] - zeta[:-2, :]) * pn[1:-1, :]
    ug = -(g / f) * dzdy
    vg = (g / f) * dzdx

    z_r = _sigma_depths(dom["h"])
    phi = np.exp(z_r / VDECAY)                      # baroclinic structure
    hz = np.empty_like(z_r)
    # layer thickness from rest-state z_w via the same transform
    cs_w, _ = vcoord.stretching_curves(NZ, THETA_S, THETA_B)
    cs_w = np.asarray(cs_w)
    kw = np.arange(NZ + 1)
    sc_w = -1.0 + kw / NZ
    hinv = 1.0 / (dom["h"] + HC)
    z_w = dom["h"][None] * hinv[None] * ((HC * sc_w)[:, None, None]
                                         + cs_w[:, None, None] * dom["h"][None])
    hz = z_w[1:] - z_w[:-1]

    u3r = ug[None] * phi * mask[None]              # at rho points
    v3r = vg[None] * phi * mask[None]
    ubar_r = (u3r * hz).sum(0) / hz.sum(0)
    vbar_r = (v3r * hz).sum(0) / hz.sum(0)

    # average to staggered points (joined-file u: NX+1, v: NY+1)
    u = 0.5 * (u3r[:, :, 1:] + u3r[:, :, :-1])
    v = 0.5 * (v3r[:, 1:, :] + v3r[:, :-1, :])
    ubar = 0.5 * (ubar_r[:, 1:] + ubar_r[:, :-1])
    vbar = 0.5 * (vbar_r[1:, :] + vbar_r[:-1, :])

    temp = t_profile(z_r) + 0.25 * np.exp(z_r / 60.0) * np.sin(
        2.0 * np.pi * (dom["lat_rho"] - LAT_S) / 0.27)[None]
    salt = s_profile(z_r)

    return dict(zeta=zeta, ubar=ubar, vbar=vbar, u=u, v=v,
                temp=temp, salt=salt, z_r=z_r, hz=hz)


# ---------------------------------------------------------------------------
# NetCDF writers (reference-schema example_input_*.nc files)
# ---------------------------------------------------------------------------

def _grid_dims(w: NCWriter):
    w.create_dim("xi_rho", NX + 2)
    w.create_dim("eta_rho", NY + 2)
    w.create_dim("xi_u", NX + 1)
    w.create_dim("eta_v", NY + 1)


def write_grid(path: str, dom: Dict[str, np.ndarray]):
    """example_input_grid.nc (reference reader: src/grid.F get_grid;
    river_flux: src/river_frc.F:46, pipe_flux optional)."""
    with NCWriter(path, attrs={"title": "roms_tpu synthetic USWC sample",
                               "spherical": "T"}) as w:
        _grid_dims(w)
        rho = ("eta_rho", "xi_rho")
        for name in ("lon_rho", "lat_rho", "pm", "pn", "f", "h",
                     "mask_rho", "angle", "river_flux"):
            w.create_var(name, rho)
        for name in ("lon_rho", "lat_rho", "pm", "pn", "f", "h",
                     "mask_rho", "angle", "river_flux"):
            w.write(name, dom[name])


def write_initial(path: str, dom, init, bgc_names: Sequence[str] = ()):
    """example_input_bgc_initial_conditions.nc
    (reference reader: src/get_init.F; BGC tracers by t_vname)."""
    with NCWriter(path, attrs={"title": "synthetic initial conditions"}) as w:
        w.create_dim("time", None)
        _grid_dims(w)
        w.create_dim("s_rho", NZ)
        w.create_dim("s_w", NZ + 1)
        w.create_var("ocean_time", ("time",), attrs={"units": "second"})
        w.create_var("zeta", ("time", "eta_rho", "xi_rho"))
        w.create_var("ubar", ("time", "eta_rho", "xi_u"))
        w.create_var("vbar", ("time", "eta_v", "xi_rho"))
        w.create_var("u", ("time", "s_rho", "eta_rho", "xi_u"))
        w.create_var("v", ("time", "s_rho", "eta_v", "xi_rho"))
        w.create_var("temp", ("time", "s_rho", "eta_rho", "xi_rho"))
        w.create_var("salt", ("time", "s_rho", "eta_rho", "xi_rho"))
        for nm in bgc_names:
            w.create_var(nm, ("time", "s_rho", "eta_rho", "xi_rho"))
        w.write("ocean_time", np.float64(T0_DAYS * DAY), rec=0)
        for nm in ("zeta", "ubar", "vbar", "u", "v", "temp", "salt"):
            w.write(nm, init[nm], rec=0)
        for nm in bgc_names:
            w.write(nm, bgc_profile(nm, init["z_r"]), rec=0)


def _time_var(w: NCWriter, name: str, days, cycle: Optional[float] = None):
    w.create_dim(name, len(days))
    attrs = {"units": "day"}
    if cycle is not None:
        attrs["cycle_length"] = np.float64(cycle)
    w.create_var(name, (name,), attrs=attrs)
    w.write(name, np.asarray(days, np.float64))


def write_flux_forcing(path: str, dom):
    """example_input_surface_flux_forcing.nc (reference reader:
    src/flux_frc.opt nc_sustr/nc_svstr/nc_shflx/nc_swflux/nc_swrad;
    units N/m^2, W/m^2, cm/day — converted on read, flux_frc.F:78-156)."""
    t = T0_DAYS + np.array([-0.5, 0.5, 1.5])
    lat2 = dom["lat_rho"]
    latn = (lat2 - LAT_S) / 0.27
    with NCWriter(path, attrs={"title": "synthetic surface flux forcing"}) as w:
        _grid_dims(w)
        for tn in ("sms_time", "shf_time", "swf_time", "srf_time"):
            _time_var(w, tn, t)
        w.create_var("sustr", ("sms_time", "eta_rho", "xi_u"),
                     attrs={"units": "N/m^2"})
        w.create_var("svstr", ("sms_time", "eta_v", "xi_rho"),
                     attrs={"units": "N/m^2"})
        w.create_var("shflux", ("shf_time", "eta_rho", "xi_rho"),
                     attrs={"units": "W/m^2"})
        w.create_var("swflux", ("swf_time", "eta_rho", "xi_rho"),
                     attrs={"units": "cm/day"})
        w.create_var("swrad", ("srf_time", "eta_rho", "xi_rho"),
                     attrs={"units": "W/m^2"})
        for rec, amp in enumerate((0.8, 1.0, 1.2)):
            sustr = 0.008 * amp * np.ones((NY + 2, NX + 1))
            svstr = -0.055 * amp * (1.0 + 0.2 * np.sin(
                2 * np.pi * latn))[1:, :] * np.ones((NY + 1, NX + 2))
            shflux = (-35.0 + 25.0 * np.cos(2 * np.pi * latn)) * amp
            swflux = 0.12 * amp * np.ones_like(shflux)
            swrad = 185.0 * amp * np.ones_like(shflux)
            w.write("sustr", sustr, rec=rec)
            w.write("svstr", svstr, rec=rec)
            w.write("shflux", shflux, rec=rec)
            w.write("swflux", swflux, rec=rec)
            w.write("swrad", swrad, rec=rec)


def write_boundary_forcing(path: str, dom, init,
                           tracer_names: Sequence[str] = ("temp", "salt"),
                           cycle: Optional[float] = None,
                           suffix_only_bgc: bool = False):
    """example_input_boundary_forcing.nc /
    example_input_bgc_boundary_forcing_clim.nc (reference reader:
    src/boundary.F:43-75; tracer vars named '<t_vname>_<edge>').

    Boundary data is the analytic initial state evaluated at the edges
    (steady records bracketing the run), so the OBCs are consistent with
    the interior at t=0."""
    t = (T0_DAYS + np.array([-1.0, 0.0, 1.0, 2.0]) if cycle is None
         else np.array([30.0, 210.0]))
    fields = {}
    for nm in tracer_names:
        if nm == "temp":
            f3 = init["temp"]
        elif nm == "salt":
            f3 = init["salt"]
        else:
            f3 = bgc_profile(nm, init["z_r"])
        fields[nm] = f3
    with NCWriter(path, attrs={"title": "synthetic boundary forcing"}) as w:
        _grid_dims(w)
        w.create_dim("s_rho", NZ)
        _time_var(w, "bry_time", t, cycle=cycle)
        nrec = len(t)

        def put(name, dims, data):
            w.create_var(name, ("bry_time",) + dims)
            for r in range(nrec):
                w.write(name, data, rec=r)

        if not suffix_only_bgc:
            put("zeta_west", ("eta_rho",), init["zeta"][:, 1])
            put("zeta_east", ("eta_rho",), init["zeta"][:, -2])
            put("zeta_south", ("xi_rho",), init["zeta"][1, :])
            put("zeta_north", ("xi_rho",), init["zeta"][-2, :])
            put("ubar_west", ("eta_rho",), init["ubar"][:, 0])
            put("ubar_east", ("eta_rho",), init["ubar"][:, -1])
            put("ubar_south", ("xi_u",), init["ubar"][1, :])
            put("ubar_north", ("xi_u",), init["ubar"][-2, :])
            put("vbar_west", ("eta_v",), init["vbar"][:, 1])
            put("vbar_east", ("eta_v",), init["vbar"][:, -2])
            put("vbar_south", ("xi_rho",), init["vbar"][0, :])
            put("vbar_north", ("xi_rho",), init["vbar"][-1, :])
            put("u_west", ("s_rho", "eta_rho"), init["u"][:, :, 0])
            put("u_east", ("s_rho", "eta_rho"), init["u"][:, :, -1])
            put("u_south", ("s_rho", "xi_u"), init["u"][:, 1, :])
            put("u_north", ("s_rho", "xi_u"), init["u"][:, -2, :])
            put("v_west", ("s_rho", "eta_v"), init["v"][:, :, 1])
            put("v_east", ("s_rho", "eta_v"), init["v"][:, :, -2])
            put("v_south", ("s_rho", "xi_rho"), init["v"][:, 0, :])
            put("v_north", ("s_rho", "xi_rho"), init["v"][:, -1, :])
        for nm, f3 in fields.items():
            put(f"{nm}_west", ("s_rho", "eta_rho"), f3[:, :, 1])
            put(f"{nm}_east", ("s_rho", "eta_rho"), f3[:, :, -2])
            put(f"{nm}_south", ("s_rho", "xi_rho"), f3[:, 1, :])
            put(f"{nm}_north", ("s_rho", "xi_rho"), f3[:, -2, :])


def write_river_forcing(path: str, ntracers: int = 2, nriv: int = 1):
    """example_input_river_forcing.nc (reference reader:
    src/river_frc.F:46-49,72-73: river_volume(nriv), river_tracer(nriv,nt)
    per record on axis river_time [days])."""
    t = T0_DAYS + np.array([-1.0, 0.0, 1.0, 2.0])
    with NCWriter(path, attrs={"title": "synthetic river forcing"}) as w:
        _time_var(w, "river_time", t)
        w.create_dim("nriver", nriv)
        w.create_dim("ntracers", ntracers)
        w.create_var("river_volume", ("river_time", "nriver"),
                     attrs={"units": "m^3/s"})
        w.create_var("river_tracer", ("river_time", "ntracers", "nriver"))
        for rec, amp in enumerate((0.8, 1.0, 1.2, 1.4)):
            vol = np.full((nriv,), 300.0 * amp)
            trc = np.zeros((ntracers, nriv))
            trc[0] = 16.0          # river temperature [degC]
            if ntracers > 1:
                trc[1] = 2.0       # river salinity [PSU]
            w.write("river_volume", vol, rec=rec)
            w.write("river_tracer", trc, rec=rec)


def write_pipe_forcing(path: str, dom, ntracers: int = 2, npip: int = 1):
    """example_input_pipe_forcing.nc (reference reader:
    src/pipe_frc.F:39-42,115-116: pipe_volume/pipe_tracer series +
    pipe_index/pipe_fraction location fields)."""
    t = T0_DAYS + np.array([-1.0, 0.0, 1.0, 2.0])
    with NCWriter(path, attrs={"title": "synthetic pipe forcing"}) as w:
        _grid_dims(w)
        _time_var(w, "pipe_time", t)
        w.create_dim("npipe", npip)
        w.create_dim("ntracers", ntracers)
        w.create_var("pipe_index", ("eta_rho", "xi_rho"))
        w.create_var("pipe_fraction", ("eta_rho", "xi_rho"))
        w.create_var("pipe_volume", ("pipe_time", "npipe"),
                     attrs={"units": "m^3/s"})
        w.create_var("pipe_tracer", ("pipe_time", "ntracers", "npipe"))
        w.write("pipe_index", dom["pipe_index"])
        w.write("pipe_fraction", dom["pipe_fraction"])
        for rec, amp in enumerate((1.0, 1.0, 1.1, 1.2)):
            w.write("pipe_volume", np.full((npip,), 120.0 * amp), rec=rec)
            trc = np.zeros((ntracers, npip))
            trc[0] = 14.0
            if ntracers > 1:
                trc[1] = 5.0
            w.write("pipe_tracer", trc, rec=rec)


def write_bulk_forcing(path: str, dom):
    """example_input_surface_forcing.nc (reference reader:
    src/bulk_frc.opt: uwnd/vwnd [m/s at 10m], Tair [degC at 2m],
    qair [kg/kg], rain [cm/day], lwrad/swrad [W/m^2], axis 'time')."""
    t = T0_DAYS + np.array([-0.5, 0.0, 0.5, 1.0, 1.5])
    shape = (NY + 2, NX + 2)
    latn = (dom["lat_rho"] - LAT_S) / 0.27
    with NCWriter(path, attrs={"title": "synthetic bulk surface forcing"}) as w:
        _grid_dims(w)
        _time_var(w, "time", t)
        for nm in ("uwnd", "vwnd", "Tair", "qair", "rain", "lwrad", "swrad"):
            w.create_var(nm, ("time", "eta_rho", "xi_rho"))
        for rec in range(len(t)):
            ph = 2.0 * np.pi * rec / len(t)
            w.write("uwnd", np.full(shape, 1.5) + 0.5 * np.cos(ph), rec=rec)
            w.write("vwnd", (-6.0 + np.sin(2 * np.pi * latn)
                             + 0.8 * np.sin(ph)), rec=rec)
            w.write("Tair", np.full(shape, 15.5) + 0.5 * np.sin(ph), rec=rec)
            w.write("qair", np.full(shape, 0.0085), rec=rec)
            w.write("rain", np.full(shape, 0.05), rec=rec)
            w.write("lwrad", np.full(shape, 355.0), rec=rec)
            w.write("swrad", np.full(shape, 180.0 + 40.0 * np.sin(ph)),
                    rec=rec)


# 10 constituents M2 S2 N2 K2 K1 O1 P1 Q1 Mf Mm [rad/s]
TIDE_OMEGA = np.array([1.405189e-4, 1.454441e-4, 1.378797e-4, 1.458423e-4,
                       7.292117e-5, 6.759774e-5, 7.252295e-5, 6.495854e-5,
                       5.323414e-6, 2.639203e-6])
TIDE_ZAMP = np.array([0.36, 0.11, 0.08, 0.03, 0.35, 0.22, 0.11,
                      0.04, 0.01, 0.005])


def write_tides(path: str, dom, ntides: int = 10):
    """example_input_tides.nc (reference reader: src/tides.F:285-342:
    'omega' frequencies + per-constituent ssh/u/v/pot Re/Im fields)."""
    lat2, lon2 = dom["lat_rho"], dom["lon_rho"]
    with NCWriter(path, attrs={"title": "synthetic tides",
                               "data_source": "synthetic equilibrium"}) as w:
        _grid_dims(w)
        w.create_dim("ntides", ntides)
        w.create_var("omega", ("ntides",), attrs={"units": "rad/s"})
        for nm in ("ssh_Re", "ssh_Im", "pot_Re", "pot_Im"):
            w.create_var(nm, ("ntides", "eta_rho", "xi_rho"))
        for nm in ("u_Re", "u_Im"):
            w.create_var(nm, ("ntides", "eta_rho", "xi_u"))
        for nm in ("v_Re", "v_Im"):
            w.create_var(nm, ("ntides", "eta_v", "xi_rho"))
        w.write("omega", TIDE_OMEGA[:ntides])
        # semidiurnal equilibrium ~ cos^2(lat), diurnal ~ sin(2 lat),
        # with a smooth longitude phase
        phase = (lon2 - LON_W) * D2R * 20.0
        z = np.zeros((ntides, NY + 2, NX + 2))
        zi = np.zeros_like(z)
        for k in range(ntides):
            shape_fn = (np.cos(lat2 * D2R) ** 2 if TIDE_OMEGA[k] > 1e-4
                        else np.sin(2 * lat2 * D2R))
            z[k] = TIDE_ZAMP[k] * shape_fn * np.cos(phase + 0.3 * k)
            zi[k] = TIDE_ZAMP[k] * shape_fn * np.sin(phase + 0.3 * k)
        w.write("ssh_Re", z)
        w.write("ssh_Im", zi)
        # potential tide is a few cm
        w.write("pot_Re", 0.10 * z)
        w.write("pot_Im", 0.10 * zi)
        w.write("u_Re", 0.05 * z[:, :, 1:])
        w.write("u_Im", 0.05 * zi[:, :, 1:])
        w.write("v_Re", 0.04 * z[:, 1:, :])
        w.write("v_Im", 0.04 * zi[:, 1:, :])


def write_climatology(path: str, dom, init,
                      tracer_names=("temp", "salt")):
    """example_input_climatology.nc (reference: read_inp_mod.F:1025-1036
    clm_file — whole-grid tracer fields on a cycling monthly axis, the
    alternative source of open-boundary tracer data consumed by
    t3dbc_im.F TCLIMATOLOGY rows)."""
    tmid = np.array([15.2, 45.6, 76.1, 106.5, 136.9, 167.4,
                     197.8, 228.2, 258.7, 289.1, 319.5, 350.0])
    with NCWriter(path, attrs={"title": "synthetic climatology"}) as w:
        _grid_dims(w)
        w.create_dim("s_rho", NZ)
        _time_var(w, "clm_time", tmid, cycle=365.25)
        for nm in tracer_names:
            if nm == "temp":
                f3 = init["temp"]
            elif nm == "salt":
                f3 = init["salt"]
            else:
                f3 = bgc_profile(nm, init["z_r"])
            w.create_var(nm, ("clm_time", "s_rho", "eta_rho", "xi_rho"))
            for rec in range(12):
                seas = (1.0 + 0.05 * np.cos(2 * np.pi * (tmid[rec] / 365.25
                                                         - 0.55))
                        if nm == "temp" else 1.0)
                w.write(nm, f3 * seas, rec=rec)


def write_bgc_surface_clim(path: str, dom):
    """example_input_bgc_surface_forcing_clim.nc (reference reader:
    src/bgc.opt: dust/iron/pco2_air[(_alt)]/nox/nhy/swrad_LFreq on their
    own monthly climatology axes with cycle_length)."""
    tmid = np.array([15.2, 45.6, 76.1, 106.5, 136.9, 167.4,
                     197.8, 228.2, 258.7, 289.1, 319.5, 350.0])
    cyc = 365.25
    shape = (NY + 2, NX + 2)
    latn = (dom["lat_rho"] - LAT_S) / 0.27
    with NCWriter(path, attrs={"title": "synthetic BGC surface clim"}) as w:
        _grid_dims(w)
        for tn in ("dust_time", "iron_time", "pco2_time", "nox_time",
                   "nhy_time", "rad_time_LFreq"):
            _time_var(w, tn, tmid, cycle=cyc)
        w.create_var("dust", ("dust_time", "eta_rho", "xi_rho"),
                     attrs={"units": "kg/m2/s"})
        w.create_var("iron", ("iron_time", "eta_rho", "xi_rho"),
                     attrs={"units": "nmol/cm2/s"})
        w.create_var("pco2_air", ("pco2_time", "eta_rho", "xi_rho"),
                     attrs={"units": "ppmv"})
        w.create_var("pco2_air_alt", ("pco2_time", "eta_rho", "xi_rho"),
                     attrs={"units": "ppmv"})
        w.create_var("nox", ("nox_time", "eta_rho", "xi_rho"),
                     attrs={"units": "nmol/cm2/s"})
        w.create_var("nhy", ("nhy_time", "eta_rho", "xi_rho"),
                     attrs={"units": "nmol/cm2/s"})
        w.create_var("swrad_LFreq", ("rad_time_LFreq", "eta_rho", "xi_rho"),
                     attrs={"units": "W/m^2"})
        for rec in range(12):
            seas = 1.0 + 0.4 * np.cos(2 * np.pi * (tmid[rec] / cyc - 0.55))
            w.write("dust", 6.0e-10 * seas * (1.0 + 0.2 * latn), rec=rec)
            w.write("iron", 1.2e-3 * seas * (1.0 + 0.2 * latn), rec=rec)
            w.write("pco2_air", np.full(shape, 421.0), rec=rec)
            w.write("pco2_air_alt", np.full(shape, 284.0), rec=rec)
            w.write("nox", 8.0e-11 * seas * np.ones(shape), rec=rec)
            w.write("nhy", 5.0e-11 * seas * np.ones(shape), rec=rec)
            w.write("swrad_LFreq", 180.0 * seas * np.ones(shape), rec=rec)


def write_cdr_parm(path: str, ntracers: int, ialk: int, idic: int,
                   ncdr: int = 1):
    """cdr_forcing_parm.nc (reference reader: src/cdr_frc.F:264-292
    parameterized mode: cdr_lon/lat/dep/hsc/vsc + cdr_trcflx(ncdr,nt))."""
    dom_ = domain()
    jp = (2 * NY) // 3
    d = dom_["coast_dist"]
    ip = int(np.argmin(np.abs(d[jp] - 4.0e3)))
    t = T0_DAYS + np.array([-1.0, 1.0])
    with NCWriter(path, attrs={"title": "synthetic CDR parameterized"}) as w:
        _time_var(w, "cdr_time", t)
        w.create_dim("ncdr", ncdr)
        w.create_dim("ntracers", ntracers)
        for nm, val in (("cdr_lon", dom_["lon_rho"][jp, ip]),
                        ("cdr_lat", dom_["lat_rho"][jp, ip]),
                        ("cdr_dep", 15.0), ("cdr_hsc", 1200.0),
                        ("cdr_vsc", 8.0)):
            w.create_var(nm, ("ncdr",))
            w.write(nm, np.full((ncdr,), val))
        w.create_var("cdr_trcflx", ("cdr_time", "ntracers", "ncdr"),
                     attrs={"units": "mmol/s"})
        flx = np.zeros((ntracers, ncdr))
        flx[ialk] = 5.0e4
        flx[idic] = -1.0e4
        for rec in range(len(t)):
            w.write("cdr_trcflx", flx, rec=rec)


def write_cdr_dp(path: str, n_src: int = 50, ncdr: int = 2):
    """cdr_forcing_dp.nc (reference reader: src/cdr_frc.F:189-243:
    dimension ncdr_prof, cdr_layer_thickness(ncdr,N_src),
    cdr_trcflx_profile(ncdr,2,N_src) per record, rows = (ALK, DIC))."""
    dom_ = domain()
    d = dom_["coast_dist"]
    locs = []
    for jfrac in (0.35, 0.65):
        jp = int(jfrac * NY)
        ip = int(np.argmin(np.abs(d[jp] - 5.0e3)))
        locs.append((jp, ip))
    t = T0_DAYS + np.array([-1.0, 1.0])
    with NCWriter(path, attrs={"title": "synthetic CDR depth profiles"}) as w:
        _time_var(w, "cdr_time", t)
        w.create_dim("ncdr_prof", ncdr)
        w.create_dim("n_src", n_src)
        w.create_dim("nrows", 2)
        for nm, vals in (("cdr_lon", [dom_["lon_rho"][j, i] for j, i in locs]),
                         ("cdr_lat", [dom_["lat_rho"][j, i] for j, i in locs])):
            w.create_var(nm, ("ncdr_prof",))
            w.write(nm, np.asarray(vals))
        w.create_var("cdr_layer_thickness", ("cdr_time", "n_src", "ncdr_prof"))
        w.create_var("cdr_trcflx_profile",
                     ("cdr_time", "n_src", "nrows", "ncdr_prof"))
        # uniform 2 m source layers; Gaussian-in-depth ALK addition around
        # 20 m, small DIC removal
        hz_src = np.full((n_src, ncdr), 2.0)
        zc = -(np.cumsum(hz_src[:, 0]) - 1.0)
        prof = np.exp(-((zc + 20.0) / 10.0) ** 2)
        prof = prof / prof.sum()
        p = np.zeros((n_src, 2, ncdr))
        for ic in range(ncdr):
            p[:, 0, ic] = 4.0e4 * prof       # ALK [mmol/s per layer]
            p[:, 1, ic] = -0.8e4 * prof      # DIC
        for rec in range(len(t)):
            w.write("cdr_layer_thickness", hz_src, rec=rec)
            w.write("cdr_trcflx_profile", p, rec=rec)


def write_cdr_3d(path: str, dom, nz: int = NZ):
    """cdr_forcing_3d.nc (reference reader: src/cdr_frc.F:111-114,521-522:
    cdr_trcflx_3d_ALK/DIC(eta,xi,nz) per record)."""
    t = T0_DAYS + np.array([-1.0, 1.0])
    d = dom["coast_dist"]
    jp, ipk = NY // 2, None
    ipk = int(np.argmin(np.abs(d[jp] - 6.0e3)))
    lon2, lat2 = dom["lon_rho"], dom["lat_rho"]
    r2 = (((lon2 - lon2[jp, ipk]) * np.cos(lat2 * D2R)) ** 2
          + (lat2 - lat2[jp, ipk]) ** 2) * (R_EARTH * D2R) ** 2
    foot = np.exp(-r2 / 3.0e3 ** 2) * dom["mask_rho"]
    z_r = _sigma_depths(dom["h"])
    vert = np.exp(-((z_r + 25.0) / 12.0) ** 2)
    field = foot[None] * vert
    tot = field.sum()
    with NCWriter(path, attrs={"title": "synthetic CDR 3D forcing"}) as w:
        _grid_dims(w)
        w.create_dim("s_rho", nz)
        _time_var(w, "cdr_time", t)
        w.create_var("cdr_trcflx_3d_ALK", ("cdr_time", "s_rho",
                                           "eta_rho", "xi_rho"))
        w.create_var("cdr_trcflx_3d_DIC", ("cdr_time", "s_rho",
                                           "eta_rho", "xi_rho"))
        for rec in range(len(t)):
            w.write("cdr_trcflx_3d_ALK", 6.0e4 * field / tot, rec=rec)
            w.write("cdr_trcflx_3d_DIC", -1.2e4 * field / tot, rec=rec)


# ---------------------------------------------------------------------------
# one-call generation with caching
# ---------------------------------------------------------------------------

SCHEMA_VERSION = 4


def generate_inputs(dirpath: str,
                    bgc_names: Sequence[str] = (),
                    ntracers: int = 2,
                    ialk: Optional[int] = None,
                    idic: Optional[int] = None) -> Dict[str, str]:
    """Write every input file the real-data cases reference into `dirpath`
    (cached: re-used if the stamp matches).  Returns name -> path."""
    os.makedirs(dirpath, exist_ok=True)
    stamp = os.path.join(
        dirpath, f"_v{SCHEMA_VERSION}_nt{ntracers}_bgc{len(bgc_names)}.ok")
    names = {
        "grid": "example_input_grid.nc",
        "initial": "example_input_bgc_initial_conditions.nc",
        "flux": "example_input_surface_flux_forcing.nc",
        "boundary": "example_input_boundary_forcing.nc",
        "river": "example_input_river_forcing.nc",
        "pipe": "example_input_pipe_forcing.nc",
        "bulk": "example_input_surface_forcing.nc",
        "tides": "example_input_tides.nc",
        "bgc_clim": "example_input_bgc_surface_forcing_clim.nc",
        "bgc_bry": "example_input_bgc_boundary_forcing_clim.nc",
        "cdr_parm": "cdr_forcing_parm.nc",
        "cdr_dp": "cdr_forcing_dp.nc",
        "cdr_3d": "cdr_forcing_3d.nc",
    }
    paths = {k: os.path.join(dirpath, v) for k, v in names.items()}
    if os.path.exists(stamp) and all(os.path.exists(p)
                                     for p in paths.values()):
        return paths

    dom = domain()
    init = initial_state(dom)
    write_grid(paths["grid"], dom)
    write_initial(paths["initial"], dom, init, bgc_names=bgc_names)
    write_flux_forcing(paths["flux"], dom)
    write_boundary_forcing(paths["boundary"], dom, init)
    write_river_forcing(paths["river"], ntracers=ntracers)
    write_pipe_forcing(paths["pipe"], dom, ntracers=ntracers)
    write_bulk_forcing(paths["bulk"], dom)
    write_tides(paths["tides"], dom)
    write_bgc_surface_clim(paths["bgc_clim"], dom)
    write_boundary_forcing(paths["bgc_bry"], dom, init,
                           tracer_names=bgc_names, cycle=365.25,
                           suffix_only_bgc=True)
    ia = ialk if ialk is not None else max(ntracers - 1, 0)
    idc = idic if idic is not None else max(ntracers - 2, 0)
    write_cdr_parm(paths["cdr_parm"], ntracers=ntracers, ialk=ia, idic=idc)
    write_cdr_dp(paths["cdr_dp"])
    write_cdr_3d(paths["cdr_3d"], dom)
    with open(stamp, "w") as f:
        f.write("ok\n")
    return paths


def build_case(workdir: str, infile_name: str, benchmark_in: str,
               base_cfg, ntimes: int, dtype, device):
    """Write the inputs under `workdir`/input_data and the case's roms.in
    text as `workdir`/`infile_name`, then assemble the run on `device`
    (the `build` of Flux_frc, Rivers_real and Pipes_real)."""
    from roms_tpu_torch.experiment import assemble
    inp = os.path.join(workdir, "input_data")
    generate_inputs(inp)
    infile = os.path.join(workdir, infile_name)
    with open(infile, "w") as f:
        f.write(benchmark_in.format(inp=inp, ntimes=ntimes))
    return assemble(infile, base_cfg, tracer_names=("temp", "salt"),
                    nz=NZ, dtype=dtype, device=device)
