"""Grid generation (a numpy copy of roms_tpu/tools/grid_gen.py): the
pre-processing step the reference ecosystem does
in MATLAB / the external `roms-tools` package (reference workflow:
docs/tutorials/nested_cdr_tutorial — grids arrive as NetCDF with
h/pm/pn/f/mask_rho/lon_rho/lat_rho/angle; consumed by src/grid.F
get_grid and checked by src/setup_grid1.F / grid_stiffness.F).

Everything a reference user needs to go from "a bathymetry dataset and a
bounding box" to a runnable grid file:

  * `make_lonlat_grid` — rotated tangent-plane lon/lat mesh (the
    easy-grid construction) at a chosen center/size/resolution;
  * `spherical_metrics` — pm/pn/f/angle from the lon/lat mesh by
    centered great-circle differences (reference: the same metric
    definitions src/setup_grid1.F:24-61 uses when reading them);
  * `prune_isolated_wet` — keep the largest connected wet region, the
    analog of the reference's etch-into-land cleanup
    (reference: Tools-Roms/etch_into_land.F);
  * `smooth_topo_log` — Mellor-Ezer-Oey logarithmic bathymetry
    smoothing to a target stiffness rx0 (the standard sigma-coordinate
    pre-conditioning the reference checks at startup,
    src/grid_stiffness.F:1-40);
  * `write_grid` / `generate_grid` — reference-convention NetCDF
    output directly readable by `roms_tpu_torch.io.input.read_grid` (and by
    the reference's get_grid).

Host-side numpy: grid prep runs offline, like the reference tools.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np

R_EARTH = 6371315.0          # [m] (reference: src/scoord.F lineage value)
OMEGA = 7.292115e-5          # [1/s] Earth rotation
DEG = np.pi / 180.0


# ---------------------------------------------------------------------------
# mesh construction
# ---------------------------------------------------------------------------

def make_lonlat_grid(lon_c: float, lat_c: float, size_x: float,
                     size_y: float, nx: int, ny: int,
                     rotation: float = 0.0):
    """Rho-point lon/lat mesh of an (nx, ny)-interior grid including the
    one-point boundary ring (shapes (ny+2, nx+2) — the reference's
    joined-grid-file convention, 0..Lm+1).

    The grid is a plane tangent at (lon_c, lat_c), rotated by `rotation`
    degrees counterclockwise, with total extent size_x/size_y meters —
    the easy-grid construction used by the reference ecosystem's
    grid-generation tooling.
    """
    dx = size_x / nx
    dy = size_y / ny
    # cell-center offsets incl. boundary ring
    xs = (np.arange(nx + 2, dtype=np.float64) - 0.5 * (nx + 1)) * dx
    ys = (np.arange(ny + 2, dtype=np.float64) - 0.5 * (ny + 1)) * dy
    x, y = np.meshgrid(xs, ys)
    ang = rotation * DEG
    xr = x * np.cos(ang) - y * np.sin(ang)
    yr = x * np.sin(ang) + y * np.cos(ang)
    lat = lat_c + yr / (R_EARTH * DEG)
    lon = lon_c + xr / (R_EARTH * DEG * np.cos(lat * DEG))
    return lon, lat


def spherical_metrics(lon_r: np.ndarray, lat_r: np.ndarray):
    """pm/pn (inverse metric coefficients [1/m]), Coriolis f and local
    grid `angle` [rad] from rho-point lon/lat, by centered great-circle
    differences (one-sided at the ring edge)."""
    def gc_dist(lo1, la1, lo2, la2):
        dlo = (lo2 - lo1) * DEG
        dla = (la2 - la1) * DEG
        a = (np.sin(0.5 * dla) ** 2
             + np.cos(la1 * DEG) * np.cos(la2 * DEG)
             * np.sin(0.5 * dlo) ** 2)
        return 2.0 * R_EARTH * np.arcsin(np.minimum(np.sqrt(a), 1.0))

    def centered(lon, lat, axis):
        d = np.empty_like(lon)
        sl_m = [slice(None)] * 2
        sl_p = [slice(None)] * 2
        sl_c = [slice(None)] * 2
        sl_m[axis] = slice(0, -2)
        sl_p[axis] = slice(2, None)
        sl_c[axis] = slice(1, -1)
        d[tuple(sl_c)] = 0.5 * gc_dist(lon[tuple(sl_m)], lat[tuple(sl_m)],
                                       lon[tuple(sl_p)], lat[tuple(sl_p)])
        # one-sided at the ring
        sl_0 = [slice(None)] * 2
        sl_1 = [slice(None)] * 2
        sl_0[axis] = 0
        sl_1[axis] = 1
        d[tuple(sl_0)] = gc_dist(lon[tuple(sl_0)], lat[tuple(sl_0)],
                                 lon[tuple(sl_1)], lat[tuple(sl_1)])
        sl_0[axis] = -1
        sl_1[axis] = -2
        d[tuple(sl_0)] = gc_dist(lon[tuple(sl_0)], lat[tuple(sl_0)],
                                 lon[tuple(sl_1)], lat[tuple(sl_1)])
        return d

    dx = centered(lon_r, lat_r, axis=1)
    dy = centered(lon_r, lat_r, axis=0)
    pm = 1.0 / dx
    pn = 1.0 / dy
    f = 2.0 * OMEGA * np.sin(lat_r * DEG)
    # local XI direction relative to east
    dlon = np.gradient(lon_r, axis=1) * np.cos(lat_r * DEG)
    dlat = np.gradient(lat_r, axis=1)
    angle = np.arctan2(dlat, dlon)
    return pm, pn, f, angle


# ---------------------------------------------------------------------------
# mask cleanup (reference: Tools-Roms/etch_into_land.F)
# ---------------------------------------------------------------------------

def prune_isolated_wet(rmask: np.ndarray, min_frac: float = 0.0):
    """Keep only the largest 4-connected wet region; isolated ponds and
    lakes become land (they cannot exchange with the open ocean and trap
    the free surface).  Returns the cleaned mask."""
    from scipy import ndimage
    wet = rmask > 0.5
    labels, nlab = ndimage.label(wet)
    if nlab <= 1:
        return (wet).astype(np.float64)
    sizes = ndimage.sum(wet, labels, index=np.arange(1, nlab + 1))
    keep = 1 + int(np.argmax(sizes))
    out = (labels == keep)
    if min_frac > 0.0:
        out |= np.isin(labels, 1 + np.nonzero(
            sizes >= min_frac * sizes.max())[0])
    return out.astype(np.float64)


# ---------------------------------------------------------------------------
# bathymetry smoothing (Mellor, Ezer & Oey 1994 log-sigma conditioning)
# ---------------------------------------------------------------------------

def rx0_of(h: np.ndarray, rmask: np.ndarray) -> float:
    """Beckmann-Haidvogel stiffness over wet cell faces
    (reference: src/grid_stiffness.F:12-28)."""
    wet = rmask > 0.5
    r = 0.0
    for ax in (0, 1):
        h1 = np.moveaxis(h, ax, 0)[:-1]
        h2 = np.moveaxis(h, ax, 0)[1:]
        w = np.moveaxis(wet, ax, 0)[:-1] & np.moveaxis(wet, ax, 0)[1:]
        rr = np.abs(h1 - h2) / np.maximum(h1 + h2, 1e-30)
        if w.any():
            r = max(r, float(rr[w].max()))
    return r


def smooth_topo_log(h: np.ndarray, rmask: np.ndarray, rx0_max: float = 0.2,
                    max_iter: int = 200) -> np.ndarray:
    """Iteratively limit log-depth differences between adjacent wet cells
    until rx0 <= rx0_max everywhere (the Mellor-Ezer-Oey scheme: the
    constraint |h1-h2|/(h1+h2) <= r is |log h1 - log h2| <=
    log((1+r)/(1-r)); each violating pair moves symmetrically in log
    space, preserving the pair's geometric-mean depth)."""
    assert 0.0 < rx0_max < 1.0
    lh = np.log(np.maximum(np.asarray(h, np.float64), 1e-3))
    wet = rmask > 0.5
    dmax = np.log((1.0 + rx0_max) / (1.0 - rx0_max))
    for _ in range(max_iter):
        changed = False
        for ax in (0, 1):
            l = np.moveaxis(lh, ax, 0)
            w = np.moveaxis(wet, ax, 0)
            d = l[1:] - l[:-1]
            pair = w[1:] & w[:-1]
            excess = np.where(pair, np.sign(d)
                              * np.maximum(np.abs(d) - dmax, 0.0), 0.0)
            if np.any(excess != 0.0):
                changed = True
                l[1:] -= 0.5 * excess
                l[:-1] += 0.5 * excess
        if not changed:
            break
    out = np.exp(lh)
    return np.where(wet, out, h)


# ---------------------------------------------------------------------------
# output
# ---------------------------------------------------------------------------

def write_grid(path: str, h, pm, pn, f, rmask, lon_r=None, lat_r=None,
               angle=None, attrs: Optional[Dict] = None):
    """Write a reference-convention grid file (variables as read by
    src/grid.F get_grid and roms_tpu_torch.io.input.read_grid)."""
    from roms_tpu_torch.io.netcdf import NCWriter
    ny2, nx2 = np.asarray(h).shape
    base = {"type": "ROMS grid file", "generator": "roms_tpu_torch grid_gen",
            "spherical": "T" if lon_r is not None else "F"}
    base.update(attrs or {})
    with NCWriter(path, attrs=base) as w:
        w.create_dim("eta_rho", ny2)
        w.create_dim("xi_rho", nx2)
        dims = ("eta_rho", "xi_rho")
        fields = {"h": h, "pm": pm, "pn": pn, "f": f, "mask_rho": rmask}
        if lon_r is not None:
            fields["lon_rho"] = lon_r
        if lat_r is not None:
            fields["lat_rho"] = lat_r
        if angle is not None:
            fields["angle"] = angle
        units = {"h": "meter", "pm": "meter-1", "pn": "meter-1",
                 "f": "second-1", "lon_rho": "degree_east",
                 "lat_rho": "degree_north", "angle": "radians"}
        for name, data in fields.items():
            at = {"units": units[name]} if name in units else {}
            w.create_var(name, dims, "f8", attrs=at)
            w.write(name, np.asarray(data, np.float64))


def generate_grid(lon_c: float, lat_c: float, size_x: float, size_y: float,
                  nx: int, ny: int,
                  bathymetry: Callable[[np.ndarray, np.ndarray], np.ndarray],
                  rotation: float = 0.0, hmin: float = 5.0,
                  hmax: Optional[float] = None, rx0_max: float = 0.2,
                  mask_from_depth: float = 0.0,
                  path: Optional[str] = None) -> Dict[str, np.ndarray]:
    """End-to-end grid generation.

    bathymetry: callable (lon, lat) -> positive depth [m] (negative or
    < mask_from_depth values become land).  Returns the field dict; also
    writes `path` when given.
    """
    lon_r, lat_r = make_lonlat_grid(lon_c, lat_c, size_x, size_y, nx, ny,
                                    rotation)
    pm, pn, f, angle = spherical_metrics(lon_r, lat_r)
    hraw = np.asarray(bathymetry(lon_r, lat_r), np.float64)
    rmask = prune_isolated_wet((hraw > mask_from_depth).astype(np.float64))
    h = np.clip(hraw, hmin, hmax if hmax is not None else np.inf)
    h = smooth_topo_log(h, rmask, rx0_max=rx0_max)
    h = np.where(rmask > 0.5, h, hmin)
    out = {"h": h, "hraw": hraw, "pm": pm, "pn": pn, "f": f,
           "mask_rho": rmask, "lon_rho": lon_r, "lat_rho": lat_r,
           "angle": angle}
    if path is not None:
        write_grid(path, h, pm, pn, f, rmask, lon_r, lat_r, angle,
                   attrs={"rx0_max": rx0_max, "hmin": hmin})
    return out


def main(argv=None):
    import argparse
    p = argparse.ArgumentParser(
        prog="roms_tpu_torch.tools.grid_gen",
        description="Generate a ROMS grid file (easy-grid construction)")
    p.add_argument("out", help="output grid NetCDF path")
    p.add_argument("--center", nargs=2, type=float, required=True,
                   metavar=("LON", "LAT"))
    p.add_argument("--size-km", nargs=2, type=float, required=True,
                   metavar=("SX", "SY"))
    p.add_argument("--shape", nargs=2, type=int, required=True,
                   metavar=("NX", "NY"))
    p.add_argument("--rotation", type=float, default=0.0)
    p.add_argument("--hmin", type=float, default=5.0)
    p.add_argument("--hmax", type=float, default=None)
    p.add_argument("--rx0", type=float, default=0.2)
    p.add_argument("--flat-depth", type=float, default=None,
                   help="use a constant-depth bathymetry (testing)")
    p.add_argument("--bathy-npz", default=None,
                   help="npz with lon (nx,), lat (ny,), depth (ny, nx) "
                        "sampled bilinearly (positive down)")
    a = p.parse_args(argv)

    if a.bathy_npz:
        d = np.load(a.bathy_npz)
        blon, blat, bdep = (np.asarray(d["lon"]), np.asarray(d["lat"]),
                            np.asarray(d["depth"]))

        def bathy(lon, lat):
            from scipy.interpolate import RegularGridInterpolator
            it = RegularGridInterpolator((blat, blon), bdep,
                                         bounds_error=False, fill_value=0.0)
            return it(np.stack([lat.ravel(), lon.ravel()], -1)
                      ).reshape(lon.shape)
    elif a.flat_depth is not None:
        def bathy(lon, lat):
            return np.full_like(lon, a.flat_depth)
    else:
        p.error("one of --bathy-npz / --flat-depth is required")

    out = generate_grid(a.center[0], a.center[1],
                        a.size_km[0] * 1e3, a.size_km[1] * 1e3,
                        a.shape[0], a.shape[1], bathy,
                        rotation=a.rotation, hmin=a.hmin, hmax=a.hmax,
                        rx0_max=a.rx0, path=a.out)
    print(f"wrote {a.out}: {out['h'].shape[1] - 2}x{out['h'].shape[0] - 2} "
          f"interior, rx0={rx0_of(out['h'], out['mask_rho']):.3f}, "
          f"wet fraction {float(out['mask_rho'].mean()):.2f}")


if __name__ == "__main__":
    main()
