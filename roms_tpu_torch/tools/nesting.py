"""ROMS-to-ROMS nesting preprocessors (a numpy copy of
roms_tpu/tools/nesting.py on the port's `remap`): build child-grid
initial and boundary data from parent-model output
(reference: Tools-Roms/r2r_bry*.F, r2r_init.F, r2r_match_topo.F —
horizontal interpolation of parent fields to child boundary/interior
points, vector rotation, and vertical remapping onto the child levels).

Host-side numpy: these run offline between a parent run and a child run,
like the reference tools.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np

from roms_tpu_torch.remap import remap_src_to_grid


def locate_in_grid(lon_g: np.ndarray, lat_g: np.ndarray,
                   lon_t: np.ndarray, lat_t: np.ndarray,
                   iters: int = 8) -> Tuple[np.ndarray, np.ndarray]:
    """Invert a curvilinear coordinate grid: fractional (xi, eta) indices
    of target points (the core geometric step of r2r interpolation,
    reference: Tools-Roms/r2r_interp approach).

    lon_g/lat_g: (ny, nx) parent coordinates; lon_t/lat_t: (npts,).
    Newton iteration on the local bilinear map from nearest-cell starts.
    """
    ny, nx = lon_g.shape
    lon_t = np.atleast_1d(np.asarray(lon_t, np.float64))
    lat_t = np.atleast_1d(np.asarray(lat_t, np.float64))

    # nearest grid point (brute force is fine for tool-scale grids)
    d2 = ((lon_g[None] - lon_t[:, None, None]) ** 2
          + (lat_g[None] - lat_t[:, None, None]) ** 2)
    flat = d2.reshape(lon_t.size, -1).argmin(axis=1)
    j0, i0 = np.unravel_index(flat, (ny, nx))
    i0 = np.clip(i0, 0, nx - 2).astype(np.float64)
    j0 = np.clip(j0, 0, ny - 2).astype(np.float64)

    px = i0.copy()
    py = j0.copy()
    for _ in range(iters):
        ii = np.clip(np.floor(px).astype(int), 0, nx - 2)
        jj = np.clip(np.floor(py).astype(int), 0, ny - 2)
        x = px - ii
        y = py - jj

        def corners(g):
            return (g[jj, ii], g[jj, ii + 1], g[jj + 1, ii],
                    g[jj + 1, ii + 1])

        lo00, lo01, lo10, lo11 = corners(lon_g)
        la00, la01, la10, la11 = corners(lat_g)
        lon_e = ((1 - y) * ((1 - x) * lo00 + x * lo01)
                 + y * ((1 - x) * lo10 + x * lo11))
        lat_e = ((1 - y) * ((1 - x) * la00 + x * la01)
                 + y * ((1 - x) * la10 + x * la11))
        # Jacobian of the bilinear map
        dlon_dx = (1 - y) * (lo01 - lo00) + y * (lo11 - lo10)
        dlon_dy = (1 - x) * (lo10 - lo00) + x * (lo11 - lo01)
        dlat_dx = (1 - y) * (la01 - la00) + y * (la11 - la10)
        dlat_dy = (1 - x) * (la10 - la00) + x * (la11 - la01)
        det = dlon_dx * dlat_dy - dlon_dy * dlat_dx
        det = np.where(np.abs(det) < 1e-30, 1e-30, det)
        rl = lon_t - lon_e
        rb = lat_t - lat_e
        px = px + (rl * dlat_dy - rb * dlon_dy) / det
        py = py + (rb * dlon_dx - rl * dlat_dx) / det
        px = np.clip(px, 0.0, nx - 1.0)
        py = np.clip(py, 0.0, ny - 1.0)
    return px, py


def interp_at(field: np.ndarray, px: np.ndarray, py: np.ndarray) -> np.ndarray:
    """Bilinear sample of (..., ny, nx) at fractional indices."""
    ny, nx = field.shape[-2:]
    ii = np.clip(np.floor(px).astype(int), 0, nx - 2)
    jj = np.clip(np.floor(py).astype(int), 0, ny - 2)
    x = px - ii
    y = py - jj
    return ((1 - y) * ((1 - x) * field[..., jj, ii]
                       + x * field[..., jj, ii + 1])
            + y * ((1 - x) * field[..., jj + 1, ii]
                   + x * field[..., jj + 1, ii + 1]))


def remap_columns(vals: np.ndarray, hz_src: np.ndarray,
                  hz_dst: np.ndarray) -> np.ndarray:
    """Conservative vertical remap of (nz_src, npts) columns onto
    (nz_dst, npts) child layers (reference: r2r vertical interpolation via
    the same PPR machinery as CDR profiles)."""
    nz_dst, npts = hz_dst.shape
    out = np.zeros((nz_dst, npts))
    for p in range(npts):
        out[:, p] = remap_src_to_grid(hz_src[:, p], vals[:, p], hz_dst[:, p])
    return out


def child_boundary_from_parent(
        parent: Dict[str, np.ndarray], child_edges: Dict[str, Dict],
        out_path: str, tracer_names: Sequence[str] = ("temp",),
        times: np.ndarray = None) -> str:
    """Generate a child boundary-forcing file from parent output
    (reference: Tools-Roms/r2r_bry.F).

    parent: dict with lon/lat (ny,nx), hz (nt_rec?, nz, ny, nx) or
        (nz, ny, nx), zeta/ubar/vbar (nrec, ny, nx), tracers
        (nrec, nz, ny, nx), angle (optional).
    child_edges: edge name -> dict(lon (npts,), lat (npts,),
        hz (nz_child, npts)).
    """
    from roms_tpu_torch.io.netcdf import NCWriter
    zeta = parent["zeta"]
    nrec = zeta.shape[0]
    if times is None:
        times = np.arange(nrec, dtype=np.float64)

    w = NCWriter(out_path, {"type": "ROMS-TPU boundary file (r2r)"})
    w.create_dim("bry_time", None)
    w.create_var("bry_time", ("bry_time",), "f8", {"units": "second"})
    edge_locs = {}
    for edge, spec in child_edges.items():
        px, py = locate_in_grid(parent["lon"], parent["lat"],
                                spec["lon"], spec["lat"])
        edge_locs[edge] = (px, py, spec["hz"])
        npts = px.size
        nzc = spec["hz"].shape[0]
        w.create_dim(f"np_{edge}", npts)
        if "s_rho" not in w.dimensions:
            w.create_dim("s_rho", nzc)
        w.create_var(f"zeta_{edge}", ("bry_time", f"np_{edge}"), "f8")
        w.create_var(f"ubar_{edge}", ("bry_time", f"np_{edge}"), "f8")
        w.create_var(f"vbar_{edge}", ("bry_time", f"np_{edge}"), "f8")
        for tn in tracer_names:
            w.create_var(f"{tn}_{edge}", ("bry_time", "s_rho", f"np_{edge}"),
                         "f8")

    hz_p = parent["hz"]
    static_hz = hz_p.ndim == 3
    for r in range(nrec):
        w.write("bry_time", float(times[r]), rec=r)
        for edge, (px, py, hz_c) in edge_locs.items():
            w.write(f"zeta_{edge}", interp_at(zeta[r], px, py), rec=r)
            # rho-averaged barotropic velocities with optional rotation
            ub = interp_at(parent["ubar"][r], px, py)
            vb = interp_at(parent["vbar"][r], px, py)
            if "angle" in parent:
                ang = interp_at(parent["angle"], px, py)
                ub, vb = (ub * np.cos(ang) - vb * np.sin(ang),
                          ub * np.sin(ang) + vb * np.cos(ang))
            w.write(f"ubar_{edge}", ub, rec=r)
            w.write(f"vbar_{edge}", vb, rec=r)
            hz_src_cols = interp_at(hz_p if static_hz else hz_p[r], px, py)
            for tn in tracer_names:
                cols = interp_at(parent[tn][r], px, py)  # (nz_p, npts)
                w.write(f"{tn}_{edge}",
                        remap_columns(cols, hz_src_cols, hz_c), rec=r)
    w.close()
    return out_path


def match_topo(h_child: "np.ndarray", h_parent_on_child: "np.ndarray",
               rmask: "np.ndarray", edges=("west", "east", "south",
                                           "north"),
               width: int = 15):
    """Blend child topography toward the parent's near forced open
    boundaries (reference: Tools-Roms/r2r_match_topo.F:3-22):

        h_matched = (1 - wgt) * h_child + wgt * h_parent

    wgt = 1 at the open boundaries, 0 beyond the merging zone, with a
    smooth cosine transition.  The merging weight is propagated only
    through WATER (the reference's mask "etching": land-blocked areas
    near the edge must not merge) via a breadth-first distance transform
    over unmasked cells.
    """
    import numpy as np

    h = np.asarray(h_child, np.float64)
    hp = np.asarray(h_parent_on_child, np.float64)
    m = np.asarray(rmask) > 0.5
    ny, nx = h.shape

    # water-only distance (in cells) from the selected open edges
    INF = np.iinfo(np.int32).max
    dist = np.full((ny, nx), INF, np.int32)
    from collections import deque
    q = deque()

    def seed(jj, ii):
        if m[jj, ii] and dist[jj, ii] != 0:
            dist[jj, ii] = 0
            q.append((jj, ii))

    if "west" in edges:
        for j in range(ny):
            seed(j, 0)
    if "east" in edges:
        for j in range(ny):
            seed(j, nx - 1)
    if "south" in edges:
        for i in range(nx):
            seed(0, i)
    if "north" in edges:
        for i in range(nx):
            seed(ny - 1, i)
    while q:
        j, i = q.popleft()
        d = dist[j, i] + 1
        if d > width:
            continue
        for jj, ii in ((j - 1, i), (j + 1, i), (j, i - 1), (j, i + 1)):
            if 0 <= jj < ny and 0 <= ii < nx and m[jj, ii] \
                    and dist[jj, ii] > d:
                dist[jj, ii] = d
                q.append((jj, ii))

    frac = np.clip(dist.astype(np.float64) / width, 0.0, 1.0)
    frac[dist == INF] = 1.0
    wgt = 0.5 * (1.0 + np.cos(np.pi * frac))     # 1 at edge, 0 interior
    return (1.0 - wgt) * h + wgt * hp
