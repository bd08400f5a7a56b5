"""The nested parent/child workflow on the open basin, after the
reference's Iceland tutorial (reference: Examples/Iceland/{Iceland_parent,
Iceland_child,Iceland_parent_with_upscaling}; src/extract_data.F,
Tools-Roms/r2r_bry.F, src/sponge_tune.F, src/upscale_output.F), as
tests/test_nested_flow.py drives it in the JAX package:

  parent run with boundary extraction objects at the child perimeter
    -> child bathymetry blended onto the parent's (match_topo)
    -> child boundary series from the extraction file (r2r-style)
    -> child run with Orlanski boundaries bound to the parent data, the
       binding auto-tuned from the child's fast pressure flux against
       the parent's (calc_pflx, adjust_orlanski), the upscale capture on
       and written by `UpscaleWriter`
    -> the captured boundary fluxes re-force the parent as a dense
       CDR-style source (Iceland_parent_with_upscaling).

`run_flow` returns the numbers the workflow is judged by; the sizes are
the test's: parent and child 32x32x6, 8 steps each, the child at dt = 30 s.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from roms_tpu_torch.cases import obc_basin
from roms_tpu_torch.cdr import cdr_3d
from roms_tpu_torch.driver import run
from roms_tpu_torch.io.extract import ExtractObject, ExtractWriter
from roms_tpu_torch.io.netcdf import open_dataset
from roms_tpu_torch.io.output import host
from roms_tpu_torch.io.upscale import UpscaleWriter
from roms_tpu_torch.pflx import calc_pflx, init_pflx
from roms_tpu_torch.sponge_tune import (adjust_orlanski, init_sponge_tune,
                                        to_boundary)
from roms_tpu_torch.state import zero_boundary
from roms_tpu_torch.tools.nesting import interp_at, locate_in_grid, match_topo

DX = obc_basin.DX    # parent grid spacing
NP = 32              # parent interior
NC = 32              # child interior (2x refinement of the central half)
NZ = 6
NSTEPS = 8
EDGES = ("west", "east", "south", "north")


def _child_centres(pad=0):
    """Child cell centres in parent coordinates (the central half of the
    parent, refined 2x), with `pad` ghost cells on each side."""
    return 0.25 * NP * DX + 0.5 * DX * (np.arange(-pad, NC + pad) + 0.5)


def _edges():
    cc = _child_centres()
    return {"west": (np.full(NC, cc[0]), cc),
            "east": (np.full(NC, cc[-1]), cc),
            "south": (cc, np.full(NC, cc[0])),
            "north": (cc, np.full(NC, cc[-1]))}


def parent_config(ntimes=NSTEPS):
    return obc_basin.config("radiating", ntimes=ntimes).replace(
        nx=NP, ny=NP, nz=NZ, ndtfast=20)


def child_config():
    return obc_basin.config("radiating", ntimes=NSTEPS).replace(
        nx=NC, ny=NC, nz=NZ, dt=30.0, ndtfast=20)


def parent_run(workdir, dtype, device):
    """The parent's run with extraction objects at the child's edges, and
    its fast pressure-flux series there (sponge_tune's parent side);
    returns (cfg, grid, extraction file, flux records)."""
    cfg = parent_config()
    grid, st, frc = obc_basin.setup(cfg, dtype=dtype, device=device)
    xr, yr = host(grid.xr), host(grid.yr)
    where = {e: locate_in_grid(xr, yr, *xy) for e, xy in _edges().items()}
    path = os.path.join(workdir, "parent_extract.nc")
    ew = ExtractWriter(path, [ExtractObject(e, *where[e]) for e in EDGES],
                       cfg, varnames=("zeta", "ubar", "vbar", "temp"))
    box = {"pf": init_pflx(cfg, dtype=dtype, device=device)}
    recs = []

    def hook(s, i):
        ew.write(s, grid)
        box["pf"], up, vp = calc_pflx(box["pf"], s, grid, cfg,
                                      timescale=4 * cfg.dt)
        recs.append({e: interp_at(host(up if e in ("west", "east")
                                       else vp)[None], *where[e])[0]
                     for e in EDGES})

    run(grid, st, frc, cfg, nsteps=NSTEPS, step_hook=hook,
        collect_diag=False)
    ew.close()
    return cfg, grid, path, recs


def blend_topography(p_grid, cfg):
    """The child bathymetry, perturbed and blended onto the parent's
    interpolation near the boundary (reference: Tools-Roms match_topo);
    returns (blended, child, parent on child)."""
    jy, ix = cfg.ny + 4, cfg.nx + 4
    cx, cy = np.meshgrid(_child_centres(pad=2), _child_centres(pad=2))
    px, py = locate_in_grid(host(p_grid.xr), host(p_grid.yr), cx.ravel(),
                            cy.ravel())
    h_parent = interp_at(host(p_grid.h)[None], px, py)[0].reshape(jy, ix)
    rng = np.random.default_rng(0)
    h_child = h_parent * (1.0 + 0.05 * rng.standard_normal((jy, ix)))
    return (match_topo(h_child, h_parent, np.ones((jy, ix)), width=6),
            h_child, h_parent)


def _pad_edge(vals):
    """Child edge values on the NC interior points, padded to jy/ix+4."""
    out = np.empty(vals.shape[:-1] + (vals.shape[-1] + 4,))
    out[..., 2:-2] = vals
    out[..., :2] = vals[..., :1]
    out[..., -2:] = vals[..., -1:]
    return out


def _boundary_series(path, cfg, dtype, device):
    """bry_at(t): the child's boundary data at time t, linear in time
    between the parent's extraction records (r2r-style)."""
    with open_dataset(path) as ds:
        times = np.asarray(ds["ocean_time"][...])
        series = {e: {v: np.asarray(ds[f"{e}_{v}"][...])
                      for v in ("zeta", "ubar", "vbar", "temp")}
                  for e in EDGES}

    def tensor(a, shape=None):
        t = torch.as_tensor(_pad_edge(a), dtype=dtype, device=device)
        return t if shape is None else t.expand(shape)

    def bry_at(t):
        r = np.clip(np.searchsorted(times, t) - 1, 0, len(times) - 2)
        w = np.clip((t - times[r]) / max(times[r + 1] - times[r], 1e-30),
                    0.0, 1.0)
        kw = {}
        for e in EDGES:
            sv = {k: (1 - w) * a[r] + w * a[r + 1]
                  for k, a in series[e].items()}
            ub, vb = sv["ubar"], sv["vbar"]
            kw[f"zeta_{e}"] = tensor(sv["zeta"])
            kw[f"ubar_{e}"] = tensor(ub)
            kw[f"vbar_{e}"] = tensor(vb)
            kw[f"u_{e}"] = tensor(ub, (cfg.nz, NC + 4))
            kw[f"v_{e}"] = tensor(vb, (cfg.nz, NC + 4))
            kw[f"t_{e}"] = tensor(sv["temp"])[None].expand(
                cfg.nt, cfg.nz, NC + 4)
        return zero_boundary(cfg, dtype, device).replace(**kw)
    return bry_at


def _content(st, grid, interior=True):
    """Tracer 0's content sum(t * hz * dA), float64 on the host."""
    da = 1.0 / (host(grid.pm) * host(grid.pn))
    tz = host(st.t[0]).astype(np.float64) * host(st.hz).astype(np.float64)
    tz = tz * da[None]
    return float((tz[:, 2:-2, 2:-2] if interior else tz).sum())


def run_flow(workdir, dtype=torch.float64, device="cuda"):
    """The whole workflow; returns a dict: the tuned west binding
    `ub_west`, the child's content change `dc` and its integrated
    captured outward flux `net_flux`, the injected rate `inj`, the
    parent's content before and after the re-forced steps `pc0`/`pc1`
    and the expected gain `expect`, the child's per-step captured strips
    of tracer 0 (`strips`, edge -> list of (nz, NC) float64), the
    `UpscaleWriter` file (`upscale_path`), the child's state after its
    run (`child`), and the topography blend `(blended, child, parent on
    child)` as `topo`."""
    p_cfg, p_grid, extract_path, pflx_recs = parent_run(workdir, dtype,
                                                        device)
    c_cfg = child_config().replace(upscale_output=True)
    topo = blend_topography(p_grid, c_cfg)
    c_grid, c_st, c_frc = obc_basin.setup(c_cfg, dtype=dtype, device=device)
    bry_at = _boundary_series(extract_path, c_cfg, dtype, device)

    upscale_path = os.path.join(workdir, "child_upscale.nc")
    uw = UpscaleWriter(upscale_path, c_grid, c_cfg, [("temp", 0, None)])
    box = {"tun": init_sponge_tune(c_cfg, dtype=dtype, device=device),
           "pf": init_pflx(c_cfg, dtype=dtype, device=device),
           "net_flux": 0.0, "captured": None,
           "strips": {e: [] for e in EDGES}}

    def forcing_fn(t, base, st):
        return base.replace(bry=to_boundary(box["tun"], bry_at(t)))

    def hook(s, i):
        # the sponge tuned from the child's fast flux against the parent's
        box["pf"], up, vp = calc_pflx(box["pf"], s, c_grid, c_cfg,
                                      timescale=4 * c_cfg.dt)
        rec = pflx_recs[min(i - 1, len(pflx_recs) - 1)]
        parent = {e: torch.as_tensor(_pad_edge(np.abs(rec[e])),
                                     dtype=dtype, device=device)
                  for e in rec}
        box["tun"] = adjust_orlanski(box["tun"], up, vp, parent, c_cfg,
                                     sp_timscale=20 * c_cfg.dt)
        # the captured outward boundary fluxes of tracer 0, integrated
        tot = 0.0
        for e in EDGES:
            strip = s.upscale[e][0][:, 2:-2]
            tot += float(torch.sum(strip))
            box["strips"][e].append(host(strip).astype(np.float64))
        box["net_flux"] += c_cfg.dt * tot
        box["captured"] = s.upscale
        uw.accumulate(s)

    c0 = _content(c_st, c_grid)
    st_end, _ = run(c_grid, c_st, c_frc, c_cfg, nsteps=NSTEPS,
                    forcing_fn=forcing_fn, step_hook=hook,
                    collect_diag=False)
    uw.close()
    dc = _content(st_end, c_grid) - c0

    # the captured fluxes re-force the parent as a dense CDR-style source
    # at the child-footprint boundary cells: 2 child cells per parent cell
    jyp, ixp = p_cfg.ny + 4, p_cfg.nx + 4
    flx3 = np.zeros((p_cfg.nt, p_cfg.nz, jyp, ixp))
    i0 = NP // 4 + 2
    for e in ("west", "east"):
        strip = host(box["captured"][e][0]).astype(np.float64)[:, 2:-2]
        pc = strip.reshape(p_cfg.nz, NC // 2, 2).sum(axis=2)
        ip = i0 if e == "west" else i0 + NP // 2 - 1
        flx3[0, :, i0:i0 + NP // 2, ip] += pc
    inj = float(flx3.sum())
    p_cfg2 = p_cfg.replace(ntimes=2)
    g2, s2, f2 = obc_basin.setup(p_cfg2, dtype=dtype, device=device)
    f2 = f2.replace(cdr=cdr_3d(p_cfg2, flx3, dtype=dtype, device=device))
    pc0 = _content(s2, g2, interior=False)
    s2b, _ = run(g2, s2, f2, p_cfg2, nsteps=2, collect_diag=False)
    pc1 = _content(s2b, g2, interior=False)
    return {"ub_west": host(box["tun"].ub_west).astype(np.float64),
            "ubind": c_cfg.ubind, "dc": dc, "net_flux": box["net_flux"],
            "c0": c0, "inj": inj, "pc0": pc0, "pc1": pc1,
            "expect": 2 * p_cfg2.dt * inj, "strips": box["strips"],
            "upscale_path": upscale_path, "child": st_end, "topo": topo}


def check_flow(out):
    """The workflow's checks (tests/test_nested_flow.py): the topography
    blend keeps the parent at the forced edge and the child inside, the
    tuning moved the west binding off cfg.ubind, the child's content
    change equals minus its integrated captured outward flux (rtol 5e-9),
    the re-forced parent gains the injected content within the test's
    envelope, and the `UpscaleWriter` file reads back as the captured
    strips.  Raises AssertionError."""
    blended, child, parent = out["topo"]
    np.testing.assert_allclose(blended[0, :], parent[0, :], rtol=1e-12)
    assert np.abs(blended[10:-10, 10:-10]
                  - child[10:-10, 10:-10]).max() < 1e-12 * 100.0
    assert not np.allclose(out["ub_west"], out["ubind"])
    np.testing.assert_allclose(out["dc"], -out["net_flux"], rtol=5e-9,
                               atol=1e-8 * abs(out["c0"]))
    assert np.isfinite(out["pc1"])
    got, expect = out["pc1"] - out["pc0"], out["expect"]
    if abs(expect) > 0:
        assert abs(got - expect) < 0.2 * abs(expect) \
            + 1e-6 * abs(out["pc0"]), (got, expect)
    with open_dataset(out["upscale_path"]) as ds:
        for e in EDGES:
            np.testing.assert_array_equal(
                np.asarray(ds[f"temp_add_{e}"][...]),
                np.stack(out["strips"][e]), err_msg=e)
