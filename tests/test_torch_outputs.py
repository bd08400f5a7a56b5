"""The port's output writers against the JAX package's, in float64 on the
CPU: for the same bridged state (a JAX package case with seeded noise on
every field), the history, average, grid, rotating, applied-forcing, mCDR,
random-list, z-slice, extraction and BGC-diagnostic files hold the same
dimensions, variables, variable attributes and global attributes (apart
from `type` and `git_hash`, which name the package and the commit).
Written data is bitwise equal where both packages only move numbers; the
z-slice and extraction arithmetic is held within 1e-13, and the BGC
diagnostics, which each package's own engine computes, at the bounds
tests/test_torch_bgc.py holds `diagnose` to (1e-13, 1e-12 for the
carbonate fields)."""

import os
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from roms_tpu.bgc.api import get_model as jget_model
from roms_tpu.cases import filament as jfilament
from roms_tpu.cases import obc_basin as jobc
from roms_tpu.io import bgc_io as jbgc_io
from roms_tpu.io import extract as jextract
from roms_tpu.io import output as jout
from roms_tpu.io import zslice as jzslice

from roms_tpu_torch import bridge
from roms_tpu_torch.io import bgc_io as tbgc_io
from roms_tpu_torch.io import extract as textract
from roms_tpu_torch.io import output as tout
from roms_tpu_torch.io import zslice as tzslice

from torch_helpers import F64, assert_same_nc, np_tree, port_cfg

torch.set_num_threads(1)

ZTOL = 1e-13
BGC_TOL, BGC_TOL_H = 1e-13, 1e-12
CARBONATE = {"pCO2_oc", "pH_surf", "CO3_surf", "HCO3_surf", "CO2STAR_surf",
             "Omega_calcite", "Omega_aragonite", "FG_CO2"}


def _noisy(jst, seed, time):
    """(JAX state, port state): the JAX state with seeded noise of 1e-3 on
    every float field and model time `time`, and its bridge."""
    rng = np.random.default_rng(seed)
    d = np_tree(jst)
    for k, a in d.items():
        if a is None or isinstance(a, dict) or k == "iic":
            continue
        d[k] = a + 1e-3 * rng.standard_normal(a.shape)
    d["time"] = np.asarray(time, np.float64)
    d["iic"] = np.asarray(seed, np.int32)
    jst = jst.replace(**{k: jnp.asarray(v) for k, v in d.items()
                         if v is not None and not isinstance(v, dict)})
    return jst, bridge.state_from_numpy(d, dtype=F64, device="cpu")


def _basin(nt=3, n=4):
    """obc_basin, closed, nx=12 ny=10 nz=6, with `n` noisy states an hour
    apart: (JAX cfg, port cfg, JAX grid, port grid, JAX forcing, [(JAX
    state, port state)])."""
    jcfg = jobc.config("closed", ntimes=2).replace(
        nx=12, ny=10, nz=6, nt=nt, salinity=nt >= 2, dt=60.0, ndtfast=10)
    jgrid, jst, jfrc = jobc.setup(jcfg)
    tgrid = bridge.grid_from_numpy(np_tree(jgrid), dtype=F64, device="cpu")
    states = [_noisy(jst, s, 3600.0 * (s + 1)) for s in range(n)]
    return jcfg, port_cfg(jcfg), jgrid, tgrid, jfrc, states


def _both(tmp_path, name, make_j, make_t, states, write):
    """Write one file with each package's writer; returns their paths."""
    paths = []
    for tag, make, k in (("jax", make_j, 0), ("port", make_t, 1)):
        path = str(tmp_path / f"{tag}_{name}")
        w = make(path)
        for pair in states:
            write(w, pair[k])
        w.close()
        paths.append(path)
    return paths[1], paths[0]


@pytest.mark.parametrize("table", ["default", "custom"])
def test_history_writer_matches_jax(tmp_path, table):
    jcfg, tcfg, jgrid, tgrid, _, states = _basin()
    kw_j, kw_t = {}, {}
    if table == "custom":
        # per-tracer metadata and flags (reference: tracers.opt:36-67)
        for kw, mod, cfg in ((kw_j, jout, jcfg), (kw_t, tout, tcfg)):
            rows = mod.tracer_table(cfg)
            rows[2] = mod.TracerMeta(name="dye", long_name="dye tracer",
                                     units="kg meter-3")
            rows[1] = mod.TracerMeta(name="salt", wrt=False)
            kw["tracers"] = rows
    port, ref = _both(
        tmp_path, "his.nc",
        lambda p: jout.HistoryWriter(p, jgrid, jcfg, **kw_j),
        lambda p: tout.HistoryWriter(p, tgrid, tcfg, **kw_t),
        states[:2], lambda w, s: w.write(s))
    assert_same_nc(port, ref)


def test_average_writer_matches_jax(tmp_path):
    jcfg, tcfg, jgrid, tgrid, _, states = _basin()
    port, ref = _both(
        tmp_path, "avg.nc",
        lambda p: jout.AverageWriter(p, jgrid, jcfg, navg=2),
        lambda p: tout.AverageWriter(p, tgrid, tcfg, navg=2),
        states, lambda w, s: w.accumulate(s))
    assert_same_nc(port, ref)


def test_write_grid_matches_jax(tmp_path):
    jcfg, tcfg, jgrid, tgrid, _, _ = _basin(n=0)
    jout.write_grid(str(tmp_path / "jax_grd.nc"), jgrid, jcfg)
    tout.write_grid(str(tmp_path / "port_grd.nc"), tgrid, tcfg)
    assert_same_nc(str(tmp_path / "port_grd.nc"), str(tmp_path / "jax_grd.nc"))


def test_rotating_writer_matches_jax(tmp_path):
    jcfg, tcfg, jgrid, tgrid, _, states = _basin()
    files = {}
    for tag, mod, grid, cfg, k in (("jax", jout, jgrid, jcfg, 0),
                                   ("port", tout, tgrid, tcfg, 1)):
        os.makedirs(tmp_path / tag)
        w = mod.RotatingHistoryWriter(str(tmp_path / tag / "rot"), grid, cfg,
                                      nrpf=2, dt_format=3)
        for pair in states:
            w.write(pair[k])
        w.close()
        files[tag] = w.files
    assert [os.path.basename(p) for p in files["port"]] == \
        [os.path.basename(p) for p in files["jax"]]
    assert len(files["port"]) == 2
    for p, j in zip(files["port"], files["jax"]):
        assert_same_nc(p, j)


def test_dated_names_match_jax():
    for t in (0.0, 3661.0, 86400.0 * 400 + 59.0, 315705600.0):
        assert tout.sec2date(t) == jout.sec2date(t)
        for fmt in range(5):
            assert tout.dated_filename("r", "his", t, fmt) == \
                jout.dated_filename("r", "his", t, fmt)
    assert tout.dated_filename("r", "his", 0.0) == "r.his.20000101000000.nc"


def test_frc_writer_matches_jax(tmp_path):
    jcfg, tcfg, _, _, jfrc, _ = _basin(nt=2, n=0)
    rng = np.random.default_rng(11)
    records = []
    for k in range(4):
        d = np_tree(jfrc)
        for name in ("sustr", "svstr", "stflx", "srflx", "swflx"):
            d[name] = 1e-4 * rng.standard_normal(d[name].shape)
        records.append((jfrc.replace(**{n: jnp.asarray(d[n]) for n in (
            "sustr", "svstr", "stflx", "srflx", "swflx")}),
            bridge.forcing_from_numpy(d, dtype=F64, device="cpu"),
            60.0 * k))
    port, ref = _both(
        tmp_path, "frc.nc",
        lambda p: jout.FrcWriter(p, jcfg, navg=2),
        lambda p: tout.FrcWriter(p, tcfg, navg=2),
        [((r[0], r[2]), (r[1], r[2])) for r in records],
        lambda w, fr: w.accumulate(*fr))
    assert_same_nc(port, ref)


def test_cdr_writer_matches_jax(tmp_path):
    jcfg, tcfg, _, _, _, _ = _basin(n=0)
    rng = np.random.default_rng(12)
    flx = [rng.standard_normal((2, jcfg.nt)) for _ in range(3)]
    port, ref = _both(
        tmp_path, "cdr.nc",
        lambda p: jout.CdrWriter(p, jcfg, 2, ["temp", "salt", "ALK"]),
        lambda p: tout.CdrWriter(p, tcfg, 2, ["temp", "salt", "ALK"]),
        [((SimpleNamespace(flx=jnp.asarray(f)), 60.0 * k),
          (SimpleNamespace(flx=torch.as_tensor(f)), 60.0 * k))
         for k, f in enumerate(flx)],
        lambda w, a: w.write(*a))
    assert_same_nc(port, ref)


def test_random_writer_matches_jax(tmp_path):
    jcfg, tcfg, jgrid, tgrid, _, states = _basin()
    names = ["zeta", "u", "akv", "hbls"]
    port, ref = _both(
        tmp_path, "rnd.nc",
        lambda p: jout.RandomWriter(p, jgrid, jcfg, names),
        lambda p: tout.RandomWriter(p, tgrid, tcfg, names),
        states[:3], lambda w, s: w.write(s))
    assert_same_nc(port, ref)
    with pytest.raises(ValueError):
        tout.RandomWriter(str(tmp_path / "t.nc"), tgrid, tcfg,
                          ["t"]).write(states[0][1])


def test_tracer_table_matches_jax():
    jcfg, tcfg, *_ = _basin(nt=3, n=0)
    assert tout.tracer_table(tcfg) == [tout.TracerMeta(**vars(r))
                                       for r in jout.tracer_table(jcfg)]
    for nbgc, model in ((29, "bec2"), (4, "npzd")):
        jc = jcfg.replace(nt=2 + nbgc, bgc_model=model, n_bgc=nbgc)
        tc = port_cfg(jc)
        names = [t.name for t in tout.tracer_table(tc)]
        assert names == [t.name for t in jout.tracer_table(jc)]
        assert model != "bec2" or {"DIC", "Alk", "O2"} <= set(names)


def _filament():
    jcfg = jfilament.config(ntimes=1).replace(nx=16, ny=12, nz=8)
    jgrid, jst, _ = jfilament.setup(jcfg)
    tgrid = bridge.grid_from_numpy(np_tree(jgrid), dtype=F64, device="cpu")
    return jcfg, port_cfg(jcfg), jgrid, tgrid, _noisy(jst, 0, 600.0)


DEPTHS = [-1e-3, -10.0, -50.0, -333.3, -500.0, -2000.0]


def test_zslice_matches_jax():
    _, _, _, _, (jst, tst) = _filament()
    h = 2
    for jf, tf in ((jst.t[0], tst.t[0]), (jst.z_r, tst.z_r),
                   (jst.rho, tst.rho)):
        ref = np.asarray(jzslice.zslice(jf, jst.z_r, jnp.asarray(DEPTHS)))
        got = tzslice.zslice(tf, tst.z_r, DEPTHS).numpy()
        np.testing.assert_array_equal(np.isnan(got), np.isnan(ref))
        np.testing.assert_allclose(got, ref, rtol=ZTOL,
                                   atol=ZTOL * np.nanmax(np.abs(ref)))
    # the level depths sliced at a depth give that depth; below the
    # bottom (h=1000) NaN
    got = tzslice.zslice(tst.z_r, tst.z_r, [-10.0, -500.0, -2000.0]).numpy()
    np.testing.assert_allclose(got[0][h:-h, h:-h], -10.0, rtol=1e-12)
    np.testing.assert_allclose(got[1][h:-h, h:-h], -500.0, rtol=1e-12)
    assert np.isnan(got[2][h:-h, h:-h]).all()


def test_zslice_writer_matches_jax(tmp_path):
    jcfg, tcfg, jgrid, tgrid, pair = _filament()
    port, ref = _both(
        tmp_path, "z.nc",
        lambda p: jzslice.ZsliceWriter(p, jgrid, jcfg, depths=[10.0, 100.0],
                                       varnames=["temp", "rho"]),
        lambda p: tzslice.ZsliceWriter(p, tgrid, tcfg, depths=[10.0, 100.0],
                                       varnames=["temp", "rho"]),
        [pair], lambda w, s: w.write(s))
    assert_same_nc(port, ref, tol=ZTOL)


def test_extract_matches_jax(tmp_path):
    jcfg, tcfg, jgrid, tgrid, (jst, tst) = _filament()
    px, py = [3.25, 7.5, 0.1, 15.9], [4.0, 6.75, 11.5, 0.3]
    ref = np.asarray(jextract.extract_points(jgrid.xr, jnp.asarray(px),
                                             jnp.asarray(py), jcfg))
    got = textract.extract_points(tgrid.xr, px, py, tcfg).numpy()
    np.testing.assert_allclose(got, ref, rtol=ZTOL, atol=0)
    ang = 0.3 + 0.1 * np.random.default_rng(5).standard_normal(
        tuple(jgrid.h.shape))
    for angler in (None, ang):
        jr = jextract.extract_uv(jst.u, jst.v, px, py, jgrid, jcfg,
                                 angler=angler)
        tr = textract.extract_uv(tst.u, tst.v, px, py, tgrid, tcfg,
                                 angler=angler)
        for a, b in zip(tr, jr):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=ZTOL,
                                       atol=ZTOL * float(np.abs(b).max()))
    obs = [("moor", [4.0, 8.0], [6.0, 6.0]), ("line", px, py)]
    port, ref = _both(
        tmp_path, "ext.nc",
        lambda p: jextract.ExtractWriter(
            p, [jextract.ExtractObject(*o) for o in obs], jcfg,
            varnames=("zeta", "temp", "u", "v"), rotate=True, angler=ang),
        lambda p: textract.ExtractWriter(
            p, [textract.ExtractObject(*o) for o in obs], tcfg,
            varnames=("zeta", "temp", "u", "v"), rotate=True, angler=ang),
        [((jst, jgrid), (tst, tgrid))], lambda w, a: w.write(*a))
    assert_same_nc(port, ref, tol=ZTOL)


def test_bgc_diag_writer_matches_jax(tmp_path):
    """bec2 on a small Filament with 29 BGC tracers: the same diagnostics,
    dimensions and attributes in float32 files, and the float64 values
    within the bounds of tests/test_torch_bgc.py::test_diagnose_matches_jax
    (each package evaluates its own engine)."""
    nbgc = 29
    jcfg = jfilament.config(ntimes=1).replace(
        nx=8, ny=8, nz=6, nt=2 + nbgc, salinity=True, nonlin_eos=True,
        bgc_model="bec2", n_bgc=nbgc)
    jgrid, jst, jfrc = jfilament.setup(jcfg)
    bgc0 = jget_model("bec2").init_tracers(jcfg, jst.z_r)
    t0 = jnp.concatenate([jst.t[:1], jnp.full_like(jst.t[:1], 35.0), bgc0])
    jst = jst.replace(t=t0, t_prev=t0)
    tcfg = port_cfg(jcfg)
    tgrid = bridge.grid_from_numpy(np_tree(jgrid), dtype=F64, device="cpu")
    tst = bridge.state_from_numpy(np_tree(jst), dtype=F64, device="cpu")
    wspd = 5.0 + np.random.default_rng(3).random(tuple(jgrid.h.shape))
    jfrc = jfrc.replace(srflx=jnp.full_like(jfrc.srflx, 1e-4),
                        bgc={"wspd": jnp.asarray(wspd)})
    d = np_tree(jfrc)
    tfrc = bridge.forcing_from_numpy(d, dtype=F64, device="cpu")
    paths = {}
    for dtype in ("f4", "f8"):
        paths[dtype] = _both(
            tmp_path, f"bgc_dia_{dtype}.nc",
            lambda p: jbgc_io.BgcDiagWriter(p, jgrid, jcfg, dtype=dtype),
            lambda p: tbgc_io.BgcDiagWriter(p, tgrid, tcfg, dtype=dtype),
            [((jst, jfrc), (tst, tfrc))], lambda w, a: w.write(*a))
    from roms_tpu_torch.io.netcdf import open_dataset
    port, ref = paths["f4"]
    with open_dataset(port) as a, open_dataset(ref) as b:
        assert a.dimensions == b.dimensions
        assert sorted(a.variables) == sorted(b.variables)
        assert len(a.variables) >= 20
        for n in b.variables:
            assert (a[n].dims, a[n].attrs, a[n].dtype) == \
                (b[n].dims, b[n].attrs, b[n].dtype), n
    port, ref = paths["f8"]
    with open_dataset(port) as a, open_dataset(ref) as b:
        for n in b.variables:
            x, y = np.asarray(a[n][...]), np.asarray(b[n][...])
            tol = BGC_TOL_H if n in CARBONATE else BGC_TOL
            np.testing.assert_allclose(
                x, y, rtol=tol, atol=tol * max(float(np.abs(y).max()), 1e-300),
                err_msg=n)
