"""The port's host tools and host helpers against the JAX package's, on the
same inputs (all numpy on the host, so equal means bitwise equal unless
stated): `grid.grid_stiffness`, `forcing.coarse2fine`,
`tools/grid_gen.py`, `tools/sample.py`, `tools/nesting.py` and
`tools/nc3to4z.py`.  The port's tools are copies, not imports, of the
JAX package's (tests/test_torch_realdata.py holds that the port imports
nothing of it)."""

import os

import numpy as np
import pytest
import torch

from roms_tpu.cases import bench_production as jprod
from roms_tpu.cases import obc_basin as jobc
from roms_tpu.forcing import coarse2fine as jcoarse2fine
from roms_tpu.grid import grid_stiffness as jgrid_stiffness
from roms_tpu.io.output import HistoryWriter as JHistoryWriter
from roms_tpu.tools import grid_gen as jgg
from roms_tpu.tools import nesting as jnest
from roms_tpu.tools import sample as jsample
# the package's __init__ binds the name nc3to4z to partition's function
from roms_tpu.tools.nc3to4z import convert as jconvert

from roms_tpu_torch import bridge
from roms_tpu_torch.config import ModelConfig
from roms_tpu_torch.forcing import coarse2fine
from roms_tpu_torch.grid import grid_stiffness
from roms_tpu_torch.io.input import read_grid
from roms_tpu_torch.io.netcdf import NCWriter, open_dataset
from roms_tpu_torch.tools import grid_gen, nc3to4z, nesting, sample

from torch_helpers import F64, assert_same_nc, np_tree, port_cfg

torch.set_num_threads(1)


@pytest.mark.parametrize("case", ["flat", "production"])
def test_grid_stiffness_matches_jax(case):
    """rx0/rx1 (reference: src/grid_stiffness.F): zero rx0 on a flat
    bottom, 0 < rx0 <= rx1 < 1 on the production shelf with its mask."""
    if case == "flat":
        jcfg = jobc.config("closed").replace(nx=16, ny=12, nz=6)
        jgrid, jst, _ = jobc.setup(jcfg)
    else:
        jcfg = jprod.config(nx=48, ny=24, nz=10)
        jgrid, jst, _ = jprod.setup(jcfg)
    grid = bridge.grid_from_numpy(np_tree(jgrid), dtype=F64, device="cpu")
    z_w = torch.as_tensor(np.array(jst.z_w), dtype=F64)
    got = grid_stiffness(z_w, grid, port_cfg(jcfg))
    assert got == jgrid_stiffness(jst.z_w, jgrid, jcfg)
    if case == "flat":
        assert got[0] < 1e-12
    else:
        assert 0.0 < got[0] < 1.0 and got[0] <= got[1]


@pytest.mark.parametrize("gtype", ["r", "u", "v"])
@pytest.mark.parametrize("ratio", [2, 3])
def test_coarse2fine_matches_jax(gtype, ratio):
    c = np.random.default_rng(ratio).standard_normal((3, 8, 10))
    got = coarse2fine(c, ratio=ratio, gtype=gtype)
    assert got.shape == (3, 8 * ratio, 10 * ratio)
    np.testing.assert_array_equal(got, jcoarse2fine(c, ratio, gtype))


def _bathy(lon, lat):
    # shelf-to-deep with a land strip on the east and an isolated pond
    x = (lon - lon.min()) / (lon.max() - lon.min())
    y = (lat - lat.min()) / (lat.max() - lat.min())
    h = np.where(x < 0.85, 50.0 + 3500.0 * x ** 2, -10.0)
    return np.where((x > 0.9) & (np.abs(y - 0.5) < 0.1), 30.0, h)


def test_grid_gen_matches_jax(tmp_path):
    paths = [str(tmp_path / "port_grid.nc"), str(tmp_path / "jax_grid.nc")]
    outs = [mod.generate_grid(-122.0, 35.0, 48e3, 32e3, 24, 16, _bathy,
                              rotation=20.0, hmin=25.0, rx0_max=0.2,
                              path=p)
            for mod, p in zip((grid_gen, jgg), paths)]
    assert sorted(outs[0]) == sorted(outs[1])
    for k in outs[1]:
        np.testing.assert_array_equal(outs[0][k], outs[1][k], err_msg=k)
    assert grid_gen.rx0_of(outs[0]["h"], outs[0]["mask_rho"]) == \
        jgg.rx0_of(outs[1]["h"], outs[1]["mask_rho"]) <= 0.2 + 1e-12
    assert_same_nc(*paths, skip_attrs=("generator",))
    with open_dataset(paths[0]) as ds:
        assert ds.attrs["generator"] == "roms_tpu_torch grid_gen"
    # the generated file loads through the port's grid reader
    cfg = ModelConfig(nx=24, ny=16, nz=8, nt=2, dt=60.0, ndtfast=20,
                      ntimes=1, masking=True, ew_periodic=False,
                      ns_periodic=False)
    grid = read_grid(paths[0], cfg, dtype=F64, device="cpu")
    assert grid.h.shape == (20, 28) and bool(torch.isfinite(grid.h).all())


def test_grid_gen_cli_matches_jax(tmp_path, capsys):
    args = ["--center", "-122", "35", "--size-km", "40", "30", "--shape",
            "16", "12", "--flat-depth", "800"]
    grid_gen.main([str(tmp_path / "port.nc")] + args)
    port_out = capsys.readouterr().out
    jgg.main([str(tmp_path / "jax.nc")] + args)
    jax_out = capsys.readouterr().out
    assert "16x12 interior" in port_out
    assert port_out.replace("port.nc", "X") == jax_out.replace("jax.nc", "X")
    assert_same_nc(str(tmp_path / "port.nc"), str(tmp_path / "jax.nc"),
                   skip_attrs=("generator",))


def _history(tmp_path):
    """A two-record history file of a noisy closed basin, written by the
    JAX package."""
    cfg = jobc.config("closed", ntimes=1).replace(nx=12, ny=10, nz=6,
                                                  dt=60.0, ndtfast=10)
    grid, st, _ = jobc.setup(cfg)
    rng = np.random.default_rng(2)
    path = str(tmp_path / "his.nc")
    hw = JHistoryWriter(path, grid, cfg)
    for _ in range(2):
        hw.write(st.replace(t=st.t + rng.standard_normal(st.t.shape),
                            zeta=st.zeta + 0.1 * rng.standard_normal(
                                st.zeta.shape)))
    hw.close()
    return path


@pytest.mark.parametrize("mode", ["depths", "sigmas", "points"])
def test_sample_matches_jax(tmp_path, capsys, mode):
    his = _history(tmp_path)
    opts = {"depths": ["--var", "temp", "--depths", "5", "20", "80",
                       "--rec", "0"],
            "sigmas": ["--var", "temp", "--sigmas", "-0.5", "0.0"],
            "points": ["--var", "zeta", "--points", "5.5,5", "2,7.25"]}[mode]
    outs = {}
    for tag, mod in (("port", sample), ("jax", jsample)):
        out = str(tmp_path / f"{tag}.nc")
        assert mod.main([his] + opts + ["-o", out]) == 0
        outs[tag] = (out, capsys.readouterr().out)
    assert outs["port"][1].replace("port.nc", "X") == \
        outs["jax"][1].replace("jax.nc", "X")
    if mode != "points":
        assert_same_nc(outs["port"][0], outs["jax"][0])


def test_nesting_matches_jax(tmp_path):
    # a rotated curvilinear parent with analytic fields
    ny, nx, nzp, nrec = 16, 20, 6, 2
    i = np.arange(nx)[None, :].repeat(ny, 0).astype(float)
    j = np.arange(ny)[:, None].repeat(nx, 1).astype(float)
    th = np.pi / 7
    lon = np.cos(th) * i - np.sin(th) * j
    lat = np.sin(th) * i + np.cos(th) * j
    rng = np.random.default_rng(4)
    parent = dict(lon=lon, lat=lat,
                  hz=50.0 + 10.0 * rng.random((nzp, ny, nx)),
                  zeta=rng.standard_normal((nrec, ny, nx)),
                  ubar=rng.standard_normal((nrec, ny, nx)),
                  vbar=rng.standard_normal((nrec, ny, nx)),
                  temp=rng.standard_normal((nrec, nzp, ny, nx)),
                  angle=0.1 * rng.standard_normal((ny, nx)))
    lt, la = [5.5, 10.2, 3.3], [7.25, 2.0, 9.9]
    for a, b in zip(nesting.locate_in_grid(lon, lat, lt, la),
                    jnest.locate_in_grid(lon, lat, lt, la)):
        np.testing.assert_array_equal(a, b)
    px, py = np.array([1.5, 7.25, 18.9]), np.array([0.1, 3.5, 14.0])
    np.testing.assert_array_equal(nesting.interp_at(parent["temp"], px, py),
                                  jnest.interp_at(parent["temp"], px, py))
    hz_dst = 40.0 + 5.0 * rng.random((4, 3))
    cols = rng.standard_normal((nzp, 3))
    hz_src = 50.0 + 10.0 * rng.random((nzp, 3))
    np.testing.assert_array_equal(nesting.remap_columns(cols, hz_src, hz_dst),
                                  jnest.remap_columns(cols, hz_src, hz_dst))
    npts = 5
    child = {"west": dict(lon=np.full(npts, 2.0),
                          lat=np.linspace(3.0, 9.0, npts),
                          hz=np.full((4, npts), 60.0)),
             "north": dict(lon=np.linspace(-2.0, 6.0, npts),
                           lat=np.full(npts, 11.0),
                           hz=np.full((4, npts), 60.0))}
    paths = [str(tmp_path / "port_bry.nc"), str(tmp_path / "jax_bry.nc")]
    for mod, p in zip((nesting, jnest), paths):
        mod.child_boundary_from_parent(parent, child, p,
                                       tracer_names=("temp",),
                                       times=np.array([0.0, 3600.0]))
    assert_same_nc(*paths, skip_attrs=())
    h_c = 100.0 + rng.random((20, 24))
    h_p = 200.0 + rng.random((20, 24))
    m = np.ones((20, 24))
    m[5:15, 3] = 0.0
    np.testing.assert_array_equal(
        nesting.match_topo(h_c, h_p, m, edges=("west", "south"), width=6),
        jnest.match_topo(h_c, h_p, m, edges=("west", "south"), width=6))


def test_nc3to4z_matches_jax(tmp_path, capsys):
    """The port's compressed NetCDF-4 copy holds what the JAX package's
    holds, identical to the NetCDF-3 source, and is smaller."""
    p = str(tmp_path / "raw.nc")
    rng = np.random.default_rng(0)
    big = np.repeat(rng.standard_normal((40, 50)), 8, axis=0)  # compressible
    with NCWriter(p, attrs={"title": "t"}) as w:
        w.create_dim("time", None)
        w.create_dim("y", big.shape[0])
        w.create_dim("x", big.shape[1])
        w.create_var("f", ("time", "y", "x"), "f8", {"units": "m"})
        w.create_var("x", ("x",), "f8")
        w.write("x", np.arange(big.shape[1], dtype=np.float64))
        for r in range(3):
            w.write("f", big * (r + 1), rec=r)
    assert nc3to4z.main([p, "--level", "6", "--suffix", ".port.nc4"]) == 0
    jconvert(p, p + ".jax.nc4", level=6)
    assert "wrote" in capsys.readouterr().out
    with open_dataset(p + ".port.nc4") as a, \
            open_dataset(p + ".jax.nc4") as b, open_dataset(p) as src:
        assert a.attrs == b.attrs and a.attrs["title"] == "t"
        assert a.dimensions == b.dimensions
        assert sorted(a.variables) == sorted(b.variables)
        for n in src.variables:
            assert a[n].dims == b[n].dims and a[n].attrs == b[n].attrs, n
            np.testing.assert_array_equal(a[n][...], b[n][...], err_msg=n)
            np.testing.assert_array_equal(a[n][...], src[n][...], err_msg=n)
    assert os.path.getsize(p + ".port.nc4") < 0.8 * os.path.getsize(p)
