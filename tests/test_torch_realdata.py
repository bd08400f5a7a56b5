"""The port's file-driven real-data path against the JAX package's, in
float64 on the CPU, on the synthetic USWC inputs (199x99x50, nt=2):

(a) `runconfig.read_inp` of the Flux_frc, Rivers_real and Pipes_real
    `BENCHMARK_IN` texts gives the JAX package's overrides and paths;
(b) NetCDF both ways: the port's writer read by the JAX reader, the JAX
    writer read by the port's reader; an HDF5 file without h5py names
    the file; `driver.run`'s forcing_fn hook in both forms;
(c) `uswc.generate_inputs` writes the JAX package's files: the same
    variables, dimensions, attributes and values; climatology edge series
    equal the JAX package's; `assemble` accepts bulk, tidal and BGC
    forcing files and mCDR releases, and `forcing_fn` carries each
    (tests/test_torch_bulk_tides.py and tests/test_torch_cdr.py hold them
    to the JAX package's);
(d) after `assemble`, the grid (with the sponge-enhanced visc2_r, visc2_p,
    diff2), the initial state and `forcing0` (river faces, pipe tables,
    `pipe_idx` an int32) equal the JAX package's field by field at 1e-13,
    and `forcing_fn(t)` equals the JAX package's at 1e-14 at the start
    time, inside a record interval, on a record boundary and past the
    first interval;
(e) three steps of each case through `Experiment.run` match rows 0-3 of
    its frozen oracle (tests/data/{case}_oracle.txt) at the per-column
    rtols of tests/realcase_utils.py:check_against_oracle.
No JAX step runs here: (e) holds the port to the oracles directly.  And
(f) the real-data, point-source, bulk, tide, BGC and mCDR modules, the
output writers, the monitor, the command line and the host tools import
nothing of JAX or of the JAX package.
"""

import inspect
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from realcase_utils import check_against_oracle, oracle_path

from roms_tpu import experiment as jexperiment
from roms_tpu import runconfig as jrun
from roms_tpu.cases import flux_frc as jflux
from roms_tpu.cases import pipes_real as jpipes
from roms_tpu.cases import rivers_real as jrivers
from roms_tpu.cases import uswc as juswc
from roms_tpu.io import netcdf as jnc

from roms_tpu_torch import bridge
from roms_tpu_torch import experiment as texperiment
from roms_tpu_torch import runconfig as trun
from roms_tpu_torch.cases import filament as tfilament
from roms_tpu_torch.cases import flux_frc as tflux
from roms_tpu_torch.cases import pipes_real as tpipes
from roms_tpu_torch.cases import rivers_real as trivers
from roms_tpu_torch.cases import uswc as tuswc
from roms_tpu_torch.driver import run as trun_driver
from roms_tpu_torch.io import netcdf as tnc
from roms_tpu_torch.ops import cuda_tracer

from torch_helpers import F64, assert_fields_close, np_fields, port_cfg

torch.set_num_threads(1)

CASES = {"flux_frc": (jflux, tflux), "rivers_real": (jrivers, trivers),
         "pipes_real": (jpipes, tpipes)}
RTOL = inspect.signature(check_against_oracle).parameters["rtol"].default
DAY = 86400.0


@pytest.mark.parametrize("case", sorted(CASES))
def test_read_inp_matches_jax(case, tmp_path):
    jmod, tmod = CASES[case]
    assert tmod.BENCHMARK_IN == jmod.BENCHMARK_IN
    path = tmp_path / "case.in"
    path.write_text(tmod.BENCHMARK_IN.format(inp="/data/in", ntimes=7))
    j, t = jrun.read_inp(str(path)), trun.read_inp(str(path))
    assert t.overrides == j.overrides and t.paths == j.paths
    assert t.overrides["ntimes"] == 7


def _write(mod, path, rng):
    data = {"h": rng.random((4, 5)), "zeta": rng.random((3, 4, 5)),
            "t": np.arange(3.0)}
    with mod.NCWriter(path, attrs={"title": "round trip"}) as w:
        w.create_dim("time", None)
        w.create_dim("eta_rho", 4)
        w.create_dim("xi_rho", 5)
        w.create_var("t", ("time",), attrs={"units": "day",
                                            "cycle_length": 365.25})
        w.create_var("h", ("eta_rho", "xi_rho"))
        w.create_var("zeta", ("time", "eta_rho", "xi_rho"))
        w.write("h", data["h"])
        for r in range(3):
            w.write("t", data["t"][r], rec=r)
            w.write("zeta", data["zeta"][r], rec=r)
    return data


@pytest.mark.parametrize("writer,reader", [(tnc, jnc), (jnc, tnc)],
                         ids=["port_to_jax", "jax_to_port"])
def test_netcdf_round_trip(writer, reader, tmp_path):
    path = str(tmp_path / "x.nc")
    data = _write(writer, path, np.random.default_rng(0))
    with reader.open_dataset(path) as ds:
        assert ds.attrs["title"] == "round trip"
        assert ds.dimensions["eta_rho"] == 4
        assert ds["zeta"].dims == ("time", "eta_rho", "xi_rho")
        assert float(ds["t"].attrs["cycle_length"]) == 365.25
        for name, a in data.items():
            np.testing.assert_array_equal(ds[name][...], a)
        np.testing.assert_array_equal(ds["zeta"][1], data["zeta"][1])


def test_hdf5_without_h5py_names_the_file(tmp_path, monkeypatch):
    path = tmp_path / "grid4.nc"
    path.write_bytes(b"\x89HDF\r\n\x1a\n" + bytes(64))
    monkeypatch.setitem(sys.modules, "h5py", None)
    with pytest.raises(ImportError, match="grid4.nc"):
        tnc.open_dataset(str(path))


def test_forcing_fn_hook():
    """driver.run calls the hook before every step at t0 + i*dt, in its
    2-argument or 3-argument form."""
    cfg = tfilament.config().replace(nx=8, ny=8, nz=4, ndtfast=4)
    g, st, frc = tfilament.setup(cfg, dtype=F64, device="cpu")
    st = st.replace(time=torch.tensor(100.0, dtype=F64))
    times = [100.0 + i * cfg.dt for i in range(3)]
    seen = []

    def two(t, base):
        seen.append(t)
        return base

    def three(t, base, state):
        seen.append((t, float(state.time)))
        return base

    trun_driver(g, st, frc, cfg, nsteps=3, forcing_fn=two)
    assert seen == times
    seen.clear()
    trun_driver(g, st, frc, cfg, nsteps=3, forcing_fn=three)
    assert seen == list(zip(times, times))


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    return tmp_path_factory.mktemp("uswc")


def test_generate_inputs_matches_jax(workdir):
    jp = juswc.generate_inputs(str(workdir / "jax_inputs"))
    tp = tuswc.generate_inputs(str(workdir / "port_inputs"))
    assert tuswc.SCHEMA_VERSION == juswc.SCHEMA_VERSION
    assert sorted(tp) == sorted(jp)
    assert sorted(os.listdir(workdir / "port_inputs")) == \
        sorted(os.listdir(workdir / "jax_inputs"))
    for key in jp:
        with jnc.open_dataset(jp[key]) as a, tnc.open_dataset(tp[key]) as b:
            assert a.attrs == b.attrs and a.dimensions == b.dimensions
            assert sorted(a.variables) == sorted(b.variables), key
            for name, va in a.variables.items():
                vb = b[name]
                assert vb.dims == va.dims and vb.attrs.keys() == va.attrs.keys()
                np.testing.assert_array_equal(vb[...], va[...],
                                              err_msg=f"{key}:{name}")


@pytest.mark.parametrize("edge", ["west", "east", "south", "north"])
def test_climatology_edge_series_matches_jax(edge, workdir):
    path = str(workdir / "clm.nc")
    if not os.path.exists(path):
        dom = tuswc.domain()
        tuswc.write_climatology(path, dom, tuswc.initial_state(dom))
    with jnc.open_dataset(path) as jd, tnc.open_dataset(path) as td:
        a = jexperiment._clm_edge_series(jd, "temp", edge)
        b = texperiment._clm_edge_series(td, "temp", edge)
        # before the first record (wraps to the last), inside, and in the
        # next cycle
        for days in (5.0, 200.0, 3654.3):
            np.testing.assert_array_equal(b.value(days * DAY),
                                          a.value(days * DAY))


@pytest.mark.parametrize("extra,what", [
    ("example_input_surface_forcing.nc", "bulk"),
    ("example_input_tides.nc", "tidal"),
    ("example_input_bgc_surface_forcing_clim.nc", "BGC"),
    (None, "mCDR")])
def test_assemble_accepts_what_is_ported(extra, what, workdir):
    """Flux_frc with one more input: the bulk-COARE, tidal or BGC forcing
    file, or mCDR releases; `forcing_fn` carries what it brings."""
    inp = str(workdir / "port_inputs")
    paths = tuswc.generate_inputs(inp)
    text = tflux.BENCHMARK_IN
    if extra is not None:
        text = text.replace(
            "{inp}/example_input_boundary_forcing.nc\n",
            "{inp}/example_input_boundary_forcing.nc\n     {inp}/" + extra
            + "\n")
    infile = workdir / f"accept_{what}.in"
    infile.write_text(text.format(inp=inp, ntimes=3))
    exp = texperiment.assemble(
        str(infile), tflux.base_config(), nz=tuswc.NZ, dtype=F64,
        device="cpu", cdr_mode="3d" if extra is None else None,
        cdr_file=paths["cdr_3d"] if extra is None else None)
    try:
        frc = exp.forcing_fn(float(exp.state.time), exp.forcing0, exp.state)
    finally:
        exp.fileset.close()
    assert exp.forcing_fn.needs_state == (what == "bulk")
    carried = {"bulk": frc.bgc is not None and "wspd" in frc.bgc,
               "tidal": exp.tides is not None and frc.ptide is not None,
               "BGC": frc.bgc is not None and "pco2_air" in frc.bgc,
               "mCDR": frc.cdr is not None and frc.cdr.flx_3d is not None}
    assert carried[what] and sum(carried.values()) == 1


def test_fileset_close_releases_every_file(workdir, monkeypatch):
    """`Experiment.fileset.close()` closes every file `assemble` opened and
    did not close itself, the climatology included."""
    inp = str(workdir / "port_inputs")
    tuswc.generate_inputs(inp)
    clm = str(workdir / "clm_close.nc")
    dom = tuswc.domain()
    tuswc.write_climatology(clm, dom, tuswc.initial_state(dom))
    infile = workdir / "with_climatology.in"
    infile.write_text(tflux.BENCHMARK_IN.format(inp=inp, ntimes=3)
                      + f"\nclimatology:\n     {clm}\n")
    opened = []

    def recording(path):
        ds = tnc.open_dataset(path)
        opened.append((path, ds))
        return ds
    monkeypatch.setattr(texperiment, "open_dataset", recording)
    exp = texperiment.assemble(str(infile), tflux.base_config(),
                               nz=tuswc.NZ, dtype=F64, device="cpu")
    assert clm in [path for path, _ in opened]
    exp.fileset.close()
    assert [path for path, ds in opened if ds._closer is not None] == []


@pytest.fixture(scope="module", params=sorted(CASES))
def built(request, workdir):
    """(case, JAX experiment, port experiment), each assembled from the
    inputs its own package wrote."""
    case = request.param
    jmod, tmod = CASES[case]
    jexp = jmod.build(str(workdir / f"jax_{case}"), ntimes=3,
                      dtype=jnp.float64)
    texp = tmod.build(str(workdir / f"port_{case}"), ntimes=3, dtype=F64,
                      device="cpu")
    yield case, jexp, texp
    jexp.fileset.close()
    texp.fileset.close()


def test_assemble_matches_jax(built):
    case, jexp, texp = built
    assert texp.cfg == port_cfg(jexp.cfg)
    assert_fields_close(jexp.grid, texp.grid, 1e-13)
    # omega's vertical integral: the port's cumsum against the JAX
    # package's associative scan (the bound of tests/test_torch_ops.py)
    got = bridge.to_numpy(texp.state)
    for name, ref in np_fields(jexp.state).items():
        tol = 1e-11 if name in ("we", "wi") else 1e-13
        np.testing.assert_allclose(
            got[name], ref, rtol=tol,
            atol=tol * (max(1.0, np.abs(ref).max()) if name in ("we", "wi")
                        else 1.0), err_msg=name)
    assert_fields_close(jexp.forcing0, texp.forcing0, 1e-13)
    if texp.cfg.sponge:
        assert texp.grid.visc2_r is not None and texp.grid.diff2 is not None
    if texp.cfg.pipe_source:
        assert texp.forcing0.pipe_idx.dtype == torch.int32
    if texp.cfg.river_source:
        assert bool((texp.forcing0.riv_uflx != 0).any()
                    or (texp.forcing0.riv_vflx != 0).any())


@pytest.mark.parametrize("offset_days", [0.0, 0.3, 0.5, 1.2],
                         ids=["start", "inside", "boundary", "past_first"])
def test_forcing_fn_matches_jax(built, offset_days):
    _, jexp, texp = built
    t = float(texp.state.time) + offset_days * DAY
    assert t == float(jexp.state.time) + offset_days * DAY
    ref = jexp.forcing_fn(t, jexp.forcing0, jexp.state)
    got = texp.forcing_fn(t, texp.forcing0)
    assert_fields_close(ref, got, 1e-14)


def test_three_steps_match_oracle(built):
    case, _, texp = built
    assert cuda_tracer.usable(texp.cfg) == (not texp.cfg.river_source)
    _, rows = texp.run(nsteps=3)
    oracle = np.loadtxt(oracle_path(case))[:4]
    assert rows.shape == oracle.shape
    for col, rtol in zip((1, 2, 3, 4), RTOL):
        np.testing.assert_allclose(rows[:, col], oracle[:, col], rtol=rtol,
                                   atol=1e-300, err_msg=f"{case} col {col}")


def test_real_data_path_imports_no_jax():
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = (
        "import sys\n"
        "from roms_tpu_torch import experiment, forcing, runconfig, audit\n"
        "from roms_tpu_torch import sponge, driver, monitor, grid\n"
        "from roms_tpu_torch import __main__\n"
        "from roms_tpu_torch.io import (async_io, input, netcdf, output,\n"
        "                               bgc_io, zslice, extract, upscale)\n"
        "from roms_tpu_torch.tools import grid_gen, nc3to4z, nesting, sample\n"
        "from roms_tpu_torch.ops import rivers, bulk, isoneutral, wvlcty\n"
        "from roms_tpu_torch import bridge, cdr, remap, stepper, tides\n"
        "from roms_tpu_torch import nhmg, particles, pflx, sponge_tune\n"
        "from roms_tpu_torch.bgc import api, bec, carbonate, npzd\n"
        "from roms_tpu_torch.cases import (flux_frc, pipes_ana, pipes_real,\n"
        "                                  rivers_ana, rivers_real, uswc,\n"
        "                                  bgc_real, cdr_real, cdr_3d,\n"
        "                                  cdr_dp, cdr_parameterized,\n"
        "                                  nested_basin)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'roms_tpu', 'h5py')]\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = root
    res = subprocess.run([sys.executable, "-c", code], cwd=root, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"
