"""The port's restart files, exact restart and asynchronous output, in
float64 on the CPU:

(a) restart interchange: for the same bridged state the restart variables
    the port writes are bitwise equal to the JAX package's (names, dims,
    float64 data), and each package reads the other's file back to the
    state; `read_restart` gives an int32 0-d `iic`, 0-d scalars, None for
    the dict fields, and the requested dtype and device;
(b) continuation: a JAX restart written after 3 Filament steps, continued
    3 steps by each package, agrees within the 3-step tolerance of
    tests/torch_helpers.py (5e-11 * max(1, max|ref|));
(c) exact restart of the port: 6 steps equal 3 steps + write/read + 3
    steps bitwise (tests/test_io.py:72);
(d) an async history file equals the synchronous one bitwise
    (tests/test_async_io.py:61); the writer sink keeps order and re-raises;
(e) immutability, on which the async hook rests: clones of every state
    field taken in the hook equal the fields after the next step.
"""

import dataclasses
import threading
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from roms_tpu.cases import filament as jfilament
from roms_tpu.io import output as jout

from roms_tpu_torch import bridge
from roms_tpu_torch.cases import bench_production, filament, obc_basin
from roms_tpu_torch.driver import run
from roms_tpu_torch.io import HistoryWriter, read_restart, write_restart
from roms_tpu_torch.io.async_io import AsyncSink, make_async_hook
from roms_tpu_torch.io.netcdf import open_dataset
from roms_tpu_torch.ops.weights import set_weights
from roms_tpu_torch.state import OceanState
from roms_tpu_torch.stepper import step

from torch_helpers import (F64, assert_state_close, np_fields, np_tree,
                           port_cfg, run_jax)

torch.set_num_threads(1)

STEP_TOL = 5e-11


def _jax_filament():
    jcfg = jfilament.config(ntimes=10).replace(nx=16, ny=16, nz=8)
    return (jcfg,) + tuple(jfilament.setup(jcfg))


def _same_restart_vars(port_path, jax_path):
    with open_dataset(port_path) as a, open_dataset(jax_path) as b:
        assert a.dimensions == b.dimensions
        assert sorted(a.variables) == sorted(b.variables)
        for n in b.variables:
            assert a[n].dims == b[n].dims and a[n].dtype == b[n].dtype, n
            np.testing.assert_array_equal(a[n][...], b[n][...], err_msg=n)


def test_restart_interchange(tmp_path):
    jcfg, jgrid, jst, jfrc = _jax_filament()
    jst = run_jax(jcfg, jgrid, jst, jfrc, nsteps=1)
    tcfg = port_cfg(jcfg)
    tst = bridge.state_from_numpy(np_tree(jst), dtype=F64, device="cpu")
    pj, pt = str(tmp_path / "jax_rst.nc"), str(tmp_path / "port_rst.nc")
    jout.write_restart(pj, jst, jcfg)
    write_restart(pt, tst, tcfg)
    _same_restart_vars(pt, pj)

    ref = np_fields(jst)
    back = bridge.to_numpy(read_restart(pj, tcfg, device="cpu"))
    jback = np_fields(jout.read_restart(pt, jcfg))
    for name, a in ref.items():
        np.testing.assert_array_equal(back[name], a, err_msg=name)
        np.testing.assert_array_equal(jback[name], a, err_msg=name)


def test_read_restart_types(tmp_path):
    # not square: on a square grid both horizontal dims are named xi_pad
    cfg = filament.config().replace(nx=10, ny=8, nz=4)
    grid, st, _ = filament.setup(cfg, device="cpu")
    st = st.replace(iic=torch.tensor(7, dtype=torch.int32),
                    time=torch.tensor(315705600.0, dtype=F64))
    path = str(tmp_path / "rst.nc")
    write_restart(path, st, cfg)
    with open_dataset(path) as ds:
        assert ds["iic"].shape == (1,) and ds["iic"].dtype.str[1:] == "f8"
        assert ds["t"].dims == ("tracer", "s_rho", "eta_pad", "xi_pad")
        assert "upscale" not in ds
    for dtype in (None, torch.float32):
        back = read_restart(path, cfg, dtype=dtype, device="cpu")
        assert back.iic.dtype == torch.int32 and back.iic.shape == ()
        assert int(back.iic) == 7
        assert back.time.shape == () and back.zeta.device.type == "cpu"
        assert back.zeta.dtype == (dtype or torch.float64)
        assert back.time.dtype == (dtype or torch.float64)
        assert back.upscale is None and back.t_budget is None \
            and back.uv_budget is None
        if dtype is None:
            for f in dataclasses.fields(OceanState):
                a = getattr(st, f.name)
                if isinstance(a, torch.Tensor):
                    assert torch.equal(getattr(back, f.name), a.to(
                        getattr(back, f.name).dtype)), f.name
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            read_restart(path, cfg)


def test_continuation_of_a_jax_restart(tmp_path):
    """A JAX restart after 3 steps, continued 3 steps (not first steps) by
    the JAX package and by the port from the same file."""
    jcfg, jgrid, jst, jfrc = _jax_filament()
    jst = run_jax(jcfg, jgrid, jst, jfrc, nsteps=3)
    path = str(tmp_path / "rst.nc")
    jout.write_restart(path, jst, jcfg)

    from roms_tpu.ops.weights import set_weights as jset_weights
    from roms_tpu.stepper import step as jstep
    w1, w2, _ = jset_weights(jcfg.ndtfast)
    ref = jout.read_restart(path, jcfg)
    for _ in range(3):
        ref = jstep(ref, jfrc, jgrid, jnp.asarray(w1), jnp.asarray(w2), jcfg,
                    first_step=False)

    tcfg = port_cfg(jcfg)
    grid = bridge.grid_from_numpy(np_tree(jgrid), dtype=F64, device="cpu")
    frc = bridge.forcing_from_numpy(np_tree(jfrc), dtype=F64, device="cpu")
    st = read_restart(path, tcfg, device="cpu")
    w1, w2, _ = set_weights(tcfg.ndtfast)
    for _ in range(3):
        st = step(st, frc, grid, w1, w2, tcfg, first_step=False)
    assert_state_close(bridge.to_numpy(st), ref, STEP_TOL)


def test_exact_restart(tmp_path):
    """6 steps equal 3 steps + restart write/read + 3 more steps, bit for
    bit (restarted runs continue with first_step=False, as the reference's
    exact restart does)."""
    cfg = filament.config(ntimes=10).replace(nx=16, ny=16, nz=8)
    grid, st0, frc = filament.setup(cfg, device="cpu")
    st_ref, _ = run(grid, st0, frc, cfg, nsteps=6, collect_diag=False)
    st_a, _ = run(grid, st0, frc, cfg, nsteps=3, collect_diag=False)
    path = str(tmp_path / "rst.nc")
    write_restart(path, st_a, cfg)
    st_b = read_restart(path, cfg, device="cpu")
    w1, w2, _ = set_weights(cfg.ndtfast)
    for _ in range(3):
        st_b = step(st_b, frc, grid, w1, w2, cfg, first_step=False)
    for f in dataclasses.fields(st_ref):
        a, b = getattr(st_ref, f.name), getattr(st_b, f.name)
        if a is None:
            assert b is None, f.name
            continue
        assert torch.equal(a, b), f.name


def test_async_hook_output_identical(tmp_path):
    """driver.run with an async writer hook writes the same history file as
    with the synchronous hook, and drains before returning."""
    cfg = obc_basin.config("inflow", ntimes=3).replace(
        nx=12, ny=10, nz=4, dt=60.0, ndtfast=12)
    grid, st, frc = obc_basin.setup(cfg, inflow_u=0.1, t_inflow=2.0,
                                    device="cpu")
    paths = {}
    for mode in ("sync", "async"):
        path = str(tmp_path / f"his_{mode}.nc")
        hw = HistoryWriter(path, grid, cfg)
        hook = (lambda s, i, hw=hw: hw.write(s))
        if mode == "async":
            hook = make_async_hook(hook)
        run(grid, st, frc, cfg, nsteps=3, step_hook=hook, collect_diag=False)
        assert hw.rec == 3          # drained: every record written
        hw.close()
        paths[mode] = path
    with open_dataset(paths["sync"]) as a, open_dataset(paths["async"]) as b:
        assert sorted(a.variables) == sorted(b.variables)
        for name in a.variables:
            np.testing.assert_array_equal(a[name][...], b[name][...],
                                          err_msg=name)


def test_async_sink_orders_bounds_and_reraises():
    sink = AsyncSink(max_pending=2)
    out, active, peak = [], [0], [0]
    lock = threading.Lock()

    def job(i):
        with lock:
            active[0] += 1
            peak[0] = max(peak[0], active[0])
        time.sleep(0.002)
        out.append(i)
        with lock:
            active[0] -= 1

    for i in range(20):
        sink.submit(job, i)
        assert len(sink._futs) <= 2
    sink.drain()
    assert out == list(range(20)) and peak[0] == 1

    def bad():
        raise OSError("disk full")

    sink.submit(bad)
    with pytest.raises(OSError, match="disk full"):
        sink.drain()
    sink.submit(bad)
    with pytest.raises(OSError, match="disk full"):
        for _ in range(3):
            sink.submit(job, 0)


@pytest.mark.parametrize("case", ["production", "filament"])
def test_step_never_writes_into_a_returned_state(case):
    """Clones of every field of the state the hook receives equal that
    state's fields after the next step and after the run: the step only
    replaces tensors (production physics: KPP, open boundaries with data,
    4 tracers; Filament: periodic, linear EOS)."""
    if case == "production":
        cfg = bench_production.config(nx=24, ny=16, nz=8, nt=4)
        grid, st, frc = bench_production.setup(cfg, dtype=F64, device="cpu")
    else:
        cfg = filament.config().replace(nx=16, ny=16, nz=8)
        grid, st, frc = filament.setup(cfg, device="cpu")
    held = []

    def fields(s):
        return {f.name: getattr(s, f.name) for f in dataclasses.fields(s)
                if isinstance(getattr(s, f.name), torch.Tensor)}

    def hook(s, i):
        for old, clones in held:
            for name, a in fields(old).items():
                assert torch.equal(a, clones[name]), (i, name)
        held.append((s, {k: v.clone() for k, v in fields(s).items()}))

    run(grid, st, frc, cfg, nsteps=3, step_hook=hook, collect_diag=False)
    hook(st, 0)
    assert len(held) == 4


def _define(w, scipy):
    """One file's definitions and writes, as the port's writer takes them
    and as scipy's netcdf_file takes them."""
    if scipy:
        for name, size in (("time", None), ("x", 5), ("y", 3), ("n", 2)):
            w.createDimension(name, size)
        w.title, w.count, w.scale, w.cycle = "t", 3, 2.5, np.float64(365.25)
    else:
        for name, size in (("time", None), ("x", 5), ("y", 3), ("n", 2)):
            w.create_dim(name, size)
    specs = [("a", ("time", "x"), "f8", {"units": "m"}), ("b", ("x",), "f4",
             {}), ("c", ("time", "y", "x"), "f4", {}), ("t", ("time",), "f8",
             {}), ("s", ("y",), "f8", {}), ("k", ("n", "x"), "f8", {})]
    rng = np.random.default_rng(1)
    vals = {n: rng.standard_normal((4,) + (5,) * (n != "s")) for n in "abcks"}
    for name, dims, dt, attrs in specs:
        if scipy:
            v = w.createVariable(name, dt, dims)
            for k, a in attrs.items():
                setattr(v, k, a)
        else:
            w.create_var(name, dims, dt, attrs)
    put = (lambda n, a, rec=None: w.variables[n].__setitem__(
        slice(None) if rec is None else rec, a)) if scipy else w.write
    put("b", vals["b"][0])
    put("s", vals["s"][:3])
    for r in (1, 0):                     # a fixed dimension, indexed
        put("k", vals["k"][r], rec=r)
    for r in range(3):
        put("a", vals["a"][r], rec=r)
        put("t", 10.0 * r, rec=r)
        if r != 1:                       # record 1 of c is never written
            put("c", np.broadcast_to(vals["c"][r], (3, 5)), rec=r)


def test_ncwriter_writes_scipys_bytes(tmp_path):
    """The port's record-append writer writes the bytes scipy's
    netcdf_file (the JAX package's writer) writes for the same
    definitions and data, while each record goes to the file as it
    comes: the file holds every record so far after each sync."""
    from scipy.io import netcdf_file

    from roms_tpu_torch.io.netcdf import NCWriter
    pt, ps = str(tmp_path / "port.nc"), str(tmp_path / "scipy.nc")
    w = NCWriter(pt, {"title": "t", "count": 3, "scale": 2.5,
                      "cycle": np.float64(365.25)})
    _define(w, scipy=False)
    w.sync()
    with open_dataset(pt) as ds:
        assert ds["a"].shape == (3, 5) and ds["t"][2] == 20.0
    with pytest.raises(RuntimeError, match="layout is fixed"):
        w.create_var("late", ("x",))
    w.close()
    f = netcdf_file(ps, "w", version=2, mmap=False)
    _define(f, scipy=True)
    f.close()
    with open(pt, "rb") as a, open(ps, "rb") as b:
        assert a.read() == b.read()
