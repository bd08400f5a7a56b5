"""The port's Filament step end to end on the CPU, in float64:

(a) its setup against roms_tpu.cases.filament.setup, every state and grid
    field at 1e-13;
(b) three steps of a small Filament against roms_tpu.stepper.step, every
    state field at atol 5e-11 * max(1, max|ref|) (the bound of
    tests/test_pallas_tracer.py:test_full_step_matches_jnp; sums and
    cumulative sums run in another order than XLA's);
(c) the 20-step Filament at 64x64x32 through the port's driver.run
    against tests/data/filament_oracle.txt at the rtols of
    tests/test_filament_regression.py;
(d) a fresh interpreter runs a Filament step and a production-physics
    step of the port with no module of jax, flax or roms_tpu imported;
(e) roms_tpu_torch.profile_step reads every layer of a tiny step (the
    batched tracer branch where the tracer kernel does not cover the
    configuration, `forcing_fn` where a case has one, and the BGC block
    of a BGC configuration) and puts the layers back; chip_smoke.py fails
    with no CUDA device;
(f) a case setup builds on the card by default, and raises on a host
    without one rather than falling back to the CPU;
(g) a step with each of the five options that earlier slices refused
    (adv_isoneutral, non_hydrostatic, tracer_diagnostics, uv_diagnostics,
    upscale_output) runs; the bridge carries a state with the budget
    and upscale dicts, nested for uv_budget, both ways.
"""

import dataclasses
import inspect
import os
import subprocess
import sys
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from roms_tpu.cases import filament as jfilament
from roms_tpu.ops.weights import set_weights
from roms_tpu.stepper import step as jstep

from roms_tpu_torch import bridge, profile_step, stepper
from roms_tpu_torch.cases import bench_production as tbp
from roms_tpu_torch.cases import filament as tfilament
from roms_tpu_torch.cases import obc_basin as tbasin
from roms_tpu_torch.cases import rivers_ana as trivers_ana
from roms_tpu_torch.driver import run
from roms_tpu_torch.experiment import Experiment
from roms_tpu_torch.stepper import step as tstep

from torch_helpers import np_tree, port_cfg

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ORACLE = os.path.join(ROOT, "tests", "data", "filament_oracle.txt")
F64 = torch.float64


def _fields(x):
    return {f.name: getattr(x, f.name) for f in dataclasses.fields(x)
            if getattr(x, f.name) is not None}


@pytest.fixture(scope="module")
def small():
    cfg = jfilament.config().replace(nx=32, ny=24, nz=8)
    return cfg, jfilament.setup(cfg)


def test_setup_matches_jax(small):
    cfg, (jg, jst, jfrc) = small
    tg, tst, tfrc = tfilament.setup(port_cfg(cfg), dtype=F64, device="cpu")
    assert tfilament.config() == bridge.config_from_dict(
        dataclasses.asdict(jfilament.config()))
    for jx, tx in ((jg, tg), (jst, tst), (jfrc, tfrc)):
        tf = _fields(tx)
        jf = _fields(jx)
        assert set(tf) == set(jf)
        for name, a in jf.items():
            b = bridge.to_numpy(tf[name])
            np.testing.assert_allclose(b, np.asarray(a), rtol=1e-13,
                                       atol=1e-13, err_msg=name)


def test_three_steps_match_jax(small):
    cfg, (jg, jst, jfrc) = small
    tg = bridge.grid_from_numpy(np_tree(jg), dtype=F64, device="cpu")
    tst = bridge.state_from_numpy(np_tree(jst), dtype=F64, device="cpu")
    tfrc = bridge.forcing_from_numpy(np_tree(jfrc), dtype=F64, device="cpu")
    w1, w2, _ = set_weights(cfg.ndtfast)
    jw1, jw2 = jnp.asarray(w1), jnp.asarray(w2)
    tcfg = port_cfg(cfg)
    for i in range(3):
        jst = jstep(jst, jfrc, jg, jw1, jw2, cfg, first_step=(i == 0))
        tst = tstep(tst, tfrc, tg, w1, w2, tcfg, first_step=(i == 0))
    got = bridge.to_numpy(tst)
    for name, a in _fields(jst).items():
        a = np.asarray(a)
        scale = max(1.0, float(np.abs(a).max()))
        np.testing.assert_allclose(got[name], a, rtol=0, atol=5e-11 * scale,
                                   err_msg=name)


def test_twenty_step_oracle():
    cfg = tfilament.config(ntimes=20)
    grid, st, frc = tfilament.setup(cfg, dtype=F64, device="cpu")
    _, rows = run(grid, st, frc, cfg, nsteps=20)
    oracle = np.loadtxt(ORACLE)
    assert rows.shape == oracle.shape
    assert np.allclose(rows[0, 1:4], oracle[0, 1:4], rtol=1e-11)
    for col, rtol in ((1, 1e-9), (2, 1e-8), (3, 1e-9)):
        np.testing.assert_allclose(rows[:, col], oracle[:, col], rtol=rtol,
                                   err_msg=f"diagnostics column {col}")
    np.testing.assert_allclose(rows[:, 4], 0.0, atol=1e-12)


def test_port_imports_no_jax():
    code = (
        "import sys, torch\n"
        "from roms_tpu_torch.cases import bench_production, filament\n"
        "from roms_tpu_torch.driver import run\n"
        "cfg = filament.config().replace(nx=8, ny=8, nz=4, ndtfast=4)\n"
        "g, s, f = filament.setup(cfg, dtype=torch.float64, device='cpu')\n"
        "s, rows = run(g, s, f, cfg, nsteps=1)\n"
        "assert rows.shape == (2, 5)\n"
        "cfg = bench_production.config(nx=10, ny=8, nz=4, nt=3)\n"
        "g, s, f = bench_production.setup(cfg, dtype=torch.float64, "
        "device='cpu')\n"
        "s, rows = run(g, s, f, cfg, nsteps=1)\n"
        "assert rows.shape == (2, 5)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'roms_tpu')]\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = ROOT
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"


def test_profile_step_reads_every_layer():
    cfg = tfilament.config().replace(nx=16, ny=12, nz=4, ndtfast=6)
    before = [getattr(m, n) for m, n in profile_step.LAYERS]
    out = profile_step.profile(cfg, torch.device("cpu"), dtype=F64,
                               say=lambda *a: None)
    assert [getattr(m, n) for m, n in profile_step.LAYERS] == before
    # Filament has no KPP and no lateral viscosity
    assert set(out["layers_ms"]) == {n for _, n in profile_step.LAYERS} - {
        "vmix_update", "visc3d"}
    assert len(out["wall_ms"]) == profile_step.WALL_WINDOWS
    assert 0 < sum(out["layers_ms"].values()) < out["layer_step_ms"]


def test_profile_step_reads_the_production_case():
    """`--case production` runs every layer, the KPP kernel's included."""
    cfg = tbp.config(nx=10, ny=8, nz=4, nt=3)
    out = profile_step.profile(cfg, torch.device("cpu"), dtype=F64,
                               say=lambda *a: None, case=tbp)
    assert set(out["layers_ms"]) == {n for _, n in profile_step.LAYERS}
    assert 0 < sum(out["layers_ms"].values()) < out["layer_step_ms"]
    # the spans reading: the program's spans a step, the same in the
    # Timers sink and in the profiled steps; no runtime calls to count
    nfast = len(set_weights(cfg.ndtfast)[0])
    assert out["span_calls"] == out["profiled_span_calls"]
    assert out["span_calls"]["roms.fast.bc2d"] == 2 * nfast
    assert out["span_ms"]["roms.fast_loop"] < out["span_ms"]["roms.step"]
    assert "launch_calls_per_step" not in out


def test_profile_step_reads_the_batched_tracer_branch():
    """A river case leaves the tracer kernel out (`cuda_tracer.usable`):
    the batched branch's functions are read as layers instead, and put
    back."""
    cfg = trivers_ana.config().replace(nx=20, ny=20, nz=4, ndtfast=6)
    before = [getattr(m, n) for m, n in profile_step.BATCHED]
    out = profile_step.profile(cfg, torch.device("cpu"), dtype=F64,
                               say=lambda *a: None, case=trivers_ana)
    assert [getattr(m, n) for m, n in profile_step.BATCHED] == before
    # Rivers_ana has no lateral viscosity or diffusion
    names = {n for _, n in profile_step.LAYERS + profile_step.BATCHED}
    assert set(out["layers_ms"]) == names - {"tracer_stage", "visc3d",
                                             "t3dmix"}
    assert 0 < sum(out["layers_ms"].values()) < out["layer_step_ms"]


def test_profile_step_reads_forcing_fn_of_a_built_case():
    """A case with `build` runs with its experiment's forcing_fn, read as
    a layer in the bracketed steps, and its files are closed after."""
    cfg = tfilament.config().replace(nx=16, ny=12, nz=4, ndtfast=6)
    calls, closed = [], []

    def forcing_fn(t, base):
        calls.append(t)
        return base

    def build(workdir, ntimes, dtype, device):
        assert workdir == "inputs"
        grid, st, frc = tfilament.setup(cfg, dtype=dtype, device=device)
        return Experiment(cfg=cfg, grid=grid, state=st, forcing0=frc,
                          forcing_fn=forcing_fn, rc=None,
                          fileset=types.SimpleNamespace(
                              close=lambda: closed.append(True)))
    case = types.SimpleNamespace(__name__="roms_tpu_torch.cases.built",
                                 build=build)
    out = profile_step.profile(None, torch.device("cpu"), dtype=F64,
                               say=lambda *a: None, case=case,
                               workdir="inputs")
    # the spans reading's two calls run with the case's forcing_fn too
    nsteps = (profile_step.WARM + profile_step.WALL_WINDOWS
              * profile_step.WALL_STEPS + profile_step.PROF_STEPS
              + profile_step.LAYER_STEPS + profile_step.WALL_STEPS
              + profile_step.PROF_STEPS)
    assert len(calls) == nsteps and closed == [True]
    assert set(out["layers_ms"]) == {n for _, n in profile_step.LAYERS} - {
        "vmix_update", "visc3d"} | {"forcing_fn"}


def test_profile_step_reads_the_bgc_block():
    """A BGC configuration (the closed basin with MARBL's 32 tracers) reads
    `stepper.bgc_update` as a layer and puts it back; the profiler sees no
    device kernels on the CPU, so the bgc reading is left out."""
    cfg = tbasin.config("closed").replace(
        nx=12, ny=10, nz=4, ndtfast=6, dt=30.0, nt=33,
        bgc_model="marbl32", n_bgc=32)
    before = stepper.bgc_update
    out = profile_step.profile(cfg, torch.device("cpu"), dtype=F64,
                               say=lambda *a: None, case=tbasin)
    assert stepper.bgc_update is before
    assert "bgc_update" in out["layers_ms"] and "bgc_kernels" not in out
    assert 0 < sum(out["layers_ms"].values()) < out["layer_step_ms"]


def test_profile_step_reads_the_option_layers():
    """The non-hydrostatic projection and the isoneutral slope fields and
    increment are read as layers where the configuration turns them on,
    beside the batched tracer branch that isoneutral mixing takes."""
    cfg = tbp.config(nx=10, ny=8, nz=4, nt=3).replace(
        non_hydrostatic=True, nh_iters=4, adv_isoneutral=True)
    before = [getattr(m, n) for _, extra in profile_step.OPTIONS
              for m, n in extra]
    out = profile_step.profile(cfg, torch.device("cpu"), dtype=F64,
                               say=lambda *a: None, case=tbp)
    assert [getattr(m, n) for _, extra in profile_step.OPTIONS
            for m, n in extra] == before
    assert {"nh_solve", "slope_fields", "isoneutral_increment",
            "tracer_implicit_all"} <= set(out["layers_ms"])
    assert "tracer_stage" not in out["layers_ms"]


def test_chip_smoke_fails_without_cuda():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    res = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT,
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode != 0
    assert '"ok": true' not in res.stdout


@pytest.mark.parametrize("case", [tfilament, tbp])
def test_setup_defaults_to_the_card(case, monkeypatch):
    """With no device argument a case builds on CUDA; a host without a
    CUDA device raises instead of building on the CPU."""
    assert inspect.signature(case.setup).parameters["device"].default \
        == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = case.config()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        case.setup(cfg)


FLAGS = ("adv_isoneutral", "non_hydrostatic", "tracer_diagnostics",
         "uv_diagnostics", "upscale_output")


@pytest.mark.parametrize("flag", FLAGS)
def test_step_takes_every_option(flag):
    cfg = tbasin.config("radiating").replace(nx=12, ny=10, nz=4, ndtfast=6,
                                             nh_iters=5, **{flag: True})
    grid, st, frc = tbasin.setup(cfg, device="cpu")
    st, _ = run(grid, st, frc, cfg, nsteps=1, collect_diag=False)
    assert bool(torch.isfinite(st.u).all())
    out = {"tracer_diagnostics": st.t_budget, "uv_diagnostics": st.uv_budget,
           "upscale_output": st.upscale}
    if flag in out:
        assert out[flag] is not None
    else:
        assert st.t_budget is None and st.uv_budget is None \
            and st.upscale is None


def test_bridge_carries_budgets_and_upscale():
    cfg = tbasin.config("radiating").replace(
        nx=12, ny=10, nz=4, ndtfast=6, tracer_diagnostics=True,
        uv_diagnostics=True, upscale_output=True)
    grid, st, frc = tbasin.setup(cfg, device="cpu")
    st, _ = run(grid, st, frc, cfg, nsteps=1, collect_diag=False)
    d = bridge.to_numpy(st)
    assert set(d["uv_budget"]) == {"u", "v"}
    back = bridge.state_from_numpy(d, dtype=F64, device="cpu")
    assert isinstance(back.uv_budget["u"]["vmix"], torch.Tensor)
    again = bridge.to_numpy(back)
    for name in ("upscale", "t_budget", "uv_budget"):
        ref, got = d[name], again[name]
        pairs = [(k, got[k], v) for k, v in ref.items()]
        while pairs:
            k, g, r = pairs.pop()
            if isinstance(r, dict):
                pairs += [(f"{k} {kk}", g[kk], vv) for kk, vv in r.items()]
            else:
                np.testing.assert_array_equal(g, r, err_msg=f"{name} {k}")
