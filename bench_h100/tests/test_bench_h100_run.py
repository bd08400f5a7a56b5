"""A run of a cell end to end on the CPU at a small grid, as the card
runs it but for the look for a card: the result line's keys, `correct`
true for the program, and false with the timed path broken underneath
and for the control; the command's refusals."""

import json
import math
import os
import shutil
import subprocess
import sys
import time

import pytest

from bench_h100 import control, harness

SMALL = {"filament-512x256x60": dict(nx=32, ny=32, nz=8),
         "production-384x192x60": dict(nx=24, ny=16, nz=8, nt=4),
         "production-920x480x60": dict(nx=24, ny=16, nz=8, nt=4)}
SECONDS = 1.0
SEED = 2**31 + 12345


def run(cell, traced=False, fault=None, seed=SEED):
    return harness.run_cell(cell, seed, SECONDS, traced, time.perf_counter(),
                            device="cpu", model_overrides=SMALL[cell],
                            fault=fault)


def patch(module_name, attr, make):
    """A fault: module.attr replaced by make(original); returns undo."""
    def plant():
        import importlib
        mod = importlib.import_module(module_name)
        orig = getattr(mod, attr)
        setattr(mod, attr, make(orig))
        return lambda: setattr(mod, attr, orig)
    return plant


def unchanged(step):
    """A step that returns its state unchanged."""
    return lambda st, *a, **k: st


def half_stepped(step):
    """A step that leaves the northern half of the grid's rows as they
    were: half of the work left out."""
    def fault(st, *a, **k):
        new = step(st, *a, **k)
        jy = st.zeta.shape[-2]
        kw = {}
        for f in ("zeta", "ubar", "vbar", "u", "v", "t"):
            x = getattr(new, f).clone()
            x[..., jy // 2:, :] = getattr(st, f)[..., jy // 2:, :]
            kw[f] = x
        return new.replace(**kw)
    return fault


def no_halo(make_halo_fill):
    """The halo refresh, the single block's stand-in for the exchange
    between chips, left out."""
    return lambda cfg: (lambda a: a)


def altered(run_fn):
    """The timed call's answer altered where it is produced: one value of
    the surface temperature moved by 10 % of the field's range."""
    def fault(*a, **k):
        st, rows = run_fn(*a, **k)
        t = st.t.clone()
        rng = float(t[0].max() - t[0].min())
        t[0, -1, t.shape[-2] // 2, t.shape[-1] // 2] += 0.1 * rng
        return st.replace(t=t), rows
    return fault


FAULTS = {
    "state_unchanged": patch("roms_tpu_torch.driver", "step", unchanged),
    "half_the_grid": patch("roms_tpu_torch.driver", "step", half_stepped),
    "halo_left_out": patch("roms_tpu_torch.stepper", "make_halo_fill",
                           no_halo),
    "answer_altered": patch("roms_tpu_torch.driver", "run", altered),
}


@pytest.mark.parametrize("cell", sorted(SMALL))
def test_result_line(cell):
    res = run(cell)
    assert list(res)[:5] == ["correct", "attempted", "failed", "metrics",
                             "device"]
    assert list(res)[-1] == "compared"
    assert res["correct"] is True and res["failed"] == 0
    assert res["attempted"] == harness.window_steps(
        harness.load_cell(cell), SECONDS)
    assert {"mpoint_steps_per_s", "setup_s"} <= set(res["metrics"])
    for m in res["metrics"].values():
        assert math.isfinite(m["value"]) and m["value"] > 0
    for c in res["compared"].values():
        assert c["value"] <= c["limit"]
    json.dumps(res)


def test_traced_result_line():
    cell = "production-384x192x60"
    res = run(cell, traced=True)
    assert res["correct"] is True
    assert res["attempted"] == harness.window_steps(
        harness.load_cell(cell), SECONDS) + 2
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
    assert "window_s" in res["device"] and "busy_s" in res["device"]
    # no kernel runs on the CPU: the host span is read, the device
    # metrics find nothing and are left out, never 0
    assert res["metrics"]["fast_loop_host_ms"]["value"] > 0
    assert "device_idle_share" not in res["metrics"]


@pytest.mark.parametrize("cell", sorted(SMALL))
@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_broken_timed_path_is_not_correct(cell, fault):
    res = run(cell, fault=FAULTS[fault])
    assert res["correct"] is False, res["compared"]
    assert res["failed"] == res["attempted"]


@pytest.mark.parametrize("cell", sorted(SMALL))
def test_control_is_not_correct(cell):
    """The reference in bfloat16 in the program's place fails the cell's
    limits."""
    limits = harness.load_cell(cell).params["limits"]
    out = control.control_readings(cell, 7, SECONDS, device="cpu",
                                   model_overrides=SMALL[cell])
    assert set(out) == set(control.PRECISIONS)
    for precision, r in out.items():
        assert any(r[f] > limits[f] for f in limits), (precision, r)


def test_no_card_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    res = subprocess.run(
        [sys.executable, str(harness.BENCH / "run.py"), "--workload",
         "filament-512x256x60", "--seed", "1", "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, env=env,
        cwd=harness.ROOT, timeout=300)
    assert res.returncode != 0 and res.stdout.strip() == ""


def test_benchmark_alone_gives_no_result(tmp_path):
    shutil.copy(harness.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(harness.BENCH, tmp_path / "bench_h100",
                    ignore=shutil.ignore_patterns("__pycache__"))
    res = subprocess.run(
        [sys.executable, "bench_h100/run.py", "--workload",
         "filament-512x256x60", "--seed", "1", "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, cwd=tmp_path,
        timeout=300)
    assert res.returncode != 0 and res.stdout.strip() == ""


@pytest.mark.h100
@pytest.mark.parametrize("cell", sorted(SMALL))
def test_cell_on_the_card(card, cell):
    """A short run of each cell at its own size on the card."""
    res = subprocess.run(
        [sys.executable, "bench_h100/run.py", "--workload", cell, "--seed",
         str(SEED), "--seconds", "3", "--trace", "0"],
        capture_output=True, text=True, cwd=harness.ROOT, timeout=900)
    assert res.returncode == 0, res.stderr[-4000:]
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert out["correct"] is True, out["compared"]
    assert out["device"]["platform"] == "gpu"
