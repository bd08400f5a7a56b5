"""The benchmark cell `uswc-bgc_real` (UCLA-ROMS's bgc_real: MARBL's 32
BGC tracers, rivers, tides, the sponge) on the CPU at 24x16x8 with all 34
tracers, through `bench_h100.harness.run_cell` as the card runs it:

(a) in float64 the program and the plain reference, each from the
    configuration's `derive`, agree after 3 steps to 1e-12 of each
    field's scale, every tracer included;
(b) in float32 the program is `correct` under the cell's limits;
(c) faults planted in the timed path read `correct: false`: the BGC block
    skipped, its surface flux dropped, the river's tracer flux fix
    skipped, half the grid left unstepped; so does the bfloat16-prognostic
    control;
(d) `stepper.bgc_stats` counts one call a step and `bgc_host_ms` reads it;
    under torch.profiler the `roms.bgc` span opens once a step, inside
    `roms.finish`.
"""

import time

import pytest
import torch

from bench_h100 import compare, control, harness, inputs
from roms_tpu_torch import monitor, stepper
from roms_tpu_torch.driver import run

torch.set_num_threads(1)

CELL = "uswc-bgc_real"
SMALL = dict(nx=24, ny=16, nz=8)
SECONDS = 1.0
SEED = 2**31 + 12345
FIELDS = ("zeta", "ubar", "vbar", "u", "v", "t", "akv", "akt", "hbls")


def run_small(traced=False, fault=None, seconds=SECONDS):
    return harness.run_cell(CELL, SEED, seconds, traced, time.perf_counter(),
                            device="cpu", model_overrides=SMALL, fault=fault)


def patch(module_name, attr, make):
    """A fault: module.attr replaced by make(original); returns undo."""
    def plant():
        import importlib
        mod = importlib.import_module(module_name)
        orig = getattr(mod, attr)
        setattr(mod, attr, make(orig))
        return lambda: setattr(mod, attr, orig)
    return plant


def bgc_skipped(bgc_update):
    return lambda t_new, *a, **k: t_new


def surface_flux_dropped(get_model):
    """The engine with a surface flux of zero (no gas exchange, no
    deposition)."""
    def faulty(name):
        return get_model(name)._replace(
            surface_flux=lambda trc, ctx, forc=None: torch.zeros_like(
                trc[:, -1]))
    return faulty


def river_fix_skipped(tracer_flux_fix_all):
    """The advective fluxes left as they are at the river's faces."""
    return lambda fx, fe, *a, **k: (fx, fe)


def half_stepped(step):
    """A step that leaves the northern half of the grid's rows as they
    were."""
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


FAULTS = {
    "bgc_skipped": patch("roms_tpu_torch.stepper", "bgc_update",
                         bgc_skipped),
    "surface_flux_dropped": patch("roms_tpu_torch.stepper", "get_model",
                                  surface_flux_dropped),
    "river_fix_skipped": patch("roms_tpu_torch.ops.rivers",
                               "tracer_flux_fix_all", river_fix_skipped),
    "half_the_grid": patch("roms_tpu_torch.driver", "step", half_stepped),
}
# the river's faces are a few of the small grid's, so its fault needs a
# longer window (12 steps) to reach the barotropic limits
FAULT_SECONDS = {"river_fix_skipped": 6.0}


def test_program_is_the_reference_in_float64():
    cell = harness.load_cell(CELL)
    model = dict(cell.config["model"], **SMALL)
    states = {}
    for prefix in (inputs.PROGRAM, inputs.REFERENCE):
        lib = inputs.side(prefix)
        cfg = inputs.model_config(lib, model)
        raw = cell.maker.raw_inputs(model, SEED, "cpu")
        grid, st, frc = cell.maker.derive(lib, cfg, raw, torch.float64,
                                          torch.device("cpu"))
        states[prefix] = lib.run(grid, st, frc, cfg, 3)
    got, ref = states[inputs.PROGRAM], states[inputs.REFERENCE]
    assert got.t.shape[0] == 34
    for name in FIELDS:
        assert compare.gap(name, getattr(got, name), ref) <= 1e-12, name
    # every tracer has a range to be read against, and stays finite
    for i in range(ref.t.shape[0]):
        assert bool(torch.isfinite(ref.t[i]).all())
        assert float(ref.t[i].max() - ref.t[i].min()) > 0.0, i


def test_float32_is_correct_and_counts_bgc_calls():
    stepper.bgc_stats["calls"] = 0
    stepper.bgc_stats["host_s"].clear()
    res = run_small(traced=True)
    assert res["correct"] is True, res["compared"]
    assert set(res["compared"]) == set(FIELDS)
    steps = sum(res["run"]["calls"])
    assert res["attempted"] == steps - res["run"]["calls"][0]
    assert stepper.bgc_stats["calls"] == steps
    assert len(stepper.bgc_stats["host_s"]) == steps
    assert res["metrics"]["bgc_host_ms"]["value"] > 0.0


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_broken_timed_path_is_not_correct(fault):
    res = run_small(fault=FAULTS[fault],
                    seconds=FAULT_SECONDS.get(fault, SECONDS))
    assert res["correct"] is False, res["compared"]
    assert res["failed"] == res["attempted"]


def test_control_is_not_correct():
    limits = harness.load_cell(CELL).params["limits"]
    out = control.control_readings(CELL, 7, SECONDS, device="cpu",
                                   model_overrides=SMALL,
                                   precisions=("bfloat16-prognostic",))
    r = out["bfloat16-prognostic"]
    assert any(r[f] > limits[f] for f in limits), r


def test_bgc_span_once_a_step_inside_finish():
    cell = harness.load_cell(CELL)
    model = dict(cell.config["model"], **SMALL)
    prog = inputs.side(inputs.PROGRAM)
    cfg = inputs.model_config(prog, model)
    raw = cell.maker.raw_inputs(model, SEED, "cpu")
    grid, st, frc = cell.maker.derive(prog, cfg, raw, torch.float64,
                                      torch.device("cpu"))
    timers = monitor.Timers()
    acts = [torch.profiler.ProfilerActivity.CPU]
    with monitor.tracing(timers), torch.profiler.profile(
            activities=acts) as prof:
        run(grid, st, frc, cfg, 2, collect_diag=False)
    ranges = {}
    for e in prof.profiler.kineto_results.events():
        if e.name() in ("roms.bgc", "roms.finish"):
            ranges.setdefault(e.name(), []).append(
                (e.start_ns(), e.start_ns() + e.duration_ns()))
    assert timers.calls["roms.bgc"] == 2 == len(ranges["roms.bgc"])
    for s, e in ranges["roms.bgc"]:
        assert any(ps <= s and e <= pe for ps, pe in ranges["roms.finish"])


def test_seed_decides_the_inputs():
    cell = harness.load_cell(CELL)
    model = dict(cell.config["model"], **SMALL)
    a, b, c = (cell.maker.raw_inputs(model, s, "cpu")
               for s in (SEED, SEED, SEED + 1))
    assert torch.equal(a["t"], b["t"])
    # the seed moves T and every BGC tracer, and nothing else
    moved = (a["t"] - c["t"]).abs().amax(dim=(1, 2, 3))
    assert float(moved[1]) == 0.0
    assert bool((moved[[0] + list(range(2, 34))] > 0.0).all())
    for k in ("h", "rmask", "zeta", "u", "riv_uflx", "ptide", "visc2_r"):
        assert torch.equal(a[k], c[k]), k
