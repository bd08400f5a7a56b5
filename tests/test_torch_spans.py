"""The port's own spans (`roms_tpu_torch.monitor.span` / `tracing`) on the
CPU in float64:

(a) tracing off records nothing, and `span` hands out one shared no-op
    context;
(b) with tracing on, a step of a small doubly periodic Filament, of a
    small production-physics grid with four open boundaries and of the
    benchmark's bgc_real inputs (MARBL, rivers, tides), through
    `driver.run` and through `driver.run_distributed` on a 1x1 gloo mesh,
    records per step one roms.step, one of each phase, one
    roms.fast_loop, nfast roms.fast.substep and roms.fast.halo and
    2 * nfast roms.fast.bc2d, bgc_real one roms.bgc, and the driver's
    roms.forcing, roms.diag and roms.output once per call;
(c) under torch.profiler the spans are record_function ranges with the
    names and counts of the Timers sink, and each child lies inside its
    parent in host time;
(d) two steps with tracing on are bitwise the two steps with it off;
(e) `profile_step.reduce_spans` on a synthetic trace: launch calls inside
    and outside roms.fast_loop, a blocking copy with its synchronize and
    an asynchronous one without, idle gaps by the innermost range, the
    shared-clock check, and only the ranges' counts where the trace holds
    no CUDA runtime call.
"""

import dataclasses
from types import SimpleNamespace

import pytest
import torch
import torch.distributed as tdist

from bench_h100 import harness, inputs
from roms_tpu_torch import monitor, profile_step
from roms_tpu_torch.cases import bench_production as tbp
from roms_tpu_torch.cases import filament as tfilament
from roms_tpu_torch.driver import run, run_distributed
from roms_tpu_torch.ops.weights import set_weights
from roms_tpu_torch.parallel import dist

torch.set_num_threads(1)

F64 = torch.float64
PHASES = ("roms.predictor", "roms.corrector_3d", "roms.fast_loop",
          "roms.uv2", "roms.tracer_corrector", "roms.finish")
# each span's parent, as the calls nest
PARENT = {**{p: "roms.step" for p in PHASES},
          "roms.fast.substep": "roms.fast_loop",
          "roms.fast.bc2d": "roms.fast.substep",
          "roms.fast.halo": "roms.fast.substep"}


def _bgc_real_setup(cfg, dtype, device):
    """The benchmark's bgc_real inputs (MARBL, rivers, tides, sponge) at
    the size of `cfg`."""
    cell = harness.load_cell("uswc-bgc_real")
    model = dataclasses.asdict(cfg)
    raw = cell.maker.raw_inputs(model, 7, device)
    return cell.maker.derive(inputs.side(inputs.PROGRAM), cfg, raw, dtype,
                             torch.device(device))


def _bgc_real_config():
    model = dict(harness.load_cell("uswc-bgc_real").config["model"],
                 nx=12, ny=10, nz=4)
    return inputs.model_config(inputs.side(inputs.PROGRAM), model)


CASES = {
    "filament": (tfilament,
                 tfilament.config().replace(nx=16, ny=12, nz=4, ndtfast=6)),
    "production": (tbp, tbp.config(nx=10, ny=8, nz=4, nt=3)),
    "bgc_real": (SimpleNamespace(setup=_bgc_real_setup), _bgc_real_config()),
}


def _setup(case):
    mod, cfg = CASES[case]
    grid, st, frc = mod.setup(cfg, dtype=F64, device="cpu")
    return cfg, grid, st, frc


class _Hook:
    """A step hook with a drain, as the async writers have."""

    def __call__(self, state, iic):
        pass

    def drain(self):
        pass


def _run(how, tmp_path, grid, st, frc, cfg, nsteps, **kw):
    """`driver.run`, or `run_distributed` on a 1x1 gloo mesh in this
    process."""
    if how == "run":
        run(grid, st, frc, cfg, nsteps, **kw)
        return
    store = tdist.FileStore(str(tmp_path / "store"), 1)
    mesh = dist.init_distributed("gloo", store, rank=0, world_size=1,
                                 device="cpu")
    try:
        run_distributed(grid, st, frc, cfg, mesh, nsteps, **kw)
    finally:
        tdist.destroy_process_group()


def test_span_off_records_nothing():
    assert monitor._sink is None
    a, b = monitor.span("roms.step"), monitor.span("roms.fast.halo")
    assert a is b
    with a, b:
        pass
    timers = monitor.Timers()
    with monitor.tracing(timers):
        assert monitor.span("roms.step") is not a
        with monitor.tracing(monitor.Timers()):
            pass
        with monitor.span("roms.step"):   # the outer sink is back
            pass
    assert monitor._sink is None and monitor.span("roms.step") is a
    assert timers.calls == {"roms.step": 1}
    cfg, grid, st, frc = _setup("filament")
    run(grid, st, frc, cfg, 1, collect_diag=False)
    assert timers.calls == {"roms.step": 1}


@pytest.mark.parametrize("how", ["run", "run_distributed"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_span_counts_per_step(case, how, tmp_path):
    cfg, grid, st, frc = _setup(case)
    nsteps = 2
    nfast = len(set_weights(cfg.ndtfast)[0])
    timers = monitor.Timers()
    with monitor.tracing(timers):
        _run(how, tmp_path, grid, st, frc, cfg, nsteps,
             forcing_fn=lambda t, base: base, step_hook=_Hook())
    want = {"roms.step": nsteps, "roms.fast_loop": nsteps,
            "roms.fast.substep": nfast * nsteps,
            "roms.fast.halo": nfast * nsteps,
            "roms.fast.bc2d": 2 * nfast * nsteps,
            # one forcing a step, a diagnostics row a step and the
            # initial one, one hook call a step and the drain
            "roms.forcing": nsteps, "roms.diag": nsteps + 1,
            "roms.output": nsteps + 1,
            **{p: nsteps for p in PHASES}}
    if cfg.bgc_model != "none":
        want["roms.bgc"] = nsteps     # inside roms.finish
    assert timers.calls == want
    assert set(timers.phases) == set(want)
    for child, parent in PARENT.items():
        assert timers.phases[child] <= timers.phases[parent]


@pytest.fixture(scope="module")
def profiled():
    """One production step with tracing on under torch.profiler: the
    Timers sink and the host ranges (name, start, end) of the roms.*
    spans."""
    cfg, grid, st, frc = _setup("production")
    timers = monitor.Timers()
    acts = [torch.profiler.ProfilerActivity.CPU]
    with monitor.tracing(timers), torch.profiler.profile(
            activities=acts) as prof:
        run(grid, st, frc, cfg, 1, collect_diag=False)
    ranges = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
              for e in prof.profiler.kineto_results.events()
              if e.name().startswith("roms.")]
    return timers, ranges


def test_profiler_ranges_match_the_sink(profiled):
    timers, ranges = profiled
    counts = {}
    for name, _, _ in ranges:
        counts[name] = counts.get(name, 0) + 1
    assert counts == timers.calls
    assert set(counts) == set(PARENT) | {"roms.step"}


def test_child_spans_lie_inside_their_parents(profiled):
    _, ranges = profiled
    by_name = {}
    for name, s, e in ranges:
        by_name.setdefault(name, []).append((s, e))
    for name, s, e in ranges:
        if name == "roms.step":
            continue
        assert any(ps <= s and e <= pe
                   for ps, pe in by_name[PARENT[name]]), name
    # the phases follow one another inside the step
    starts = [min(s for s, _ in by_name[p]) for p in PHASES]
    assert starts == sorted(starts)


def _tensors(state):
    return {k: v for k, v in vars(state).items()
            if isinstance(v, torch.Tensor)}


@pytest.mark.parametrize("case", sorted(CASES))
def test_tracing_on_is_bitwise_off(case):
    cfg, grid, st, frc = _setup(case)
    off, _ = run(grid, st, frc, cfg, 2, collect_diag=False)
    with monitor.tracing(monitor.Timers()):
        on, _ = run(grid, st, frc, cfg, 2, collect_diag=False)
    off, on = _tensors(off), _tensors(on)
    assert set(on) == set(off) and len(on) > 20
    for name, a in off.items():
        assert torch.equal(on[name], a), name


class _Event:
    """The part of a profiler event (`_KinetoEvent`) that
    `profile_step.reduce_spans` reads; times in ns.  `act`, the
    profiler's activity type, says whether it runs on the card."""

    def __init__(self, name, start, end, act, corr=0):
        self._v = (name, start, end - start, corr)
        self.act = act

    def name(self):
        return self._v[0]

    def start_ns(self):
        return self._v[1]

    def duration_ns(self):
        return self._v[2]

    def device_type(self):
        on_card = self.act.startswith("gpu") or self.act == "kernel"
        return "DeviceType.CUDA" if on_card else "DeviceType.CPU"

    def correlation_id(self):
        return self._v[3]


def _host(name, s, e):
    return _Event(name, s, e, "user_annotation")


def test_reduce_spans_on_a_synthetic_trace():
    """One step in a 100-ns window: 3 launch calls (2 inside the fast
    loop), a blocking copy that ends in a stream synchronize inside the
    fast loop's sub-step, a device synchronize outside every roms range
    but inside the window, and an asynchronous copy that waits for
    nothing; the kernels' device intervals leave idle gaps under the
    step, the sub-step and no range."""
    ev = [
        _host(profile_step.SPAN_WINDOW, 0, 100),
        _host("roms.step", 5, 90),
        _host("roms.predictor", 6, 20),
        _host("roms.fast_loop", 20, 80),
        _host("roms.fast.substep", 21, 70),
        _Event("aten::add", 29, 32, "cpu_op"),
        _Event("cudaLaunchKernel", 10, 11, "cuda_runtime", corr=1),
        _Event("cudaLaunchKernel", 30, 31, "cuda_runtime", corr=2),
        _Event("cuLaunchKernel", 72, 73, "cuda_driver", corr=3),
        _Event("cudaMemcpyAsync", 40, 41, "cuda_runtime", corr=4),
        _Event("cudaStreamSynchronize", 41, 50, "cuda_runtime", corr=5),
        _Event("cudaMemcpyAsync", 60, 61, "cuda_runtime", corr=6),
        _Event("cudaDeviceSynchronize", 95, 99, "cuda_runtime", corr=7),
        # the device: kernel 1 [12, 25], kernel 2 [32, 45], the copy
        # [45, 46], kernel 3 [74, 78]; its range's user annotation on
        # the card is not a device operation
        _Event("k1", 12, 25, "kernel", corr=1),
        _Event("k2", 32, 45, "kernel", corr=2),
        _Event("Memcpy HtoD", 45, 46, "gpu_memcpy", corr=4),
        _Event("k3", 74, 78, "kernel", corr=3),
        _Event("roms.fast_loop", 20, 80, "gpu_user_annotation"),
        # outside the window: left out
        _host("roms.step", 110, 120),
        _Event("cudaLaunchKernel", 111, 112, "cuda_runtime", corr=9),
    ]
    out = profile_step.reduce_spans(ev, steps=1)
    assert out["profiled_span_calls"] == {
        "roms.step": 1, "roms.predictor": 1, "roms.fast_loop": 1,
        "roms.fast.substep": 1}
    assert out["launch_calls_per_step"] == 3
    assert out["kernels_in_window"] == 3
    assert out["fast_loop_launches"] == 2
    assert out["launches_by_span"] == {"roms.predictor": 1,
                                       "roms.fast.substep": 1,
                                       "roms.fast_loop": 1}
    assert out["host_syncs_per_step"] == 2
    assert out["syncs_by_span"] == {"roms.fast.substep": 1,
                                    "other host": 1}
    assert out["host_sync_ms"] == pytest.approx(13e-6)
    # gaps: [0, 12] (mid 6: predictor), [25, 32] (substep), [46, 74]
    # (substep), [78, 100] (mid 89: step)
    idle = out["idle_ms_by_span"]
    assert idle == pytest.approx({"roms.predictor": 12e-6,
                                  "roms.fast.substep": 35e-6,
                                  "roms.step": 22e-6})
    assert (out["clock_matched"], out["clock_early"]) == (2, 0)
    assert out["clock_lead_us"] == pytest.approx(-12e-3)  # k2: 32, after 20
    assert out["window_ms"] == pytest.approx(100e-6)
    # a kernel that starts on the device before its launch's range opened
    # is counted as early
    early = ev[:14] + [_Event("k2", 15, 18, "kernel", corr=2)]
    assert profile_step.reduce_spans(early, steps=1)["clock_early"] == 1
    # no runtime calls (a CPU trace): the ranges only
    cpu = [e for e in ev if e.act in ("user_annotation", "cpu_op")]
    assert set(profile_step.reduce_spans(cpu, steps=1)) == {
        "profiled_span_calls"}
    with pytest.raises(RuntimeError):
        profile_step.reduce_spans(ev[1:], steps=1)
