"""Where the time of one baroclinic step goes, on one CUDA device.

    python3 -m roms_tpu_torch.profile_step [--case CASE]

Runs Filament at 512x256x60 (the shape of bench.py:71-74 and
chip_smoke.py's phase 5), the production-physics case at 384x192x60
with nt=34 (bench.py:66, chip_smoke.py's phase 6), or one of the
real-data cases at 199x99x50 — flux_frc, rivers_real and pipes_real
with nt=2 (chip_smoke.py's phase 10), bgc_real (MARBL, nt=34) and
cdr_3d (nt=34) (chip_smoke.py's phase 12); assembled from the inputs
`cases/uswc.py` writes into a temporary directory under the checkout's
build/ — in float32 through `driver.run`, without diagnostics, and reads
the step in three windows of one run, after 2 warm-up steps:

  wall    three windows of 5 steps, host clock between two
          synchronizes: ms/step as chip_smoke.py reads it;
  device  2 steps under torch.profiler: the summed time of the kernels
          on the device, their count, the busy share (kernel time over
          the wall of the unprofiled windows) and the kernels that took
          most of it, by name;
  layers  2 steps with each layer of the step (fast loop, momentum
          r.h.s., prsgrd, rho_eos, omega, set_huv/set_huv1, visc3d, the
          3D boundary conditions, the three hand kernels) bracketed by
          synchronizes; where the tracer kernel does not cover the
          configuration (river sources), the batched tracer branch's
          functions (horizontal and vertical fluxes, the river flux fix,
          the implicit solve, t3dmix) too, a real-data case's
          `forcing_fn`, a BGC case's column physics
          (`stepper.bgc_update`), and where the configuration turns them
          on, the non-hydrostatic projection (`nhmg.nh_solve`) and the
          isoneutral slope fields and increment.  The brackets take away the
          overlap of host and device, so these steps are slower than the
          wall windows; the shares are what the layers weigh;
  bgc     in a BGC case, one call of `stepper.bgc_update` on the last
          step's inputs under torch.profiler: the kernels it launches and
          their time, beside the step's;
  spans   two more `driver.run` calls with the program's own spans on
          (`monitor.tracing`, the roms.* names of driver.py, stepper.py
          and ops/barotropic.py): 5 steps without the profiler, each
          span's host ms and calls a step from the Timers sink and the
          ms/step beside the wall windows' (tracing's cost); then 2 steps
          under torch.profiler, whose CUDA runtime calls are put in the
          innermost roms.* range open on the host when they start: kernel
          launch calls a step in all and inside roms.fast_loop, the calls
          that wait on the device (synchronizes, and blocking copies) and
          where they are, and the device's idle seconds by the innermost
          range open at each gap's middle ("other host" outside every
          range); and two checks of the shared clock, that the launch
          calls number the kernels and that no kernel launched inside
          roms.fast_loop starts on the device before that range opened.

Each reading is a line of its own on stdout.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import tempfile
import time
from collections import defaultdict

import torch

from roms_tpu_torch import monitor, nhmg, stepper
from roms_tpu_torch.cases import (bench_production, bgc_real, cdr_3d,
                                  filament, flux_frc, pipes_real,
                                  rivers_real)
from roms_tpu_torch.driver import _call_forcing_fn, run
from roms_tpu_torch.ops import advection as adv
from roms_tpu_torch.ops import (barotropic, bc, cuda_kpp, cuda_solve,
                                cuda_tracer, eos, hmix, isoneutral,
                                kinematics, prsgrd, rivers, vmix)

WARM, WALL_WINDOWS, WALL_STEPS, PROF_STEPS, LAYER_STEPS = 2, 3, 5, 2, 2
TOP = 12    # kernels listed by name
SPAN_WINDOW = "profile_step.spans"
OTHER_HOST = "other host"

# (module, attribute) of each layer the step calls through a module name;
# none is called from inside another (the 2D BCs run inside the fast loop
# and are part of it)
LAYERS = (
    (barotropic, "fast_loop"), (stepper, "_uv_rhs"), (prsgrd, "prsgrd"),
    (eos, "rho_eos"), (kinematics, "omega"), (kinematics, "set_huv"),
    (kinematics, "set_huv1"), (hmix, "visc3d"), (bc, "u3dbc"),
    (bc, "v3dbc"), (bc, "t3dbc"), (cuda_tracer, "tracer_stage"),
    (cuda_solve, "momentum_implicit"), (cuda_kpp, "vmix_update"),
)
# the batched tracer branch, bracketed only where the tracer kernel does
# not cover the configuration: its plain version calls the first three
BATCHED = ((adv, "horiz_tracer_flux"), (adv, "vert_tracer_flux_spline"),
           (vmix, "tracer_implicit_all"), (rivers, "tracer_flux_fix_all"),
           (hmix, "t3dmix"))
# the layers of an option, bracketed where the configuration turns it on
OPTIONS = (("non_hydrostatic", ((nhmg, "nh_solve"),)),
           ("adv_isoneutral", ((isoneutral, "slope_fields"),
                               (isoneutral, "isoneutral_increment"))))
# the real-data cases take their configuration from their input files
CASES = {
    "filament": (filament, filament.config().replace(nx=512, ny=256, nz=60)),
    "production": (bench_production,
                   bench_production.config(nx=384, ny=192, nz=60, nt=34)),
    "flux_frc": (flux_frc, None),
    "rivers_real": (rivers_real, None),
    "pipes_real": (pipes_real, None),
    "bgc_real": (bgc_real, None),
    "cdr_3d": (cdr_3d, None),
}


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _bracket(device, spent, layers):
    """Wrap each of `layers` so that its calls are timed between
    synchronizes; returns the function that puts the originals back."""
    originals = [(mod, name, getattr(mod, name)) for mod, name in layers]
    for mod, name, fn in originals:
        def timed(*a, _fn=fn, _name=name, **k):
            _sync(device)
            t0 = time.perf_counter()
            out = _fn(*a, **k)
            _sync(device)
            spent[_name] += time.perf_counter() - t0
            return out
        if hasattr(fn, "launches"):
            # the kernel wrappers count on their module-level name
            timed.launches = fn.launches
        setattr(mod, name, timed)

    def restore():
        for mod, name, fn in originals:
            if hasattr(fn, "launches"):
                fn.launches = getattr(mod, name).launches
            setattr(mod, name, fn)
    return restore


def _device_kernels(prof):
    """{kernel name: [count, microseconds]} of the device's kernels."""
    kernels = defaultdict(lambda: [0, 0.0])
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            kernels[e.name][0] += 1
            kernels[e.name][1] += e.time_range.elapsed_us()
    return kernels


def profile(cfg, device, dtype=torch.float32, say=print, case=filament,
            workdir=None):
    """Run the three windows on `case` (a module of roms_tpu_torch.cases)
    at `cfg`; a real-data case (one with `build`) is assembled from the
    inputs it writes under `workdir`, at its own configuration, and runs
    with its `forcing_fn`; returns the readings."""
    w_end = WARM + WALL_WINDOWS * WALL_STEPS
    p_end = w_end + PROF_STEPS
    l_end = p_end + LAYER_STEPS
    frc_fn = fileset = None
    if hasattr(case, "build"):
        exp = case.build(workdir, ntimes=l_end, dtype=dtype, device=device)
        grid, st, frc, cfg = exp.grid, exp.state, exp.forcing0, exp.cfg
        frc_fn, fileset = exp.forcing_fn, exp.fileset
    else:
        grid, st, frc = case.setup(cfg, dtype=dtype, device=device)
    layers = LAYERS if cuda_tracer.usable(cfg) else LAYERS + BATCHED
    if cfg.bgc_model != "none":
        layers = layers + ((stepper, "bgc_update"),)
    for flag, extra in OPTIONS:
        if getattr(cfg, flag):
            layers = layers + extra
    marks, spent, out = {}, defaultdict(float), {}
    acts = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=acts)
    restore = None

    def hook(_, iic):
        # the profiler's start and stop stay outside every timed window
        nonlocal restore
        _sync(device)
        if iic == p_end:
            prof.stop()
            restore = _bracket(device, spent, layers)
        marks[iic] = time.perf_counter()
        if iic == w_end:
            prof.start()

    def forcing_fn(t, base, state):
        # a layer of its own in the bracketed steps
        if restore is None:
            return _call_forcing_fn(frc_fn, t, base, state)
        _sync(device)
        t0 = time.perf_counter()
        out = _call_forcing_fn(frc_fn, t, base, state)
        _sync(device)
        spent["forcing_fn"] += time.perf_counter() - t0
        return out

    bgc_args, bgc_fn = [], None
    if cfg.bgc_model != "none":
        # the inputs of the last step's BGC block, for the bgc reading
        bgc_fn = stepper.bgc_update

        def keep_args(*a, **k):
            bgc_args[:] = [a, k]
            return bgc_fn(*a, **k)
        stepper.bgc_update = keep_args

    _sync(device)
    try:
        st, _ = run(grid, st, frc, cfg, nsteps=l_end, collect_diag=False,
                    step_hook=hook,
                    forcing_fn=None if frc_fn is None else forcing_fn)
        restore()
        restore = None
        out.update(spans(grid, st, frc, cfg, device, frc_fn))
    finally:
        if restore is not None:
            restore()
        if bgc_fn is not None:
            stepper.bgc_update = bgc_fn
        if fileset is not None:
            fileset.close()

    shape = (f"{case.__name__.rsplit('.', 1)[-1]} {cfg.nx}x{cfg.ny}x{cfg.nz} "
             f"nt={cfg.nt} {str(dtype)[6:]}")
    wall = []
    for w in range(WALL_WINDOWS):
        a = WARM + w * WALL_STEPS
        wall.append(1e3 * (marks[a + WALL_STEPS] - marks[a]) / WALL_STEPS)
    out["wall_ms"] = wall
    say(f"[wall] {shape}: ms/step over {WALL_WINDOWS} windows of "
        f"{WALL_STEPS} steps: " + ", ".join(f"{x:.3f}" for x in wall))

    kernels = _device_kernels(prof)
    n = sum(c for c, _ in kernels.values())
    busy = 1e-3 * sum(us for _, us in kernels.values()) / PROF_STEPS
    out.update(kernels_per_step=n / PROF_STEPS, device_ms=busy)
    if n == 0:
        say("[device] not measured: the profiler saw no device kernels")
    else:
        share = busy / (sum(wall) / len(wall))
        out["busy_share"] = share
        say(f"[device] {PROF_STEPS} profiled steps: kernel time "
            f"{busy:.3f} ms/step, {n / PROF_STEPS:.0f} kernels/step, busy "
            f"share {share:.4f} of the mean wall step")
        ranked = sorted(kernels.items(), key=lambda kv: -kv[1][1])
        for name, (count, us) in ranked[:TOP]:
            say(f"[device]   {1e-3 * us / PROF_STEPS:9.3f} ms/step "
                f"{100 * 1e-3 * us / PROF_STEPS / busy:6.2f} % "
                f"{count // PROF_STEPS:6d}/step  {name[:90]}")

    step_ms = 1e3 * (marks[l_end] - marks[p_end]) / LAYER_STEPS
    out["layers_ms"] = {k: 1e3 * v / LAYER_STEPS for k, v in spent.items()}
    out["layer_step_ms"] = step_ms
    say(f"[layers] {LAYER_STEPS} steps, each layer between synchronizes: "
        f"{step_ms:.3f} ms/step")
    rest = step_ms
    for name, ms in sorted(out["layers_ms"].items(), key=lambda kv: -kv[1]):
        rest -= ms
        say(f"[layers]   {name:24s} {ms:9.3f} ms/step "
            f"{100 * ms / step_ms:6.2f} %")
    say(f"[layers]   {'rest':24s} {rest:9.3f} ms/step "
        f"{100 * rest / step_ms:6.2f} %")
    if bgc_args:
        out.update(bgc_block(*bgc_args, acts, device, out, say))
    say_spans(out, say)
    return out


def bgc_block(args, kw, acts, device, out, say):
    """One call of the BGC block under torch.profiler: its kernels and
    their device time, beside the profiled step's."""
    stepper.bgc_update(*args, **kw)          # warm, outside the window
    _sync(device)
    with torch.profiler.profile(activities=acts) as prof:
        stepper.bgc_update(*args, **kw)
        _sync(device)
    kernels = _device_kernels(prof)
    n = sum(c for c, _ in kernels.values())
    ms = 1e-3 * sum(us for _, us in kernels.values())
    if n == 0:
        say("[bgc] not measured: the profiler saw no device kernels")
        return {}
    step_n = out.get("kernels_per_step", 0.0)
    share = n / step_n if step_n else float("nan")
    say(f"[bgc] one call of stepper.bgc_update: {n} kernels "
        f"({share:.4f} of the step's {step_n:.0f}), kernel time "
        f"{ms:.3f} ms ({ms / out.get('device_ms', float('nan')):.4f} of "
        f"the step's)")
    return {"bgc_kernels": n, "bgc_device_ms": ms, "bgc_share": share}


def spans(grid, st, frc, cfg, device, frc_fn=None) -> dict:
    """The spans reading (module docstring): WALL_STEPS steps with the
    program's spans on, then PROF_STEPS more under torch.profiler."""
    timers = monitor.Timers()
    _sync(device)
    t0 = time.perf_counter()
    with monitor.tracing(timers):
        st, _ = run(grid, st, frc, cfg, nsteps=WALL_STEPS,
                    collect_diag=False, forcing_fn=frc_fn)
        _sync(device)
        wall = time.perf_counter() - t0
        out = {"spans_step_ms": 1e3 * wall / WALL_STEPS,
               "span_ms": {k: 1e3 * v / WALL_STEPS
                           for k, v in timers.phases.items()},
               "span_calls": {k: n / WALL_STEPS
                              for k, n in timers.calls.items()}}
        acts = [torch.profiler.ProfilerActivity.CPU]
        if device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        with torch.profiler.profile(activities=acts) as prof:
            with torch.profiler.record_function(SPAN_WINDOW):
                run(grid, st, frc, cfg, nsteps=PROF_STEPS,
                    collect_diag=False, forcing_fn=frc_fn)
                _sync(device)
    out.update(reduce_spans(prof.profiler.kineto_results.events(),
                            PROF_STEPS))
    return out


def _innermost(ranges, points):
    """The innermost of `ranges` ((name, start, end), properly nested)
    open at each of `points`, in order; OTHER_HOST where none is."""
    marks = [(s, 0, i) for i, (_, s, _) in enumerate(ranges)]
    marks += [(e, 2, i) for i, (_, _, e) in enumerate(ranges)]
    marks += [(t, 1, i) for i, t in enumerate(points)]
    marks.sort()        # at one instant: opens, then points, then closes
    stack, out = [], [OTHER_HOST] * len(points)
    for _, kind, i in marks:
        if kind == 0:
            stack.append(i)
        elif kind == 2:
            stack.remove(i)
        elif stack:
            out[i] = ranges[stack[-1]][0]
    return out


def _count(names, steps):
    out = defaultdict(float)
    for n in names:
        out[n] += 1.0 / steps
    return dict(out)


def reduce_spans(events, steps: int) -> dict:
    """The profiled part of the spans reading from the profiler's raw
    events (`_KinetoEvent`s): the roms.* ranges on the host, the CUDA
    runtime and driver calls and the device operations, all inside the
    SPAN_WINDOW range.  Only the ranges' reading where the trace holds no
    runtime call (a CPU run)."""
    ranges, calls, device, window = [], [], [], None
    for e in events:
        # by device and name: not every torch has `activity_type`
        name, s, d = e.name(), e.start_ns(), e.duration_ns()
        if str(e.device_type()).endswith("CUDA"):
            if name.startswith(("roms.", SPAN_WINDOW)):
                continue            # the ranges' shadows on the card
            kind = ("gpu_memcpy" if name.startswith("Memcpy") else
                    "gpu_memset" if name.startswith("Memset") else "kernel")
            device.append((kind, s, s + d, e.correlation_id()))
        elif name == SPAN_WINDOW:
            window = (s, s + d)
        elif name.startswith("roms."):
            ranges.append((name, s, s + d))
        elif name.startswith("cu"):     # CUDA runtime and driver calls
            calls.append((name, s, s + d, e.correlation_id()))
    if window is None:
        raise RuntimeError(f"the trace holds no {SPAN_WINDOW} range")
    w0, w1 = window
    ranges = sorted((r for r in ranges if w0 <= r[1] and r[2] <= w1),
                    key=lambda r: (r[1], -r[2]))
    out = {"profiled_span_calls": _count([r[0] for r in ranges], steps)}
    calls = [c for c in calls if w0 <= c[1] <= w1]
    if not calls:
        return out
    device = [d for d in device if w0 <= d[1] <= w1]
    launches = [c for c in calls if "LaunchKernel" in c[0]
                or c[0].startswith("cuLaunch")]
    waits = [c for c in calls if "Synchronize" in c[0]
             or (c[0].startswith(("cudaMemcpy", "cuMemcpy"))
                 and "Async" not in c[0])]
    fast = [r for r in ranges if r[0] == "roms.fast_loop"]
    in_fast = [c for c in launches
               if any(s <= c[1] <= e for _, s, e in fast)]
    kernels = [d for d in device if d[0] == "kernel"]
    # the shared clock: each kernel of a launch call inside the fast loop
    # starts on the device after the fast loop's range opened
    opened = {c[3]: max(s for _, s, e in fast if s <= c[1] <= e)
              for c in in_fast}
    lead = [opened[d[3]] - d[1] for d in kernels if d[3] in opened]
    # the stretches of the window with no device operation running
    gaps, t = [], w0
    for _, s, e, _ in sorted(device, key=lambda d: d[1]):
        if s > t:
            gaps.append((t, s))
        t = max(t, min(e, w1))
    if t < w1:
        gaps.append((t, w1))
    idle = defaultdict(float)
    for n, (g0, g1) in zip(_innermost(ranges, [0.5 * (a + b)
                                               for a, b in gaps]), gaps):
        idle[n] += 1e-9 * (g1 - g0) / steps
    out.update(
        window_ms=1e-6 * (w1 - w0) / steps,
        launch_calls_per_step=len(launches) / steps,
        kernels_in_window=len(kernels) / steps,
        fast_loop_launches=len(in_fast) / steps,
        launches_by_span=_count(_innermost(ranges, [c[1] for c in launches]),
                                steps),
        host_syncs_per_step=len(waits) / steps,
        host_sync_ms=1e-6 * sum(c[2] - c[1] for c in waits) / steps,
        syncs_by_span=_count(_innermost(ranges, [c[1] for c in waits]),
                             steps),
        sync_names=_count([c[0] for c in waits], steps),
        idle_ms_by_span={k: 1e3 * v for k, v in idle.items()},
        clock_matched=len(lead), clock_early=sum(x > 0 for x in lead),
        clock_lead_us=1e-3 * max(lead, default=0))
    return out


def say_spans(out, say):
    """Print the spans reading."""
    step = out["spans_step_ms"]
    wall = out.get("wall_ms")
    cost = (f", {step / (sum(wall) / len(wall)):.4f} of the wall windows'"
            if wall else "")
    say(f"[spans] {WALL_STEPS} steps with the program's spans on: "
        f"{step:.3f} ms/step{cost}")
    for name, ms in sorted(out["span_ms"].items(), key=lambda kv: -kv[1]):
        say(f"[spans]   {name:24s} {ms:9.3f} host ms/step "
            f"{out['span_calls'][name]:7.1f} calls/step")
    if "launch_calls_per_step" not in out:
        say("[spans] launches, syncs, idle: not measured (no CUDA runtime "
            "calls in the trace)")
        return
    say(f"[spans] {PROF_STEPS} profiled steps, {out['window_ms']:.3f} "
        f"ms/step: {out['launch_calls_per_step']:.1f} launch calls/step "
        f"({out['kernels_in_window']:.1f} kernels), "
        f"{out['fast_loop_launches']:.1f} inside roms.fast_loop; "
        f"{out['host_syncs_per_step']:.1f} host syncs/step "
        f"({out['host_sync_ms']:.3f} ms/step); clock: "
        f"{out['clock_early']} of {out['clock_matched']} fast-loop kernels "
        f"start before their range (by at most "
        f"{out['clock_lead_us']:.3f} us)")
    for key, label, unit in (
            ("launches_by_span", "launches", "launches/step"),
            ("syncs_by_span", "syncs", "syncs/step"),
            ("sync_names", "sync", "calls/step"),
            ("idle_ms_by_span", "idle", "idle ms/step")):
        for name, v in sorted(out[key].items(), key=lambda kv: -kv[1]):
            say(f"[spans]   {label:8s} {name:28s} {v:10.3f} {unit}")


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--case", choices=sorted(CASES), default="filament")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_step: no CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    case, cfg = CASES[args.case]
    # the real-data inputs (106 MB) go to the ignored build/ of the checkout
    build = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "build")
    os.makedirs(build, exist_ok=True)
    with tempfile.TemporaryDirectory(prefix="uswc_", dir=build) as workdir:
        profile(cfg, torch.device("cuda", 0), case=case, workdir=workdir)


if __name__ == "__main__":
    main()
