"""The traced run: host spans around the port's layers, one profiled
window, and its reduction to intervals, counts and the breakdown.

The spans are `torch.profiler.record_function` ranges put around module
attributes of roms_tpu_torch from this file (`Spans`), with no
synchronize, so host and device overlap as in an untraced run.  `profile`
runs a window under `torch.profiler` (CPU and CUDA activities) and
returns a `Trace`: the window's host interval, every device operation
(kernels, copies, fills) in it, and the spans.  No chrome trace is
written.
"""

from __future__ import annotations

import functools
import importlib
import time
from collections import defaultdict
from dataclasses import dataclass, field

import torch

WINDOW = "bench.window"
OTHER_HOST = "other host"
DEVICE_ACTIVITIES = ("kernel", "gpu_memcpy", "gpu_memset")
TOP = 10             # entries of each breakdown list
NAME_CHARS = 160     # a kernel's name is cut to this many characters

# (module, attribute) of each layer the step calls through a module
# name (roms_tpu_torch/profile_step.py's LAYERS, with set_depth); none of
# them calls another, so the spans do not nest
LAYERS = (
    ("roms_tpu_torch.ops.barotropic", "fast_loop"),
    ("roms_tpu_torch.stepper", "_uv_rhs"),
    ("roms_tpu_torch.ops.prsgrd", "prsgrd"),
    ("roms_tpu_torch.ops.eos", "rho_eos"),
    ("roms_tpu_torch.ops.kinematics", "omega"),
    ("roms_tpu_torch.ops.kinematics", "set_huv"),
    ("roms_tpu_torch.ops.kinematics", "set_huv1"),
    ("roms_tpu_torch.vcoord", "set_depth"),
    ("roms_tpu_torch.ops.hmix", "visc3d"),
    ("roms_tpu_torch.ops.bc", "u3dbc"),
    ("roms_tpu_torch.ops.bc", "v3dbc"),
    ("roms_tpu_torch.ops.bc", "t3dbc"),
    ("roms_tpu_torch.ops.cuda_tracer", "tracer_stage"),
    ("roms_tpu_torch.ops.cuda_solve", "momentum_implicit"),
    ("roms_tpu_torch.ops.cuda_kpp", "vmix_update"),
)


def span_name(module: str, attr: str) -> str:
    return f"{module.rsplit('.', 1)[-1]}.{attr}"


class Spans:
    """Context manager that wraps each of `layers` in a span named
    `span_name(module, attr)` and puts the originals back on exit.  A
    layer that is no longer there raises AttributeError: a renamed
    function fails the traced run loudly.  The kernel wrappers' counters
    (`launches`, `last_bytes`) move to the wrapper while it is installed,
    since the wrapped function counts on its module-level name, and back
    on exit."""

    def __init__(self, layers=LAYERS):
        self.layers = layers
        self.saved = []

    def __enter__(self):
        from torch.profiler import record_function
        for mod_name, attr in self.layers:
            mod = importlib.import_module(mod_name)
            fn = getattr(mod, attr)
            name = span_name(mod_name, attr)

            @functools.wraps(fn)
            def wrapped(*a, _fn=fn, _name=name, **k):
                with record_function(_name):
                    return _fn(*a, **k)
            self.saved.append((mod, attr, fn, wrapped))
            setattr(mod, attr, wrapped)
        return self

    def __exit__(self, *exc):
        for mod, attr, fn, wrapped in reversed(self.saved):
            setattr(mod, attr, fn)
            for counter in ("launches", "last_bytes"):
                if hasattr(wrapped, counter):
                    setattr(fn, counter, getattr(wrapped, counter))
        self.saved.clear()
        return False


@dataclass
class Trace:
    """One traced window, times in seconds from the window's start.
    device: (name, start, end, activity) of each device operation that
    starts in the window; spans: (name, start, end) of each layer span."""
    window_s: float
    steps: int
    device: list = field(default_factory=list)
    spans: list = field(default_factory=list)
    reduce_s: float = 0.0        # host seconds the reduction took

    def kernels(self):
        return [d for d in self.device if d[3] == "kernel"]

    def busy_intervals(self):
        """The union of the device operations' intervals, clipped to the
        window, as sorted disjoint (start, end) pairs."""
        out = []
        for _, s, e, _ in sorted(self.device, key=lambda d: d[1]):
            s, e = max(s, 0.0), min(e, self.window_s)
            if e <= s:
                continue
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return [tuple(iv) for iv in out]

    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals())

    def idle_gaps(self):
        """(start, end) of each stretch of the window with no device
        operation running."""
        gaps, t = [], 0.0
        for s, e in self.busy_intervals():
            if s > t:
                gaps.append((t, s))
            t = max(t, e)
        if t < self.window_s:
            gaps.append((t, self.window_s))
        return gaps

    def idle_by_span(self) -> dict:
        """Idle seconds by the innermost span open on the host at each
        gap's middle; OTHER_HOST where none is."""
        marks = []
        for name, s, e in self.spans:
            marks.append((s, 0, name))
            marks.append((e, 1, name))
        for g0, g1 in self.idle_gaps():
            marks.append((0.5 * (g0 + g1), 2, g1 - g0))
        # at one instant: opens first, then gaps, then closes
        marks.sort(key=lambda m: (m[0], (0, 2, 1)[m[1]]))
        stack, out = [], defaultdict(float)
        for _, kind, val in marks:
            if kind == 0:
                stack.append(val)
            elif kind == 1:
                if val in stack:
                    del stack[len(stack) - 1 - stack[::-1].index(val)]
            else:
                out[stack[-1] if stack else OTHER_HOST] += val
        return dict(out)

    def span_seconds(self, name: str) -> float:
        return sum(e - s for n, s, e in self.spans if n == name)

    def device_seconds(self, patterns) -> tuple[int, float]:
        """(launches, device seconds) of the kernels whose name holds one
        of `patterns`."""
        hits = [d for d in self.kernels()
                if any(p in d[0] for p in patterns)]
        return len(hits), sum(e - s for _, s, e, _ in hits)

    def breakdown(self) -> dict:
        ops = defaultdict(float)
        for name, s, e, _ in self.device:
            ops[name[:NAME_CHARS]] += e - s
        idle = self.idle_by_span()
        return {"device_ops": _top(ops), "idle_gaps": _top(idle)}


def _top(d: dict):
    return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:TOP]]


def _activity(e) -> str:
    """The event's activity type where the profiler reports one
    ("kernel", "gpu_memcpy", "user_annotation", ...), else ""."""
    a = getattr(e, "activity_type", None)
    return a() if callable(a) else ""


def _kind(e, names) -> str | None:
    """"host" for one of our annotations on the host, the device
    activity ("kernel", "gpu_memcpy", "gpu_memset") for an operation on
    the card, None for anything else."""
    on_card = str(e.device_type()).endswith("CUDA")
    name = e.name()
    if name in names:
        return None if on_card else "host"
    act = _activity(e)
    if act:
        return act if act in DEVICE_ACTIVITIES else None
    if not on_card:
        return None
    if name.startswith("Memcpy"):
        return "gpu_memcpy"
    return "gpu_memset" if name.startswith("Memset") else "kernel"


def reduce_events(events, steps: int, span_names) -> Trace:
    """A Trace from the profiler's raw events (`_KinetoEvent`s): the
    window is the host interval of the WINDOW annotation."""
    names = set(span_names) | {WINDOW}
    host, device = [], []
    for e in events:
        kind = _kind(e, names)
        if kind == "host":
            host.append((e.name(), e.start_ns(), e.duration_ns()))
        elif kind is not None:
            device.append((e.name(), e.start_ns(), e.duration_ns(), kind))
    win = [h for h in host if h[0] == WINDOW]
    if len(win) != 1:
        raise RuntimeError(f"the trace holds {len(win)} windows, not 1")
    _, w0, wd = win[0]
    tr = Trace(window_s=wd * 1e-9, steps=steps)
    tr.device = [(n, (s - w0) * 1e-9, (s + d - w0) * 1e-9, k)
                 for n, s, d, k in device if w0 <= s <= w0 + wd]
    tr.spans = [(n, (s - w0) * 1e-9, (s + d - w0) * 1e-9)
                for n, s, d in host if n != WINDOW]
    return tr


def profile(fn, steps: int, layers=LAYERS):
    """Run fn() once with the layer spans installed, under the profiler
    and inside the WINDOW annotation, which closes after a synchronize;
    return (its Trace, what fn returned)."""
    from torch.profiler import ProfilerActivity, record_function
    from torch.profiler import profile as torch_profile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with Spans(layers), torch_profile(activities=acts) as prof:
        with record_function(WINDOW):
            value = fn()
            if torch.cuda.is_available():
                torch.cuda.synchronize()
    t0 = time.perf_counter()
    tr = reduce_events(prof.profiler.kineto_results.events(), steps,
                       [span_name(m, a) for m, a in layers])
    tr.reduce_s = time.perf_counter() - t0
    return tr, value
