"""Arithmetic that several metric readers share."""

from __future__ import annotations

from bench_h100.harness import BENCH, load_module


def roofline(run, kernel: str):
    """A kernel's share of its roofline over the traced window, in %:
    the least time of its calls (`counts/<kernel>.py`) over the device
    time of its launches, found by name in the trace.  None where the
    run has no trace or the trace holds no launch of the kernel."""
    if run.trace is None:
        return None
    counts = load_module(BENCH / "counts" / f"{kernel}.py")
    launches, seconds = run.trace.device_seconds(counts.KERNELS)
    if launches == 0:
        return None
    calls = launches / len(counts.KERNELS)
    return 100.0 * calls * counts.bound_s(run.cfg, run.elem) / seconds
