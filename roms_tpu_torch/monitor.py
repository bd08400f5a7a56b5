"""Observability and robustness: timers, structured error log, blowup
detection (port of roms_tpu/monitor.py; reference: src/timers.F,
src/error_handling_mod.F90, src/diag.F:624-634).

* `Timers`: wall/CPU timing with a run banner and per-phase accumulators
  and call counts (reference: timers.F start/stop_timers; MPI_Wtime total
  printed as MPI_run_time, main.F:45-47).  `toc(sync=t)` waits for the
  device that holds `t` (`torch.cuda.synchronize`), so device work is
  counted; a CPU tensor needs no wait.
* `span(name)` / `tracing(timers)`: the program's own spans, named
  `roms.<phase>`, around the driver loop's parts, the step's phases and
  the fast loop's sub-steps.  Off (the default) a span is one shared
  no-op context: no clock read, no allocation.  Inside `tracing(timers)`
  each span enters `torch.profiler.record_function(name)`, so a profiler
  sees it on the clock of the device's kernels, and adds its host
  seconds and one call to `timers` (no synchronize: the host's time).
* `ErrorLog`: three-scope error accumulation (global / rank / gridpoint)
  with an `abort_check` that raises once any error is queued
  (reference: error_handling_mod.F90:23-58 raise_* + :326-374 abort_check).
* `check_blowup`: NaN/Inf test on the reduced diagnostics, the functional
  replacement of the reference's inspection of the printed KE line
  (reference: diag.F:624-634 "Abnormal termination: BLOWUP").
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch


class BlowupError(RuntimeError):
    pass


class RomsAbort(RuntimeError):
    pass


@dataclass
class ErrorEntry:
    scope: str              # "global" | "rank" | "point"
    context: str
    info: str
    location: Optional[tuple] = None


@dataclass
class ErrorLog:
    entries: List[ErrorEntry] = field(default_factory=list)

    def raise_global(self, context: str, info: str):
        self.entries.append(ErrorEntry("global", context, info))

    def raise_from_rank(self, context: str, info: str, rank: int = 0):
        self.entries.append(ErrorEntry("rank", context, info, (rank,)))

    def raise_from_point(self, context: str, info: str, i: int, j: int,
                         k: int = 0):
        self.entries.append(ErrorEntry("point", context, info, (i, j, k)))

    @property
    def abort_requested(self) -> bool:
        return bool(self.entries)

    def abort_check(self):
        """Raise if any error has been queued
        (reference: error_handling_mod.F90:326-374 -> MPI_Abort)."""
        if self.entries:
            msgs = "\n".join(f"  [{e.scope}] {e.context}: {e.info}"
                             + (f" at {e.location}" if e.location else "")
                             for e in self.entries)
            raise RomsAbort(f"error log not empty:\n{msgs}")


class Timers:
    """Run timers (reference: src/timers.F)."""

    def __init__(self):
        self._t0 = time.perf_counter()
        self._c0 = time.process_time()
        self._phase_start: Dict[str, float] = {}
        self.phases: Dict[str, float] = {}
        self.calls: Dict[str, int] = {}
        self.nsteps = 0

    def tic(self, phase: str):
        self._phase_start[phase] = time.perf_counter()

    def toc(self, phase: str, sync: Optional[torch.Tensor] = None):
        """Close `phase`; with `sync`, first wait for the device that holds
        that tensor to finish its queued work."""
        if sync is not None and sync.is_cuda:
            torch.cuda.synchronize(sync.device)
        dt = time.perf_counter() - self._phase_start[phase]
        self.phases[phase] = self.phases.get(phase, 0.0) + dt
        self.calls[phase] = self.calls.get(phase, 0) + 1
        return dt

    def banner(self) -> str:
        """Run summary (reference: timers.F run banner + main.F:45-47)."""
        wall = time.perf_counter() - self._t0
        cpu = time.process_time() - self._c0
        lines = [f"run_time = {wall:.3f} s   cpu_time = {cpu:.3f} s"]
        for k, v in sorted(self.phases.items()):
            lines.append(f"  {k:<24s} {v:10.3f} s {self.calls[k]:9d} calls")
        return "\n".join(lines)


_OFF = contextlib.nullcontext()   # every span while tracing is off
_sink: Optional[Timers] = None    # the Timers spans add to, while tracing


class _Span:
    """One span while tracing is on: a record_function range and a
    tic/toc of its name on the sink it was opened with."""

    __slots__ = ("name", "timers", "rf")

    def __init__(self, name: str, timers: Timers):
        self.name, self.timers = name, timers
        self.rf = torch.profiler.record_function(name)

    def __enter__(self):
        self.rf.__enter__()
        self.timers.tic(self.name)
        return self

    def __exit__(self, *exc):
        self.timers.toc(self.name)
        return self.rf.__exit__(*exc)


def span(name: str):
    """Context manager around one phase of the program; see the module
    docstring.  Spans of one name must not nest."""
    if _sink is None:
        return _OFF
    return _Span(name, _sink)


@contextlib.contextmanager
def tracing(timers: Timers):
    """Turn the program's spans on, adding to `timers`, for the body."""
    global _sink
    prev, _sink = _sink, timers
    try:
        yield timers
    finally:
        _sink = prev


def check_blowup(diag_row, step: int, error_log: Optional[ErrorLog] = None):
    """NaN/Inf watchdog on the reduced diagnostics (reference:
    diag.F:624-634); the blowup is queued on `error_log` where one is
    given, and raised either way."""
    vals = np.asarray(diag_row, np.float64)
    if not np.isfinite(vals).all():
        msg = f"BLOWUP at step {step}: diagnostics {vals}"
        if error_log is not None:
            error_log.raise_global("diag/check_blowup", msg)
        raise BlowupError(f"Abnormal termination: {msg}")
