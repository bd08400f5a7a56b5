"""Observability and robustness: timers, structured error log, blowup
detection (port of roms_tpu/monitor.py; reference: src/timers.F,
src/error_handling_mod.F90, src/diag.F:624-634).

* `Timers`: wall/CPU timing with a run banner and per-phase accumulators
  (reference: timers.F start/stop_timers; MPI_Wtime total printed as
  MPI_run_time, main.F:45-47).  `toc(sync=t)` waits for the device that
  holds `t` (`torch.cuda.synchronize`), so device work is counted; a CPU
  tensor needs no wait.
* `ErrorLog`: three-scope error accumulation (global / rank / gridpoint)
  with an `abort_check` that raises once any error is queued
  (reference: error_handling_mod.F90:23-58 raise_* + :326-374 abort_check).
* `check_blowup`: NaN/Inf test on the reduced diagnostics, the functional
  replacement of the reference's inspection of the printed KE line
  (reference: diag.F:624-634 "Abnormal termination: BLOWUP").
"""

from __future__ import annotations

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
        return dt

    def banner(self) -> str:
        """Run summary (reference: timers.F run banner + main.F:45-47)."""
        wall = time.perf_counter() - self._t0
        cpu = time.process_time() - self._c0
        lines = [f"run_time = {wall:.3f} s   cpu_time = {cpu:.3f} s"]
        for k, v in sorted(self.phases.items()):
            lines.append(f"  {k:<24s} {v:10.3f} s")
        return "\n".join(lines)


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
