"""Asynchronous host I/O: background forcing reads and non-blocking output
writers (port of roms_tpu/io/async_io.py).

The reference overlaps nothing: every rank blocks on NetCDF reads in
set_forces and on writes in wrt_his (reference: roms_read_write.F:303-652,
basic_output.F).  Here one host feeds one card, so host I/O must hide
behind device work:

  * `forcing.Series` schedules the next record onto the shared reader
    pool as soon as the current bracket is known, so crossing a record
    boundary finds the data already on the host.  All background NetCDF
    reads serialize on `IO_LOCK`: the readers hand out lazy variables over
    shared seekable file objects, so two concurrent reads of one dataset
    would race on the file position;
  * `make_async_hook` runs output hooks (device-to-host pulls and NetCDF
    writes) on one ordered worker with bounded in-flight jobs, so the
    step loop only enqueues.  Writers get their ordering from that single
    worker.
"""

from __future__ import annotations

import threading
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Callable, List

IO_LOCK = threading.Lock()

_READ_POOL: ThreadPoolExecutor | None = None
_POOL_LOCK = threading.Lock()


def read_pool() -> ThreadPoolExecutor:
    """The process's reader pool, created on first use."""
    global _READ_POOL
    with _POOL_LOCK:
        if _READ_POOL is None:
            _READ_POOL = ThreadPoolExecutor(
                max_workers=2, thread_name_prefix="roms-io-read")
        return _READ_POOL


class AsyncSink:
    """Ordered background executor with bounded in-flight jobs.

    Jobs run on ONE worker thread in submission order (NetCDF record
    writes must land in order); `submit` blocks only when `max_pending`
    jobs are already queued (each pending output job pins a state, so the
    bound caps device and host memory growth).  Exceptions re-raise on the
    next submit or drain, never silently."""

    def __init__(self, max_pending: int = 2):
        self.max_pending = max_pending
        self._pool = ThreadPoolExecutor(max_workers=1,
                                        thread_name_prefix="roms-io-write")
        self._futs: List[Future] = []

    def submit(self, fn: Callable, *args, **kwargs):
        while len(self._futs) >= self.max_pending:
            self._futs.pop(0).result()
        self._futs.append(self._pool.submit(fn, *args, **kwargs))

    def drain(self):
        """Wait for every queued job; re-raise the first failure."""
        while self._futs:
            self._futs.pop(0).result()


def make_async_hook(hook: Callable, max_pending: int = 2) -> Callable:
    """Wrap a step hook `f(state, i)` so it runs on a background worker.

    The returned hook enqueues and returns at once; the device-to-host
    pulls happen on the worker.  That is safe because the step never
    writes into a tensor that a state it returned holds: `OceanState.
    replace` builds a new state, and every in-place write of the step goes
    to a tensor the step made itself (tests/test_torch_io.py holds clones
    of a state's fields against the fields after the next step).  The
    worker uses the same default CUDA stream as the step loop, so its
    copies are ordered after the step that made the state, and the tensors
    it holds stay allocated until its job ends.  The driver calls
    `.drain()` after the loop, so every record is on disk before `run`
    returns."""
    sink = AsyncSink(max_pending)

    def wrapped(state, i):
        sink.submit(hook, state, i)

    wrapped.drain = sink.drain
    wrapped.sink = sink
    return wrapped
