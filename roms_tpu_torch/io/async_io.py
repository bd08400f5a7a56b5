"""Background reads of forcing records (port of the reader half of
roms_tpu/io/async_io.py).

`forcing.Series` schedules the next record onto the shared reader pool as
soon as the current bracket is known, so crossing a record boundary finds
the data already on the host (the reference blocks on every read,
reference: roms_read_write.F:303-652).  All background NetCDF reads
serialize on `IO_LOCK`: the readers hand out lazy variables over shared
seekable file objects, so two concurrent reads of one dataset would race
on the file position.
"""

from __future__ import annotations

import threading
from concurrent.futures import ThreadPoolExecutor

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
