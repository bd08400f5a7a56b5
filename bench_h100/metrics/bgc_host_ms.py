"""Host milliseconds of one call of the BGC block, `stepper.bgc_update`:
the median over the run's calls (one a step: the warm-up, the window and
the traced steps), from the program's own counter
`roms_tpu_torch.stepper.bgc_stats` (time.perf_counter around the call,
no synchronize).  The median keeps the first calls and the profiled ones
out of the number.  None where the program keeps no such counter or the
run made no call."""

import importlib
import statistics

UNIT = "ms"


def read(run):
    stepper = importlib.import_module("roms_tpu_torch.stepper")
    stats = getattr(stepper, "bgc_stats", None)
    if not stats or not stats.get("calls") or not stats.get("host_s"):
        return None
    return 1e3 * statistics.median(stats["host_s"])
