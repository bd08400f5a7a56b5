"""Host milliseconds a step spends inside `barotropic.fast_loop`, from
the span the benchmark puts around the module attribute that the step
calls (`trace.LAYERS`), with no synchronize."""

UNIT = "ms"


def read(run):
    if run.trace is None:
        return None
    s = run.trace.span_seconds("barotropic.fast_loop")
    return 1e3 * s / run.trace.steps if s > 0.0 else None
