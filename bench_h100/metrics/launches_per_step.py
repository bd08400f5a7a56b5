"""Device kernels a baroclinic step launches: the kernel events of the
traced window over its steps."""

UNIT = "kernels/step"


def read(run):
    if run.trace is None or not run.trace.kernels():
        return None
    return len(run.trace.kernels()) / run.trace.steps
