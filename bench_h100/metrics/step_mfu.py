"""The whole step's share of the card's roofline peak: the least time of
one step (`counts/step.py`: the larger of its operations over the
arithmetic peak and its compulsory bytes over the memory rate) over the
traced window's seconds per step, in %."""

from bench_h100.harness import BENCH, load_module

UNIT = "%"


def read(run):
    if run.trace is None or not run.trace.kernels():
        return None
    step = load_module(BENCH / "counts" / "step.py")
    bound, _ = step.bound_s(run.cfg, run.elem)
    return 100.0 * bound * run.trace.steps / run.trace.window_s
