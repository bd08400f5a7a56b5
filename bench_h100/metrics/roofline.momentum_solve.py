"""The momentum_solve kernel's share of its roofline (counts/momentum_solve.py) over
its device time in the traced window."""

from bench_h100.readers import roofline

UNIT = "%"


def read(run):
    return roofline(run, "momentum_solve")
