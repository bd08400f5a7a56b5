"""The uv_rhs kernel's share of its roofline (counts/uv_rhs.py) over its
device time in the traced window; nothing to read where the program has
no such kernel."""

from bench_h100.readers import roofline

UNIT = "%"


def read(run):
    return roofline(run, "uv_rhs")
