"""The tracer_stage kernel's share of its roofline (counts/tracer_stage.py) over
its device time in the traced window."""

from bench_h100.readers import roofline

UNIT = "%"


def read(run):
    return roofline(run, "tracer_stage")
