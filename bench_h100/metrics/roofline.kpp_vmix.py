"""The kpp_vmix kernel's share of its roofline (counts/kpp_vmix.py) over
its device time in the traced window."""

from bench_h100.readers import roofline

UNIT = "%"


def read(run):
    return roofline(run, "kpp_vmix")
