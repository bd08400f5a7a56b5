"""Inputs of the `production-full` configuration: the `production`
configuration's analytic inputs and derivation (configs/production.py),
at the source's default 920x480x60 grid.  Only the grid's size differs,
and that comes from the configuration file."""

from bench_h100.configs.production import derive, raw_inputs  # noqa: F401
