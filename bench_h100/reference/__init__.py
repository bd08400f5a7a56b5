"""The plain reference of the benchmark: a frozen copy of the plain path
of roms_tpu_torch's step (its imports made local), run in float64 to
judge what the timed path produced.  It imports nothing of
roms_tpu_torch, roms_tpu or JAX (`bench_h100/importcheck.py`)."""
