"""Frozen operation and byte counts, one module per kernel and one for
the whole step, computed from a configuration's shapes.  A kernel's
module names the device kernels of one call (`KERNELS`, substrings of
the names in the profiler's trace) and gives `bound_s(cfg, elem)`, the
least time of one call on the card (`peaks.bound_s`).  The counts are
this benchmark's and do not follow later changes to the program's
wrappers."""
