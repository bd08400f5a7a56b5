"""roms_tpu_torch — the PyTorch and CUDA port of roms_tpu.

A second package beside `roms_tpu` (the JAX reference, which stays as it
is).  Module names mirror `roms_tpu`, so each port module sits where its
counterpart does.  The port imports `torch`, numpy and itself only: it
keeps its own copies of the host modules it needs (`config.py`,
`monitor.py`, `ops/weights.py`), and `bridge.config_from_dict` rebuilds a
JAX package configuration as the port's `ModelConfig`.

Scope: the baroclinic step through `driver.run` for the Filament case
(doubly periodic, linear EOS) and the production-physics case
(`cases/bench_production.py`: nonlinear EOS, KPP, 34 tracers, land mask,
curvilinear metrics, lateral viscosity and 4-side open boundaries), the
point sources and the file-driven real-data cases, bulk-COARE forcing,
tides, the BGC engines (`bgc/`) and the mCDR releases (`cdr.py`), with
the three TPU kernels of that step written by hand in CUDA for Hopper
(`ops/cuda_tracer.py`, `ops/cuda_solve.py`, `ops/cuda_kpp.py`, sources
under `csrc/`), and the command line (`python -m roms_tpu_torch`) with its
output files, exact restart and host tools (`io/`, `tools/`); every step
option (isoneutral mixing, the non-hydrostatic projection, the budgets,
the upscale capture), the nested-domain workflow (`pflx.py`,
`sponge_tune.py`, `io/upscale.py`, `cases/nested_basin.py`) and
Lagrangian particles (`particles.py`), on one device or over a rank
mesh with `torch.distributed` (`parallel/dist.py`, `driver.run_distributed`,
partit/ncjoin in `tools/partition.py`).
"""
