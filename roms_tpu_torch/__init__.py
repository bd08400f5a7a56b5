"""roms_tpu_torch — the PyTorch and CUDA port of roms_tpu.

A second package beside `roms_tpu` (the JAX reference, which stays as it
is).  Module names mirror `roms_tpu`, so each port module sits where its
counterpart does.  The port imports `torch` and never `jax`; it shares the
host-only modules of `roms_tpu` that import neither (`roms_tpu.config`
through `roms_tpu_torch.config`, `roms_tpu.ops.weights`,
`roms_tpu.monitor`), so both packages take the same frozen `ModelConfig`.

Scope of this slice: the doubly periodic baroclinic step of the Filament
case (linear EOS, one tracer, no KPP) through `driver.run`, with the two
TPU kernels on that path written by hand in CUDA for Hopper
(`ops/cuda_tracer.py`, `ops/cuda_solve.py`, sources under `csrc/`).
Everything the step does not carry raises `NotImplementedError`.
"""
