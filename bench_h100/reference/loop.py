"""The step loop of the plain reference: `roms_tpu_torch.driver.run`
with no diagnostics, forcing hook or step hook (reference: main.F:55-83).
Each call starts the LF-AM3 sequence afresh, as `driver.run` does."""

from __future__ import annotations

import torch

from bench_h100.reference.config import ModelConfig
from bench_h100.reference.ops.weights import set_weights
from bench_h100.reference.stepper import step


def run(grid, state, forcing, cfg: ModelConfig, nsteps: int):
    """Advance `nsteps` baroclinic steps; the first is the LF-AM3 start.
    TF32 is off, so no float32 product of the reference rounds lower."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    w1, w2, _ = set_weights(cfg.ndtfast)
    for i in range(nsteps):
        state = step(state, forcing, grid, w1, w2, cfg, first_step=i == 0)
    return state
