"""Run driver: step loop and diagnostics log (port of roms_tpu/driver.py:run;
reference: main.F:55-83)."""

from __future__ import annotations

import numpy as np

from roms_tpu_torch.config import ModelConfig
from roms_tpu_torch.diag import compute_diag
from roms_tpu_torch.monitor import check_blowup
from roms_tpu_torch.ops.weights import set_weights
from roms_tpu_torch.stepper import step


def _diag_due(iic: int, ninfo: int) -> bool:
    """Log-ramped diagnostics schedule: every step while spinning up
    (powers of two below ninfo), then every ninfo steps
    (reference: diag.F:36-41)."""
    if ninfo <= 1 or iic <= 1:
        return True
    if iic % ninfo == 0:
        return True
    if iic < ninfo:
        return iic & (iic - 1) == 0
    return False


def run(grid, state, forcing, cfg: ModelConfig, nsteps: int | None = None,
        collect_diag: bool = True, print_diag: bool = False,
        blowup_check: bool = True, step_hook=None, ninfo: int = 1):
    """Advance `nsteps` baroclinic steps; return (state, diag_rows).

    diag_rows[i] = (step_index, avke, avke2b, cu_adv, cu_w) as in the
    reference log table (reference: diag.F:540-552).  blowup_check: NaN/Inf
    watchdog on the diagnostics (reference: diag.F:624-634).  step_hook:
    optional f(state, step_index) after every step.  Steps between
    diagnostics points never wait on the device.
    """
    if nsteps is None:
        nsteps = cfg.ntimes
    w1, w2, _ = set_weights(cfg.ndtfast)     # host float64 weights

    rows = []

    def log(st, iic):
        if collect_diag and _diag_due(iic, ninfo):
            d = compute_diag(st, grid, cfg)
            row = (iic, float(d.avke), float(d.avke2b),
                   float(d.cu_adv), float(d.cu_w))
            rows.append(row)
            if print_diag:
                print(f"{iic:3d} {row[1]:.16E} {row[2]:.16E} "
                      f"{row[3]:.16E} {row[4]:.16E}")
            if blowup_check:
                check_blowup(row[1:], iic)

    log(state, 0)
    for i in range(nsteps):
        state = step(state, forcing, grid, w1, w2, cfg, first_step=(i == 0))
        log(state, i + 1)
        if step_hook is not None:
            step_hook(state, i + 1)
    return state, np.asarray(rows)
