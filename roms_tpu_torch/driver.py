"""Run driver: step loop and diagnostics log (port of roms_tpu/driver.py:run;
reference: main.F:55-83)."""

from __future__ import annotations

import inspect

import numpy as np

from roms_tpu_torch.config import ModelConfig
from roms_tpu_torch.diag import compute_diag
from roms_tpu_torch.monitor import check_blowup
from roms_tpu_torch.ops.weights import set_weights
from roms_tpu_torch.stepper import step


def _accepts_state(fn) -> bool:
    """Does the set_forces hook take the 3-argument form f(t, base,
    state)?  Decided by signature, so an error raised inside a 3-argument
    hook propagates instead of demoting the call to the 2-argument form."""
    try:
        sig = inspect.signature(fn)
    except (TypeError, ValueError):
        return True
    kinds = [p.kind for p in sig.parameters.values()]
    npos = sum(k in (inspect.Parameter.POSITIONAL_ONLY,
                     inspect.Parameter.POSITIONAL_OR_KEYWORD) for k in kinds)
    return npos >= 3 or inspect.Parameter.VAR_POSITIONAL in kinds


def _call_forcing_fn(fn, t, forcing, state):
    """set_forces hook: the 3-argument form f(t, base, state) where the
    hook takes it (bulk forcing reads the SST, reference: bulk_frc.F),
    else f(t, base)."""
    if _accepts_state(fn):
        return fn(t, forcing, state)
    return fn(t, forcing)


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
        blowup_check: bool = True, forcing_fn=None, step_hook=None,
        ninfo: int = 1, error_log=None, timers=None):
    """Advance `nsteps` baroclinic steps; return (state, diag_rows).

    diag_rows[i] = (step_index, avke, avke2b, cu_adv, cu_w) as in the
    reference log table (reference: diag.F:540-552).  blowup_check: NaN/Inf
    watchdog on the diagnostics (reference: diag.F:624-634).  forcing_fn:
    optional set_forces hook f(time_seconds, base_forcing[, state]) ->
    Forcing, called before every step at t0 + i*dt, t0 the state's time
    read once (reference: main.F:385).  step_hook:
    optional f(state, step_index) after every step; a hook with `.drain()`
    (`io.async_io.make_async_hook`) is drained before `run` returns, so
    every record is on disk.  Steps between diagnostics points never wait
    on the device.  error_log: optional monitor.ErrorLog; blowups are
    queued there and still raised (reference: error_handling_mod.F90).
    timers: optional monitor.Timers; accumulates the 'step' phase and the
    step count for the run banner (reference: timers.F, main.F:45-47).
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
                check_blowup(row[1:], iic, error_log=error_log)

    t0 = float(state.time)   # one sync up front; model time advances by dt
    if timers is not None:
        timers.tic("step")
    log(state, 0)
    for i in range(nsteps):
        frc = forcing if forcing_fn is None else _call_forcing_fn(
            forcing_fn, t0 + i * cfg.dt, forcing, state)
        state = step(state, frc, grid, w1, w2, cfg, first_step=(i == 0))
        log(state, i + 1)
        if step_hook is not None:
            step_hook(state, i + 1)
    if step_hook is not None and hasattr(step_hook, "drain"):
        step_hook.drain()        # async writers: everything on disk first
    if timers is not None:
        timers.toc("step", sync=state.zeta)
        timers.nsteps += nsteps
    return state, np.asarray(rows)
