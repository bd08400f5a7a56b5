"""Run driver: step loop and diagnostics log, on one block (`run`) or on
a rank mesh (`run_distributed`) (port of roms_tpu/driver.py; reference:
main.F:55-83)."""

from __future__ import annotations

import inspect

import numpy as np

from roms_tpu_torch.config import ModelConfig
from roms_tpu_torch.diag import compute_diag
from roms_tpu_torch.monitor import check_blowup, span
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
    w1, w2, _ = set_weights(cfg.ndtfast)     # host float64 weights

    def step_fn(st, frc, first_step):
        return step(st, frc, grid, w1, w2, cfg, first_step=first_step)

    def hook_forcing(t, st):
        return _call_forcing_fn(forcing_fn, t, forcing, st)

    return _loop(state, forcing, cfg, nsteps, step_fn,
                 (lambda st: compute_diag(st, grid, cfg)) if collect_diag
                 else None, None if forcing_fn is None else hook_forcing,
                 print_diag, blowup_check, step_hook, ninfo, error_log,
                 timers)


def _loop(state, forcing, cfg: ModelConfig, nsteps, step_fn, diag_fn,
          forcing_at, print_diag, blowup_check, step_hook, ninfo, error_log,
          timers):
    """The step loop of `run` and `run_distributed`: step_fn(state,
    forcing, first_step), diag_fn(state) -> Diag or None, forcing_at(t,
    state) -> the step's forcing or None for `forcing` every step.  Under
    `monitor.tracing` each step is the span roms.step, each call of
    forcing_at roms.forcing, each diagnostics row roms.diag, and each call
    of step_hook and its drain roms.output."""
    if nsteps is None:
        nsteps = cfg.ntimes
    rows = []

    def log(st, iic):
        if diag_fn is not None and _diag_due(iic, ninfo):
            with span("roms.diag"):
                d = diag_fn(st)
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
        frc = forcing
        if forcing_at is not None:
            with span("roms.forcing"):
                frc = forcing_at(t0 + i * cfg.dt, state)
        with span("roms.step"):
            state = step_fn(state, frc, i == 0)
        log(state, i + 1)
        if step_hook is not None:
            with span("roms.output"):
                step_hook(state, i + 1)
    if step_hook is not None and hasattr(step_hook, "drain"):
        with span("roms.output"):
            step_hook.drain()    # async writers: everything on disk first
    if timers is not None:
        timers.toc("step", sync=state.zeta)
        timers.nsteps += nsteps
    return state, np.asarray(rows)


def run_distributed(grid, state, forcing, cfg: ModelConfig, mesh,
                    nsteps: int | None = None, collect_diag: bool = True,
                    print_diag: bool = False, blowup_check: bool = True,
                    step_hook=None, forcing_fn=None, ninfo: int = 1,
                    error_log=None, timers=None):
    """`run` on a rank mesh (`parallel.dist.Mesh`): every rank calls it
    with the same padded-global grid, state and forcing (SPMD over
    processes); each steps its block-halo block and all gather at the
    end.  Returns (the padded-global state as numpy arrays, diag_rows) on
    every rank.

    Diagnostics come from `diag.make_distributed_diag`, bitwise those of
    `compute_diag` on the gathered state and the same on every rank, so
    `check_blowup` raises on every rank together (reference: diag.F
    cross-rank reduction + blowup test diag.F:624-634); rank 0 prints.
    forcing_fn runs on every rank on the padded-global base forcing, as
    every reference rank re-reads its forcing each step (set_forces,
    main.F:385-386), at t0 + i*dt on the host; its global Forcing is cut
    into the rank's block.  A 3-argument hook gets a surface-only
    padded-global view of the live state, gathered from the blocks: `.t`
    (nt, 1, ...), `.u`/`.v` (1, ...), tensors on the base forcing's
    device, so `st.t[itemp, -1]` and `st.u[-1]` read as on the full
    state (bulk_frc.F reads the SST and the surface currents only);
    hooks tagged `needs_state = False` skip the gather.  step_hook gets
    the rank's block state; error_log, timers and the drain of an async
    hook as in `run`."""
    from types import SimpleNamespace

    import torch

    from roms_tpu_torch.diag import make_distributed_diag
    from roms_tpu_torch.parallel.dist import (from_blocks,
                                              make_distributed_step,
                                              pad_for_mesh, to_block)

    w1, w2, _ = set_weights(cfg.ndtfast)
    h = cfg.halo
    cfg_p = pad_for_mesh(cfg, mesh)   # the same config when it divides
    pads = (cfg_p.pad_n, cfg_p.pad_e)
    dstep = make_distributed_step(cfg, mesh)
    grid_b = to_block(grid, mesh, h, pads)
    pass_state = (forcing_fn is not None and _accepts_state(forcing_fn)
                  and getattr(forcing_fn, "needs_state", True))

    def step_fn(st, frc, first_step):
        return dstep(st, frc, grid_b, w1, w2, first_step)

    diag = make_distributed_diag(cfg_p, mesh)

    def diag_fn(st):
        return diag(st, grid_b)

    def surface_view(st_b):
        surf = from_blocks({"t": st_b.t[:, -1:], "u": st_b.u[-1:],
                            "v": st_b.v[-1:]}, mesh, h, pads)
        return SimpleNamespace(**{
            k: torch.as_tensor(v, dtype=forcing.sustr.dtype,
                               device=forcing.sustr.device)
            for k, v in surf.items()})

    def hook_forcing(t, st_b):
        view = surface_view(st_b) if pass_state else None
        return to_block(_call_forcing_fn(forcing_fn, t, forcing, view),
                        mesh, h, pads)

    state_b, rows = _loop(
        to_block(state, mesh, h, pads), to_block(forcing, mesh, h, pads),
        cfg, nsteps, step_fn, diag_fn if collect_diag else None,
        None if forcing_fn is None else hook_forcing,
        print_diag and mesh.rank == 0, blowup_check, step_hook, ninfo,
        error_log, timers)
    return from_blocks(state_b, mesh, h, pads), rows
