"""The port's production-physics step end to end on the CPU, in float64:

(a) `cases/bench_production.setup` at 48x32x16 with nt=4 against
    roms_tpu.cases.bench_production.setup, every grid, state, forcing and
    boundary-data field at 1e-13;
(b) three steps of it against roms_tpu.stepper.step (nonlinear EOS, KPP
    through `cuda_kpp.vmix_update`, visc3d, the fused t3dmix, curvilinear
    metrics, a land mask and 4-side Flather/Orlanski/Orlanski open
    boundaries), every state field at atol 5e-11 * max(1, max|ref|) (the
    bound of tests/test_torch_step.py), except three diagnosed fields;
and the same three steps of the open-boundary basin live in
tests/test_torch_obc_basin.py (each file stays near a minute on one
worker: the JAX step's compile dominates).

The three fields held at 1e-8 * max(1, max|ref|) instead are `we`, `akv`
and `akt` (`bench_production.CONDITIONED_TOL`, which chip_smoke.py reads
too).  They are ill-conditioned in the inputs: the Richardson number
N^2/S^2 divides by the square of a vertical shear that is a small
difference of nearly equal velocities, and `we` integrates the
divergence of nearly cancelling fluxes.  The reference shows it itself:
`test_reference_conditioning` perturbs the initial tracers by 1e-15
relative and finds the JAX step's own `we` and `akv` moving by more than
5e-11 * scale, by as much as the port differs from it.
`test_option_conditioning` shows the same, on the port's own runs, for
each array that `bench_production.OPTION_CONDITIONED_TOL` adds under one
of the step's option sets (the volume fluxes and what is computed from
them, the momentum budget's u.vmix and rate).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from roms_tpu.cases import bench_production as jbp

from roms_tpu_torch.cases import bench_production as tbp

from torch_helpers import (F64, assert_fields_close, assert_state_close,
                           port_cfg, run_jax, run_port)

torch.set_num_threads(1)

TOL = tbp.STEP_TOL
CONDITIONED = tbp.CONDITIONED_TOL


@pytest.fixture(scope="module")
def production():
    cfg = jbp.config(nx=48, ny=32, nz=16, nt=4)
    return cfg, jbp.setup(cfg, dtype=jnp.float64)


def test_setup_matches_jax(production):
    cfg, jx = production
    tx = tbp.setup(port_cfg(cfg), dtype=F64, device="cpu")
    assert tbp.config(48, 32, 16, 4) == port_cfg(cfg)
    for j, t in zip(jx, tx):
        assert_fields_close(j, t, 1e-13)


def test_three_steps_match_jax(production):
    cfg, (jg, jst, jfrc) = production
    ref = run_jax(cfg, jg, jst, jfrc)
    got = run_port(cfg, jg, jst, jfrc)
    assert_state_close(got, ref, TOL, loose=CONDITIONED)


OPTIONS = tbp.OPTIONS
# seeds of the 1e-15 perturbations that measure an array's conditioning
SEEDS = (0, 1, 2, 3)


def perturbation(shape, seed):
    """The factor 1 + 1e-15 * N(0, 1) applied to the tracers."""
    return 1.0 + 1e-15 * np.random.default_rng(seed).standard_normal(shape)


def _flat(d, pre=""):
    """A state as numpy arrays, the outputs' terms under dotted names."""
    out = {}
    for k, v in d.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{pre}{k}."))
        elif v is not None and v.dtype.kind == "f":
            out[pre + k] = v
    return out


@pytest.mark.parametrize("option", sorted(OPTIONS))
def test_option_conditioning(option):
    """Each array that `bench_production.OPTION_CONDITIONED_TOL[option]`
    adds is ill-conditioned in the port's own step too: a 1e-15 relative
    perturbation of the tracers (noise seeds 0-3) moves its 3 steps in
    float64 by more than STEP_TOL, and by under 1e-8.  Every other array
    moves by under 2 * STEP_TOL.  Two arrays cross STEP_TOL with one seed,
    uv_budget.v.cori under nh in the JAX step and upscale.north under iso
    in the port's; they are held at STEP_TOL all the same, which the card
    meets on them (chip_smoke.py's phase 14a)."""
    from roms_tpu_torch import bridge
    from roms_tpu_torch.driver import run
    cfg = tbp.config(48, 32, 16, 4).replace(**OPTIONS[option])
    runs = []
    for seed in (None,) + SEEDS:
        g, st, frc = tbp.setup(cfg, dtype=F64, device="cpu")
        if seed is not None:
            st = st.replace(t=st.t * torch.as_tensor(
                perturbation(tuple(st.t.shape), seed)))
        st, _ = run(g, st, frc, cfg, nsteps=3, collect_diag=False)
        runs.append(_flat(bridge.to_numpy(st)))
    a = runs[0]
    spread = {k: max(np.abs(a[k] - b[k]).max() for b in runs[1:])
              / max(1.0, np.abs(a[k]).max()) for k in a}
    loose = tbp.OPTION_CONDITIONED_TOL[option]
    added = {k: spread[k] for k in loose if k not in CONDITIONED}
    assert added
    for k, v in added.items():
        assert TOL < v < 1e-8, (k, v)
    rest = {k: v for k, v in spread.items() if k not in loose}
    assert all(v < 2 * TOL for v in rest.values()), rest


def test_reference_conditioning(production):
    """The JAX step moves we/akv by more than 5e-11 * scale under a
    1e-15 relative perturbation of its own input tracers."""
    cfg, (jg, jst, jfrc) = production
    rng = np.random.default_rng(0)
    noise = 1.0 + 1e-15 * rng.standard_normal(jst.t.shape)
    a = run_jax(cfg, jg, jst, jfrc)
    b = run_jax(cfg, jg, jst.replace(t=jst.t * jnp.asarray(noise)), jfrc)
    for name in ("we", "akv"):
        x, y = np.asarray(getattr(a, name)), np.asarray(getattr(b, name))
        spread = np.abs(x - y).max() / max(1.0, np.abs(x).max())
        assert TOL < spread < CONDITIONED[name], (name, spread)
