"""Pipe point sources of the port against the JAX package, in float64 on
the CPU:

(a) `kinematics.pipe_profile_3d` against roms_tpu/ops/kinematics.py on
    seeded random tables with pipe index 0, 1 and 2 and fluxes of both
    signs, at rtol 1e-15 (a gather and a product), and the stepper's
    pipe tracer load against the JAX package's batched-branch expression
    (roms_tpu/stepper.py:562-569);
(b) `omega` with a pipe against the JAX version on the Pipes_ana grid, at
    atol 1e-11 * max(1, max|ref|) (the port's cumsum against the JAX
    package's associative scan, as in tests/test_torch_ops.py);
(c) `cases/pipes_ana.setup` against roms_tpu.cases.pipes_ana.setup, every
    field at 1e-13, and the forcing through the bridge with `pipe_idx`
    still an int32;
(d) three steps of Pipes_ana against roms_tpu.stepper.step, every state
    field at 5e-11 * max(1, max|ref|), `we`, `akv`, `akt` at 1e-8.  Here
    the port runs the tracer stage (its plain version on the CPU) with the
    pipe load folded into its base content, and the JAX package runs its
    batched branch, which adds the load: the match shows that the port's
    kernel path keeps the load that the JAX kernel branch drops;
(e) the load fires: with `pipe_trc` zero the tracers next to the pipe
    come out different.
"""

from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from roms_tpu.cases import pipes_ana as jpa
from roms_tpu.ops import kinematics as jkin

from roms_tpu_torch import bridge
from roms_tpu_torch.cases import pipes_ana as tpa
from roms_tpu_torch.cases.bench_production import CONDITIONED_TOL, STEP_TOL
from roms_tpu_torch.ops import cuda_tracer
from roms_tpu_torch.ops import kinematics as tkin
from roms_tpu_torch.stepper import _pipe_load

from torch_helpers import (F64, assert_fields_close, assert_state_close,
                           np_tree, port_cfg, run_jax, run_port)

torch.set_num_threads(1)


def _tables(seed, nz=6, nt=3, jy=9, ix=11):
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, 3, (jy, ix)).astype(np.int32)
    return dict(pipe_idx=idx, pipe_prf=rng.random((3, nz)),
                pipe_flx=rng.standard_normal((jy, ix)),
                pipe_trc=rng.uniform(0.0, 30.0, (3, nt)),
                pmn=rng.uniform(1e-7, 1e-5, (jy, ix)))


def _both(d):
    def t(v):
        return torch.as_tensor(v) if v.dtype == np.int32 else \
            torch.as_tensor(v, dtype=F64)
    return (SimpleNamespace(**{k: jnp.asarray(v) for k, v in d.items()}),
            SimpleNamespace(**{k: t(v) for k, v in d.items()}))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_pipe_profile_3d(seed):
    d = _tables(seed)
    assert set(np.unique(d["pipe_idx"])) == {0, 1, 2}
    j, t = _both(d)
    np.testing.assert_allclose(tkin.pipe_profile_3d(t, 6).numpy(),
                               np.asarray(jkin.pipe_profile_3d(j, 6)),
                               rtol=1e-15, atol=0)


def test_pipe_tracer_load():
    d = _tables(3)
    j, t = _both(d)
    cfg = SimpleNamespace(dt=60.0, nz=6)
    # the JAX package's batched branch (roms_tpu/stepper.py:562-569)
    src3d = jkin.pipe_profile_3d(j, 6)
    trc_p = jnp.moveaxis(j.pipe_trc[jnp.clip(j.pipe_idx, 0, 2)], -1, 0)
    ref = cfg.dt * j.pmn[None] * src3d[None] * trc_p[:, None]
    np.testing.assert_allclose(_pipe_load(t, t.pmn, cfg).numpy(),
                               np.asarray(ref), rtol=1e-15, atol=0)


@pytest.fixture(scope="module")
def pipes():
    cfg = jpa.config()
    return cfg, jpa.setup(cfg)


def test_omega_with_pipe(pipes):
    cfg, (jg, jst, jfrc) = pipes
    tcfg = port_cfg(cfg)
    tg = bridge.grid_from_numpy(np_tree(jg), dtype=F64, device="cpu")
    tfrc = bridge.forcing_from_numpy(np_tree(jfrc), dtype=F64, device="cpu")
    rng = np.random.default_rng(5)
    hz = np.array(jst.hz)
    z_w = np.concatenate([np.zeros((1,) + hz.shape[1:]), np.cumsum(hz, 0)])
    z_w = z_w - np.array(jg.h)[None]
    fu = 10.0 * rng.standard_normal(hz.shape)
    fv = 10.0 * rng.standard_normal(hz.shape)
    swflx = 1e-7 * rng.standard_normal(hz.shape[1:])
    ref = jkin.omega(jnp.asarray(fu), jnp.asarray(fv), jnp.asarray(z_w),
                     jnp.asarray(hz), jnp.asarray(swflx), jg, 30.0, cfg,
                     jfrc)
    got = tkin.omega(*(torch.as_tensor(a) for a in (fu, fv, z_w, hz, swflx)),
                     tg, 30.0, tcfg, tfrc)
    for a, b in zip(ref, got):
        a = np.asarray(a)
        np.testing.assert_allclose(b.numpy(), a, rtol=0,
                                   atol=1e-11 * max(1.0, np.abs(a).max()))


def test_setup_matches_jax(pipes):
    cfg, jx = pipes
    tx = tpa.setup(port_cfg(cfg), dtype=F64, device="cpu")
    assert tpa.config() == port_cfg(cfg)
    for j, t in zip(jx, tx):
        assert_fields_close(j, t, 1e-13)
    assert tx[2].pipe_idx.dtype == torch.int32


def test_forcing_round_trips_through_bridge(pipes):
    _, (_, _, jfrc) = pipes
    d = np_tree(jfrc)
    frc = bridge.forcing_from_numpy(d, dtype=F64, device="cpu")
    assert frc.pipe_idx.dtype == torch.int32
    back = bridge.to_numpy(frc)
    for name in ("pipe_flx", "pipe_idx", "pipe_prf", "pipe_trc"):
        assert back[name].dtype == d[name].dtype
        np.testing.assert_array_equal(back[name], d[name])
    assert back["pipe_idx"].dtype == np.int32


@pytest.fixture(scope="module")
def port_steps(pipes):
    cfg, (jg, jst, jfrc) = pipes
    return run_port(cfg, jg, jst, jfrc)


def test_three_steps_match_jax(pipes, port_steps):
    cfg, (jg, jst, jfrc) = pipes
    assert cuda_tracer.usable(port_cfg(cfg))
    ref = run_jax(cfg, jg, jst, jfrc)
    assert_state_close(port_steps, ref, STEP_TOL, loose=CONDITIONED_TOL)


def test_pipe_tracer_load_fires(pipes, port_steps):
    cfg, (jg, jst, jfrc) = pipes
    dry = run_port(cfg, jg, jst,
                   jfrc.replace(pipe_trc=jnp.zeros_like(jfrc.pipe_trc)))
    near = np.asarray(jfrc.pipe_idx) > 0
    diff = np.abs(port_steps["t"] - dry["t"])
    # temperature and salinity in the pipe's bottom cells
    assert diff[0, :2][:, near].min() > 1e-3
    assert diff[1, :2][:, near].min() > 1e-3
    # a thousand times smaller away from it, where only the density's
    # pressure signal has arrived
    far = np.ones_like(near)
    js, is_ = np.nonzero(near)
    far[js.min() - 8:js.max() + 9, is_.min() - 8:is_.max() + 9] = False
    assert diff[:, :, far].max() < 1e-6
