"""River point sources of the port against the JAX package, in float64 on
the CPU:

(a) `ops/rivers.py` (`_decode`, `overwrite_uv`, `overwrite_barotropic`,
    `tracer_flux_fix_all`) against roms_tpu/ops/rivers.py on seeded random
    face encodings with river index 0, 1 and 2 and both signs, at rtol
    1e-15: these functions only gather, select and divide;
(b) `cases/rivers_ana.setup` against roms_tpu.cases.rivers_ana.setup,
    every field at 1e-13, and the forcing through the bridge;
(c) three steps of Rivers_ana against roms_tpu.stepper.step, every state
    field at atol 5e-11 * max(1, max|ref|) (`STEP_TOL`), `we`, `akv`,
    `akt` at 1e-8 (`CONDITIONED_TOL`; see tests/test_torch_production.py).
    The configuration lies outside `cuda_tracer.usable`, so both tracer
    stages take the reference's batched branch with the river flux fix.
"""

from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from roms_tpu.cases import rivers_ana as jra
from roms_tpu.ops import rivers as jriv

from roms_tpu_torch import bridge
from roms_tpu_torch.cases import rivers_ana as tra
from roms_tpu_torch.cases.bench_production import CONDITIONED_TOL, STEP_TOL
from roms_tpu_torch.ops import cuda_tracer
from roms_tpu_torch.ops import rivers as triv

from torch_helpers import (F64, assert_fields_close, assert_state_close,
                           np_tree, port_cfg, run_jax, run_port)

torch.set_num_threads(1)

NZ, NT, JY, IX = 5, 3, 9, 11


def _faces(rng):
    """±frac + 10*index on ~60 % of the faces, index 0, 1 or 2."""
    sign = rng.choice([-1.0, 1.0], (JY, IX))
    frac = rng.uniform(0.05, 0.95, (JY, IX))
    idx = rng.integers(0, 3, (JY, IX))
    on = rng.random((JY, IX)) < 0.6
    return np.where(on, sign * frac + 10.0 * idx, 0.0)


def _inputs(seed):
    rng = np.random.default_rng(seed)
    hz = rng.uniform(0.5, 4.0, (NZ, JY, IX))
    z_w = np.concatenate([np.zeros((1, JY, IX)), np.cumsum(hz, 0)])
    z_w = z_w - rng.uniform(10.0, 20.0, (JY, IX))
    return dict(
        riv_uflx=_faces(rng), riv_vflx=_faces(rng),
        riv_vol=rng.uniform(10.0, 500.0, 3),
        riv_trc=rng.uniform(0.0, 30.0, (3, NT)),
        dn_u=rng.uniform(200.0, 400.0, (JY, IX)),
        dm_v=rng.uniform(200.0, 400.0, (JY, IX)),
        hz=hz, z_w=z_w,
        u=rng.standard_normal((NZ, JY, IX)),
        v=rng.standard_normal((NZ, JY, IX)),
        ubar=rng.standard_normal((JY, IX)),
        vbar=rng.standard_normal((JY, IX)),
        du_avg1=rng.standard_normal((JY, IX)),
        dv_avg1=rng.standard_normal((JY, IX)),
        dnew=rng.uniform(5.0, 20.0, (JY, IX)),
        fx=rng.standard_normal((NT, NZ, JY, IX)),
        fe=rng.standard_normal((NT, NZ, JY, IX)))


def _both(d):
    """(JAX namespace, port namespace) of the same arrays."""
    return (SimpleNamespace(**{k: jnp.asarray(v) for k, v in d.items()}),
            SimpleNamespace(**{k: torch.as_tensor(v, dtype=F64)
                               for k, v in d.items()}))


def _equal(got, ref):
    for g, r in zip(got, ref):
        g = g.numpy() if isinstance(g, torch.Tensor) else g
        np.testing.assert_allclose(g, np.asarray(r), rtol=1e-15, atol=0)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_decode(seed):
    j, t = _both(_inputs(seed))
    ref = jriv._decode(j.riv_uflx, j.riv_vol)
    got = triv._decode(t.riv_uflx, t.riv_vol)
    assert got[2].dtype == torch.long
    assert set(np.unique(got[2].numpy())) == {0, 1, 2}
    assert (got[1].numpy() < 0).any() and (got[1].numpy() > 0).any()
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(ref[0]))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(ref[2]))
    _equal(got[1:2], ref[1:2])


@pytest.mark.parametrize("seed", [0, 1])
def test_overwrite_uv(seed):
    j, t = _both(_inputs(seed))
    _equal(triv.overwrite_uv(t.u, t.v, t, t.z_w, t),
           jriv.overwrite_uv(j.u, j.v, j, j.z_w, j))


@pytest.mark.parametrize("seed", [0, 1])
def test_overwrite_barotropic(seed):
    j, t = _both(_inputs(seed))
    _equal(triv.overwrite_barotropic(t.ubar, t.vbar, t.du_avg1, t.dv_avg1,
                                     t.dnew, t, t),
           jriv.overwrite_barotropic(j.ubar, j.vbar, j.du_avg1, j.dv_avg1,
                                     j.dnew, j, j))


@pytest.mark.parametrize("seed", [0, 1])
def test_tracer_flux_fix_all(seed):
    j, t = _both(_inputs(seed))
    _equal(triv.tracer_flux_fix_all(t.fx, t.fe, t.hz, t.z_w, t, t),
           jriv.tracer_flux_fix_all(j.fx, j.fe, j.hz, j.z_w, j, j))


@pytest.fixture(scope="module")
def rivers():
    cfg = jra.config()
    return cfg, jra.setup(cfg)


def test_setup_matches_jax(rivers):
    cfg, jx = rivers
    tx = tra.setup(port_cfg(cfg), dtype=F64, device="cpu")
    assert tra.config() == port_cfg(cfg)
    for j, t in zip(jx, tx):
        assert_fields_close(j, t, 1e-13)


def test_forcing_round_trips_through_bridge(rivers):
    _, (_, _, jfrc) = rivers
    d = np_tree(jfrc)
    back = bridge.to_numpy(bridge.forcing_from_numpy(d, dtype=F64,
                                                     device="cpu"))
    for name in ("riv_uflx", "riv_vflx", "riv_vol", "riv_trc"):
        assert back[name].dtype == d[name].dtype == np.float64
        np.testing.assert_array_equal(back[name], d[name])


def test_three_steps_match_jax(rivers):
    cfg, (jg, jst, jfrc) = rivers
    assert not cuda_tracer.usable(port_cfg(cfg))
    ref = run_jax(cfg, jg, jst, jfrc)
    got = run_port(cfg, jg, jst, jfrc)
    assert_state_close(got, ref, STEP_TOL, loose=CONDITIONED_TOL)
