"""The port's nested parent/child workflow on the CPU, in float64:

(a) `pflx.calc_pflx` (two filter updates), `sponge_tune.adjust_orlanski`
    and `to_boundary` against the JAX package's on the same inputs, at
    rtol = atol = 1e-13 * max(1, max|ref|);
(b) `io.upscale.UpscaleWriter` against the JAX package's writer, fed the
    same strips (a raw tracer and a perturbed-minus-control pair, two
    averaging periods and a partial one): the files equal;
(c) tests/test_nested_flow.py's flow through the port
    (roms_tpu_torch/cases/nested_basin.py) against the JAX package's
    flow (tests/jax_nested_flow.py), both run here: the flow's checks
    (the tuned binding moved, the child's content change equals minus its
    integrated captured flux at rtol 5e-9, the parent's gain within the
    test's envelope, the writer's file equal to the captured strips);
    its numbers (the child's content change, the integrated flux, the
    injected rate, the parent's content before and after, the tuned
    ub_west) at rtol 1e-9; the upscale capture and the rest of the
    child's state after its 8 bound, tuned steps at atol
    5e-11 * max(1, max|ref|); and the copy of the JAX flow's numbers in
    tests/data/nested_flow_jax.txt, which chip_smoke.py holds the card's
    flow to, at rtol 1e-9.

The JAX flow compiles its step for three configurations, twice each (the
first step is its own program), with XLA's optimisation passes off: it
sets this file's time.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from roms_tpu.cases import obc_basin as jbasin
from roms_tpu.io.upscale import UpscaleWriter as JUpscaleWriter
from roms_tpu.pflx import calc_pflx as jcalc_pflx
from roms_tpu.pflx import init_pflx as jinit_pflx
from roms_tpu.sponge_tune import adjust_orlanski as jadjust
from roms_tpu.sponge_tune import init_sponge_tune as jinit_tune
from roms_tpu.sponge_tune import to_boundary as jto_boundary

from roms_tpu_torch import bridge
from roms_tpu_torch.cases import nested_basin
from roms_tpu_torch.io.upscale import UpscaleWriter
from roms_tpu_torch.pflx import calc_pflx, init_pflx
from roms_tpu_torch.sponge_tune import (adjust_orlanski, init_sponge_tune,
                                        to_boundary)

import jax_nested_flow
from torch_helpers import (F64, assert_same_nc, assert_state_close,
                           assert_tree_close, np_tree, port_cfg)

torch.set_num_threads(1)

TOL = 1e-13


@pytest.fixture(scope="module")
def jax_flow(tmp_path_factory):
    """The JAX package's flow: (its numbers, the child's final state).
    XLA's optimisation passes are off while it compiles: they take half
    the CPU time of its six step programs and change no number here
    (test_stored_flow_numbers_are_current holds the result to the
    numbers of the flow compiled with them)."""
    flag = "jax_disable_most_optimizations"
    old = jax.config.values[flag]
    jax.config.update(flag, True)
    try:
        return jax_nested_flow.flow(tmp_path_factory.mktemp("jax_flow"))
    finally:
        jax.config.update(flag, old)


@pytest.fixture(scope="module")
def port_flow(tmp_path_factory):
    """The port's flow on the CPU (nested_basin.run_flow's dict)."""
    return nested_basin.run_flow(str(tmp_path_factory.mktemp("port_flow")),
                                 device="cpu")


def _moving(jst, rng):
    """The basin's start with seeded random velocities, fluxes and
    density, so that every term of the pressure flux is live."""
    shape = jst.u.shape
    return jst.replace(
        u=jnp.asarray(0.1 * rng.standard_normal(shape)),
        v=jnp.asarray(0.1 * rng.standard_normal(shape)),
        flx_u=jnp.asarray(1e3 * rng.standard_normal(shape)),
        flx_v=jnp.asarray(1e3 * rng.standard_normal(shape)),
        rho=jnp.asarray(rng.standard_normal(shape)))


def test_pflx_and_tuning_match_jax():
    jcfg = jbasin.config("radiating").replace(nx=16, ny=16, nz=6, dt=30.0,
                                              ndtfast=20)
    cfg = port_cfg(jcfg)
    jg, jst, jfrc = jbasin.setup(jcfg)
    rng = np.random.default_rng(2)
    tg = bridge.grid_from_numpy(np_tree(jg), dtype=F64, device="cpu")
    jpf, tpf = jinit_pflx(jcfg), init_pflx(cfg, device="cpu")
    for _ in range(2):
        js = _moving(jst, rng)
        ts = bridge.state_from_numpy(np_tree(js), dtype=F64, device="cpu")
        jpf, jup, jvp = jcalc_pflx(jpf, js, jg, jcfg, timescale=4 * cfg.dt)
        tpf, tup, tvp = calc_pflx(tpf, ts, tg, cfg, timescale=4 * cfg.dt)
        assert_tree_close(bridge.to_numpy(tpf), np_tree(jpf), TOL, "pflx")
        assert_tree_close(tup.numpy(), np.asarray(jup), TOL, "up")
        assert_tree_close(tvp.numpy(), np.asarray(jvp), TOL, "vp")
    assert np.abs(tup.numpy()).max() > 0.0

    jy, ix = cfg.ny + 4, cfg.nx + 4
    parent = {e: np.abs(rng.standard_normal(jy if e in ("west", "east")
                                            else ix))
              for e in ("west", "east", "south", "north")}
    jt = jadjust(jinit_tune(jcfg), jup, jvp,
                 {e: jnp.asarray(v) for e, v in parent.items()}, jcfg,
                 sp_timscale=20 * cfg.dt)
    tt = adjust_orlanski(init_sponge_tune(cfg, device="cpu"), tup, tvp,
                         {e: torch.as_tensor(v) for e, v in parent.items()},
                         cfg, sp_timscale=20 * cfg.dt)
    assert_tree_close(bridge.to_numpy(tt), np_tree(jt), TOL, "tune")
    jb = jto_boundary(jt, jfrc.bry)
    tb = to_boundary(tt, bridge.forcing_from_numpy(
        np_tree(jfrc), dtype=F64, device="cpu").bry)
    assert_tree_close({k: v for k, v in bridge.to_numpy(tb).items()
                       if v is not None},
                      {k: v for k, v in np_tree(jb).items() if v is not None},
                      TOL, "bry")


class _Strips:
    """A state-like holder of a boundary capture and a time."""

    def __init__(self, upscale, time):
        self.upscale, self.time = upscale, time


def test_upscale_writer_matches_jax(tmp_path):
    jcfg = jbasin.config("radiating").replace(nx=12, ny=10, nz=4, nt=2)
    cfg = port_cfg(jcfg)
    rng = np.random.default_rng(4)
    pairs = [("temp", 0, None), ("tracer1_add", 1, 0)]
    paths = {k: str(tmp_path / f"{k}.nc") for k in ("port", "jax")}
    tw = UpscaleWriter(paths["port"], None, cfg, pairs, navg=2)
    jw = JUpscaleWriter(paths["jax"], None, jcfg, pairs, navg=2)
    for step in range(5):
        strips = {e: rng.standard_normal((2, 4, n)) for e, n in
                  (("west", 14), ("east", 14), ("south", 16),
                   ("north", 16))}
        t = 60.0 * (step + 1)
        tw.accumulate(_Strips({e: torch.as_tensor(v)
                               for e, v in strips.items()},
                              torch.tensor(t, dtype=F64)))
        jw.accumulate(_Strips({e: jnp.asarray(v) for e, v in strips.items()},
                              jnp.asarray(t)))
    tw.close()
    jw.close()
    assert_same_nc(paths["port"], paths["jax"])


def test_nested_flow_matches_jax(port_flow, jax_flow):
    nested_basin.check_flow(port_flow)
    got = np.concatenate([[port_flow[k] for k in
                           ("dc", "net_flux", "inj", "pc0", "pc1")],
                          port_flow["ub_west"]])
    assert got.shape == jax_flow[0].shape
    np.testing.assert_allclose(got, jax_flow[0], rtol=1e-9, atol=0)


def test_upscale_capture_matches_jax(port_flow, jax_flow):
    """The child's boundary capture and state after the flow's 8 steps."""
    got = bridge.to_numpy(port_flow["child"])
    assert set(got["upscale"]) == {"west", "east", "south", "north"}
    assert np.abs(got["upscale"]["west"]).max() > 0.0
    assert_state_close(got, jax_flow[1], 5e-11)


def test_stored_flow_numbers_are_current(jax_flow):
    """chip_smoke.py's copy of the JAX flow's numbers is the live flow's."""
    np.testing.assert_allclose(np.loadtxt(jax_nested_flow.DATA),
                               jax_flow[0], rtol=1e-9, atol=0)


def test_flow_sizes_are_the_jax_tests():
    """The port's flow runs at tests/test_nested_flow.py's sizes."""
    import test_nested_flow as jflow
    assert (nested_basin.NP, nested_basin.NC, nested_basin.NZ,
            nested_basin.NSTEPS, nested_basin.DX) == (
        jflow.NP, jflow.NC, jflow.NZ, jflow.NSTEPS, jflow.DX)
    assert nested_basin.child_config() == port_cfg(jflow._child_domain()[0])
    p = nested_basin.parent_config()
    assert (p.nx, p.ny, p.nz, p.ndtfast, p.dt) == (32, 32, 6, 20, 60.0)
