"""The port's rotated (isoneutral) biharmonic on the CPU, in float64:

(a) `slope_fields` and the batched `isoneutral_increment` (three tracers
    in one pass) against roms_tpu.ops.isoneutral (its increment vmapped
    over the tracers, as roms_tpu/stepper.py does) on
    tests/test_isoneutral.py's stratified 16x16x8 basin, with velocities
    from a seeded numpy generator: every slope field, the increment and
    Akz at atol 1e-10 * max(1, max|ref|); with the linear EOS, SW_TRIADS
    and STABILIZE, and with the nonlinear EOS, KPP boundary layers and
    neither option;
(b) 3 steps of the open basin at 16x16x8 with the operator, the tracer
    budget and the upscale capture on (the batched tracer branch) against
    roms_tpu.stepper.step: every state field, budget term and boundary
    strip at atol 5e-11 * max(1, max|ref|);
(c) tests/test_isoneutral.py's invariants on the port: 6 steps conserve
    the tracer content (rtol 1e-11) and dissipate its variance beyond the
    run without the operator, and a uniform tracer stays untouched.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from roms_tpu.cases import obc_basin as jbasin
from roms_tpu.ops import eos as jeos
from roms_tpu.ops import isoneutral as jiso
from roms_tpu.parallel.halo import make_halo_fill as jhalo

from roms_tpu_torch import bridge
from roms_tpu_torch.cases import obc_basin as tbasin
from roms_tpu_torch.driver import run
from roms_tpu_torch.ops import isoneutral
from roms_tpu_torch.parallel.halo import make_halo_fill

from torch_helpers import (F64, assert_state_close, np_tree, port_cfg,
                           run_jax, run_port)

torch.set_num_threads(1)

TOL = 1e-10


def _stratified(st, grid):
    """tests/test_isoneutral.py's stratified T with a horizontal anomaly."""
    z = np.asarray(st.z_r)
    x = np.asarray(grid.xr)
    return 14.0 + 8.0 * np.exp(z / 50.0) \
        + 0.5 * np.sin(2 * np.pi * x / 16000.0)[None]


def _config(iso=True, ntimes=6):
    return jbasin.config("closed", ntimes=ntimes).replace(
        nx=16, ny=16, nz=8, dt=60.0, ndtfast=20,
        adv_isoneutral=iso, sw_triads=True, stabilize=True)


@pytest.fixture(scope="module")
def inputs():
    cfg = _config()
    jg, jst, _ = jbasin.setup(cfg)
    t0 = _stratified(jst, jg)
    rng = np.random.default_rng(5)
    shape = t0.shape
    return dict(
        cfg=cfg, grid=jg, st=jst, t0=t0,
        u=0.1 * rng.standard_normal(shape),
        v=0.1 * rng.standard_normal(shape),
        hbls=20.0 + 60.0 * rng.random(shape[1:]),
        hbbl=10.0 + 40.0 * rng.random(shape[1:]),
        tracers=t0[None] * (1.0 + 0.01 * rng.standard_normal((3,) + shape)))


def _close(got, ref, what):
    ref = np.asarray(ref)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0,
                               atol=TOL * max(1.0, np.abs(ref).max()),
                               err_msg=what)


@pytest.mark.parametrize("variant", ["linear_triads_stabilize",
                                     "nonlinear_kpp_plain"])
def test_slopes_and_increment_match_jax(inputs, variant):
    cfg = inputs["cfg"]
    if variant == "nonlinear_kpp_plain":
        cfg = cfg.replace(nonlin_eos=True, lmd_kpp=True, sw_triads=False,
                          stabilize=False)
    jg, jst = inputs["grid"], inputs["st"]
    t = jnp.asarray(inputs["t0"])[None]
    e = jeos.rho_eos(t, jst.z_r, jst.z_w, jst.hz, jg.rmask, cfg)
    args = dict(rho=e.rho, rho1=e.rho1, qp1=e.qp1, z_r=jst.z_r,
                z_w=jst.z_w, hz=jst.hz, hbls=inputs["hbls"],
                hbbl=inputs["hbbl"], u_new=inputs["u"], v_new=inputs["v"])
    jargs = {k: None if v is None else jnp.asarray(v)
             for k, v in args.items()}
    targs = {k: None if v is None else torch.as_tensor(np.array(v),
                                                         dtype=F64)
             for k, v in args.items()}
    tg = bridge.grid_from_numpy(np_tree(jg), dtype=F64, device="cpu")
    tcfg = port_cfg(cfg)

    ref = jiso.slope_fields(**jargs, grid=jg, cfg=cfg)
    got = isoneutral.slope_fields(**targs, grid=tg, cfg=tcfg)
    for name in ref._fields:
        _close(getattr(got, name), getattr(ref, name), name)

    T = inputs["tracers"]
    halo = jhalo(cfg)
    incr_ref, akz_ref = jax.vmap(
        lambda tk: jiso.isoneutral_increment(tk, ref, jargs["hz"],
                                             jargs["z_r"], jg, cfg, halo),
        out_axes=(0, None))(jnp.asarray(T))
    incr, akz = isoneutral.isoneutral_increment(
        torch.as_tensor(T), got, targs["hz"], targs["z_r"], tg, tcfg,
        make_halo_fill(tcfg))
    assert float(np.abs(np.asarray(incr_ref)).max()) > 0.0
    _close(incr, incr_ref, "increment")
    if cfg.stabilize:
        assert float(np.abs(np.asarray(akz_ref)).max()) > 0.0
        _close(akz, akz_ref, "akz")
    else:
        assert akz is None and akz_ref is None


def test_step_matches_jax():
    cfg = jbasin.config("radiating").replace(
        nx=16, ny=16, nz=8, ndtfast=20, adv_isoneutral=True,
        sw_triads=True, stabilize=True, tracer_diagnostics=True,
        upscale_output=True)
    jg, jst, jfrc = jbasin.setup(cfg)
    t = jst.t.at[0].set(jnp.asarray(_stratified(jst, jg)))
    jst = jst.replace(t=t, t_prev=t)
    ref = run_jax(cfg, jg, jst, jfrc)
    got = run_port(cfg, jg, jst, jfrc)
    assert set(got["upscale"]) == {"west", "east", "south", "north"}
    assert_state_close(got, ref, 5e-11)


def _setup(iso, ntimes=6):
    cfg = port_cfg(_config(iso, ntimes))
    grid, st, forcing = tbasin.setup(cfg, device="cpu")
    t = st.t.clone()
    t[0] = torch.as_tensor(_stratified(st, grid))
    return cfg, grid, st.replace(t=t, t_prev=t), forcing


def _content_var(st, cfg):
    h = cfg.halo
    hz = st.hz[:, h:-h, h:-h].numpy()
    t = st.t[0, :, h:-h, h:-h].numpy()
    c = np.sum(t * hz)
    mean = c / hz.sum()
    return c, np.sum((t - mean) ** 2 * hz)


def test_isoneutral_conserves_and_dissipates():
    cfg, grid, st, forcing = _setup(True)
    c0, _ = _content_var(st, cfg)
    st_iso, rows = run(grid, st, forcing, cfg)
    assert np.isfinite(rows[:, 1]).all()
    c1, v1 = _content_var(st_iso, cfg)
    np.testing.assert_allclose(c1, c0, rtol=1e-11)

    cfg_n, grid_n, st_n, forcing_n = _setup(False)
    st_ref, _ = run(grid_n, st_n, forcing_n, cfg_n)
    _, v_ref = _content_var(st_ref, cfg_n)
    assert v1 < v_ref
    assert float((st_iso.t[0] - st_ref.t[0]).abs().max()) > 1e-7


def test_isoneutral_uniform_tracer_untouched():
    cfg, grid, st, forcing = _setup(True, ntimes=3)
    t = torch.full_like(st.t, 5.0)
    st_end, _ = run(grid, st.replace(t=t, t_prev=t), forcing, cfg)
    h = cfg.halo
    np.testing.assert_allclose(st_end.t[0, :, h:-h, h:-h].numpy(), 5.0,
                               rtol=1e-12)
