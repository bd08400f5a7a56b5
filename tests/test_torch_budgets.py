"""The port's budget diagnostics and vertical-velocity diagnostic on the
CPU, in float64:

(a) 3 steps of obc_basin 16x16x6 with the tracer and momentum budgets on
    together (visc2 and tnu2 on, so that every term is live) against
    roms_tpu.stepper.step: every state field and every budget term at
    atol 5e-11 * max(1, max|ref|);
(b) tests/test_budget.py's two closure checks on the port: the tracer
    budget closes, its vmix term telescopes to zero in a column and
    matches a per-cell reconstruction of the implicit operator; the
    momentum budget closes and its vmix term telescopes to dt*sustr;
(c) `ops.wvlcty.wvlcty` against roms_tpu.ops.wvlcty on the moving state
    of (a), and zero on a state at rest.
"""

import numpy as np
import pytest
import torch

from roms_tpu.cases import obc_basin as jbasin
from roms_tpu.ops.wvlcty import wvlcty as jwvlcty

from roms_tpu_torch import bridge
from roms_tpu_torch.cases import obc_basin as tbasin
from roms_tpu_torch.driver import run
from roms_tpu_torch.ops.wvlcty import wvlcty

from torch_helpers import (F64, assert_state_close, np_tree, port_cfg,
                           run_jax, run_port)

torch.set_num_threads(1)

TOL = 5e-11


@pytest.fixture(scope="module")
def both():
    """One JAX configuration with both budgets: its inputs, 3 steps of
    the JAX package and 3 of the port."""
    cfg = jbasin.config("radiating").replace(
        nx=16, ny=16, nz=6, ndtfast=20, visc2=5.0, tnu2=1.0,
        tracer_diagnostics=True, uv_diagnostics=True)
    jg, jst, jfrc = jbasin.setup(cfg)
    ref = run_jax(cfg, jg, jst, jfrc)
    got = run_port(cfg, jg, jst, jfrc)
    return cfg, jg, ref, got


def test_budgets_match_jax(both):
    _, _, ref, got = both
    assert set(got["t_budget"]) == {"hadv", "vadv", "forc", "vmix", "rate"}
    assert set(got["uv_budget"]["u"]) == {"pgr", "cori", "adv", "hmix",
                                          "vmix", "coup", "rate"}
    assert np.abs(got["uv_budget"]["u"]["hmix"]).max() > 0.0
    assert_state_close(got, ref, TOL)


def test_wvlcty_matches_jax(both):
    cfg, jg, ref, _ = both
    a = np.asarray(jwvlcty(ref.u, ref.v, ref.flx_u, ref.flx_v, ref.z_r, jg,
                           cfg))
    tg = bridge.grid_from_numpy(np_tree(jg), dtype=F64, device="cpu")
    tst = bridge.state_from_numpy(np_tree(ref), dtype=F64, device="cpu")
    b = wvlcty(tst.u, tst.v, tst.flx_u, tst.flx_v, tst.z_r, tg,
               port_cfg(cfg)).numpy()
    assert np.abs(a).max() > 0.0
    np.testing.assert_allclose(b, a, rtol=0,
                               atol=1e-13 * max(1.0, np.abs(a).max()))


def test_wvlcty_zero_at_rest():
    cfg = tbasin.config("closed").replace(nx=16, ny=16, nz=6)
    g, st, _ = tbasin.setup(cfg, device="cpu")
    w = wvlcty(st.u, st.v, st.flx_u, st.flx_v, st.z_r, g, cfg)
    assert w.shape == st.u.shape
    assert float(w.abs().max()) == 0.0


def test_tracer_budget_closure_and_vmix_reconstruction():
    cfg = tbasin.config("closed", ntimes=1).replace(
        nx=16, ny=16, nz=6, dt=60.0, ndtfast=20, tracer_diagnostics=True,
        akt_bak=0.0)
    grid, st, forcing = tbasin.setup(cfg, device="cpu")
    # stratified tracer and a constant diffusivity for the implicit solve
    t0 = 1.0 + 0.1 * torch.arange(cfg.nz, dtype=F64)[None, :, None, None] \
        * torch.ones_like(st.t)
    akt0 = 1e-3
    st = st.replace(t=t0, t_prev=t0, akt=torch.full_like(st.akt, akt0))
    st_end, _ = run(grid, st, forcing, cfg)

    b = {k: v.numpy() for k, v in st_end.t_budget.items()}
    assert set(b) == {"hadv", "vadv", "forc", "vmix", "rate"}
    np.testing.assert_allclose(b["hadv"] + b["vadv"] + b["forc"] + b["vmix"],
                               b["rate"], atol=1e-12)
    np.testing.assert_allclose(b["forc"], 0.0, atol=1e-10)
    # the solve's internal fluxes cancel and its ends are no-flux
    np.testing.assert_allclose(b["vmix"].sum(axis=1), 0.0, atol=1e-11)

    # per-cell reconstruction of the implicit operator from the solved
    # tracer, away from the edges (fcv = 2*dt*akt/(hz[k+1]+hz[k]))
    sl = (slice(None), slice(3, -3), slice(3, -3))
    t_new = st_end.t[0].numpy()[sl]
    hz = st_end.hz.numpy()[sl]
    wi = st_end.wi.numpy()[sl]
    pmn = (grid.pm * grid.pn).numpy()[3:-3, 3:-3]
    nz = cfg.nz
    fcv = 2.0 * cfg.dt * akt0 / (hz[1:] + hz[:-1])
    wcv = cfg.dt * pmn[None] * wi[1:nz]
    wcp, wcm = np.maximum(wcv, 0.0), np.minimum(wcv, 0.0)
    flux = fcv * (t_new[1:] - t_new[:-1]) - wcp * t_new[:-1] - wcm * t_new[1:]
    rec = np.zeros_like(t_new)
    rec[:-1] += flux
    rec[1:] -= flux
    got = b["vmix"][0][sl]
    scale = max(np.abs(got).max(), 1e-30)
    np.testing.assert_allclose(got, rec, atol=1e-10 * scale, rtol=0)


def test_momentum_budget_closure_and_stress_telescoping():
    cfg = tbasin.config("closed", ntimes=1).replace(
        nx=16, ny=16, nz=6, dt=60.0, ndtfast=20, uv_diagnostics=True,
        rdrg=0.0)
    grid, st, forcing = tbasin.setup(cfg, device="cpu")
    tau = 1e-4
    st = st.replace(akv=torch.full_like(st.akv, 1e-3))
    forcing = forcing.replace(sustr=torch.full_like(forcing.sustr, tau))
    st_end, _ = run(grid, st, forcing, cfg)

    b = st_end.uv_budget
    assert set(b) == {"u", "v"}
    for comp in ("u", "v"):
        terms = {k: v.numpy() for k, v in b[comp].items()}
        assert set(terms) == {"pgr", "cori", "adv", "hmix", "vmix", "coup",
                              "rate"}
        total = sum(terms[k] for k in ("pgr", "cori", "adv", "hmix", "vmix",
                                       "coup"))
        np.testing.assert_allclose(total, terms["rate"], atol=1e-12)
    # the u solve takes dt*sustr in its top cell and no drag at the bottom
    colsum = b["u"]["vmix"].numpy().sum(axis=0)[4:-4, 4:-4]
    np.testing.assert_allclose(colsum, cfg.dt * tau, rtol=1e-10)
    assert np.abs(b["u"]["pgr"].numpy()).max() > 0.0
