"""The PyTorch port's operators against the JAX package's, in float64 on
the CPU, at small shapes.  The same inputs, made with numpy from a seed,
go through both packages (the port's through roms_tpu_torch.bridge).

Tolerances: rtol 1e-12 on elementwise operators (the arithmetic is
transcribed operation by operation; only the libraries' rounding of the
same operations can differ), plus atol 1e-13 * scale where terms cancel
to near zero (momentum advection); atol 1e-11 * scale where the port's
sequential `torch.cumsum` replaces the JAX package's tree-order
`lax.associative_scan` (omega, prsgrd), where vertical sums are reordered
(set_huv1), or where a chain of sub-steps compounds round-off
(fast_loop).  scale = max(1, max|ref|)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from roms_tpu.config import AdvScheme, ModelConfig
from roms_tpu import grid as jgrid
from roms_tpu import vcoord as jvcoord
from roms_tpu.ops import advection as jadv
from roms_tpu.ops import barotropic as jbaro
from roms_tpu.ops import eos as jeos
from roms_tpu.ops import kinematics as jkin
from roms_tpu.ops import prsgrd as jprs
from roms_tpu.ops import vmix as jvmix
from roms_tpu.parallel import halo as jhalo
from roms_tpu.ops.weights import set_weights
from roms_tpu.state import zero_forcing as j_zero_forcing

from roms_tpu_torch import bridge
from roms_tpu_torch.config import AdvScheme as TAdvScheme
from roms_tpu_torch import vcoord as tvcoord
from roms_tpu_torch.ops import advection as tadv
from roms_tpu_torch.ops import barotropic as tbaro
from roms_tpu_torch.ops import eos as teos
from roms_tpu_torch.ops import kinematics as tkin
from roms_tpu_torch.ops import prsgrd as tprs
from roms_tpu_torch.ops import vmix as tvmix
from roms_tpu_torch.parallel import halo as thalo
from roms_tpu_torch.state import zero_forcing as t_zero_forcing

from torch_helpers import port_cfg

torch.set_num_threads(1)

NX, NY, NZ, NT = 12, 10, 6, 2
JY, IX = NY + 4, NX + 4
F64 = torch.float64
CPU = torch.device("cpu")


def _t(a):
    return torch.as_tensor(np.array(a), dtype=F64)


def _j(a):
    return jnp.asarray(np.asarray(a), jnp.float64)


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _close(got, ref, rtol=1e-12, scale_atol=None):
    g, r = _np(got), _np(ref)
    assert g.shape == r.shape
    atol = 0.0 if scale_atol is None else scale_atol * max(1.0, np.abs(r).max())
    np.testing.assert_allclose(g, r, rtol=rtol, atol=atol)


def _cfg(periodic=True, **kw):
    base = dict(nx=NX, ny=NY, nz=NZ, nt=NT, ew_periodic=periodic,
                ns_periodic=periodic)
    base.update(kw)
    return ModelConfig(**base)


def _grids(cfg, seed=0):
    """A random smooth grid built by the JAX package, and its port twin."""
    rng = np.random.default_rng(seed)
    h = 50.0 + 20.0 * rng.random((JY, IX))
    pm = 1e-3 * (1.0 + 0.1 * rng.random((JY, IX)))
    pn = 1e-3 * (1.0 + 0.1 * rng.random((JY, IX)))
    f = 1e-4 * (1.0 + 0.1 * rng.random((JY, IX)))
    rmask = (rng.random((JY, IX)) > 0.1).astype(np.float64)
    g = jgrid.build_grid(cfg, h, pm, pn, f, rmask)
    gd = {fl.name: (None if getattr(g, fl.name) is None
                    else np.asarray(getattr(g, fl.name)))
          for fl in dataclasses.fields(g)}
    return g, bridge.grid_from_numpy(gd, dtype=F64, device=CPU)


def _depths(jg, tg, cfg, seed=1):
    rng = np.random.default_rng(seed)
    zeta = 0.1 * rng.standard_normal((JY, IX))
    j = jvcoord.set_depth(_j(zeta), jg.h, jg.hinv, jg.cs_w, jg.cs_r,
                          cfg.hc, cfg.nz)
    t = tvcoord.set_depth(_t(zeta), tg.h, tg.hinv, tg.cs_w, tg.cs_r,
                          cfg.hc, cfg.nz)
    return j, t


# ---------------------------------------------------------------- halo
@pytest.mark.parametrize("dj,di", [(0, 1), (0, -1), (1, 0), (-2, 0),
                                   (-1, -1), (0, 0)])
def test_shift(dj, di):
    a = np.random.default_rng(2).standard_normal((3, JY, IX))
    np.testing.assert_array_equal(_np(thalo.shift(_t(a), dj, di)),
                                  _np(jhalo.shift(_j(a), dj, di)))


@pytest.mark.parametrize("ew,ns", [(True, True), (False, True),
                                   (True, False), (False, False)])
def test_halo_fills(ew, ns):
    a = np.random.default_rng(3).standard_normal((2, JY, IX))
    ta = _t(a)
    kept = ta.clone()
    got = thalo.mixed_fill(ta, 2, ew, ns)
    np.testing.assert_array_equal(_np(got),
                                  _np(jhalo.mixed_fill(_j(a), 2, ew, ns)))
    np.testing.assert_array_equal(_np(ta), _np(kept))   # input untouched
    if ew and ns:
        np.testing.assert_array_equal(_np(thalo.periodic_fill(ta, 2)),
                                      _np(jhalo.periodic_fill(_j(a), 2)))


# ---------------------------------------------------------------- grid
@pytest.mark.parametrize("curvgrid", [False, True])
def test_build_grid(curvgrid):
    cfg = _cfg(curvgrid=curvgrid)
    jg, tg = _grids(cfg)
    for fl in dataclasses.fields(tg):
        a, b = getattr(jg, fl.name), getattr(tg, fl.name)
        assert (a is None) == (b is None), fl.name
        if a is not None:
            _close(b, a, rtol=1e-13)


def test_set_depth():
    cfg = _cfg()
    jg, tg = _grids(cfg)
    j, t = _depths(jg, tg, cfg)
    for a, b in zip(j, t):
        _close(b, a, rtol=1e-13)


# ---------------------------------------------------------------- eos
@pytest.mark.parametrize("nonlin,salinity", [(False, False), (False, True),
                                             (True, False), (True, True)])
def test_rho_eos(nonlin, salinity):
    cfg = _cfg(nonlin_eos=nonlin, salinity=salinity)
    jg, tg = _grids(cfg)
    (zw, zr, hz), (tzw, tzr, thz) = _depths(jg, tg, cfg)
    rng = np.random.default_rng(4)
    t = np.stack([10.0 + 5.0 * rng.random((NZ, JY, IX)),
                  34.0 + rng.random((NZ, JY, IX))])
    ref = jeos.rho_eos(_j(t), zr, zw, hz, jg.rmask, cfg, need_bvf=True)
    got = teos.rho_eos(_t(t), tzr, tzw, thz, tg.rmask, cfg, need_bvf=True)
    for name in ref._fields:
        a, b = getattr(ref, name), getattr(got, name)
        assert (a is None) == (b is None), name
        if a is not None:
            _close(b, a)


# ---------------------------------------------------------------- kinematics
def _uv(seed=5):
    rng = np.random.default_rng(seed)
    return 0.1 * rng.standard_normal((NZ, JY, IX)), \
        0.1 * rng.standard_normal((NZ, JY, IX))


@pytest.mark.parametrize("first_step", [True, False])
def test_set_huv_and_set_huv1(first_step):
    cfg = _cfg()
    jg, tg = _grids(cfg)
    (_, _, hz), (_, _, thz) = _depths(jg, tg, cfg)
    u, v = _uv()
    for a, b in zip(jkin.set_huv(_j(u), _j(v), hz, jg),
                    tkin.set_huv(_t(u), _t(v), thz, tg)):
        _close(b, a)
    rng = np.random.default_rng(6)
    avg = [rng.standard_normal((JY, IX)) for _ in range(6)]
    ref = jkin.set_huv1(_j(u), _j(v), hz, *[_j(a) for a in avg], jg, cfg,
                        first_step)
    got = tkin.set_huv1(_t(u), _t(v), thz, *[_t(a) for a in avg], tg, cfg,
                        first_step)
    for a, b in zip(ref, got):
        _close(b, a, rtol=0, scale_atol=1e-11)


@pytest.mark.parametrize("periodic", [True, False])
def test_omega(periodic):
    cfg = _cfg(periodic=periodic)
    jg, tg = _grids(cfg)
    (zw, _, hz), (tzw, _, thz) = _depths(jg, tg, cfg)
    u, v = _uv()
    fu, fv = jkin.set_huv(_j(u), _j(v), hz, jg)
    swflx = 1e-7 * np.random.default_rng(7).standard_normal((JY, IX))
    ref = jkin.omega(fu, fv, zw, hz, _j(swflx), jg, 3.0, cfg)
    got = tkin.omega(_t(fu), _t(fv), tzw, thz, _t(swflx), tg, 3.0, cfg)
    for a, b in zip(ref, got):
        _close(b, a, rtol=0, scale_atol=1e-11)


# ---------------------------------------------------------------- prsgrd
@pytest.mark.parametrize("nonlin", [False, True])
def test_prsgrd(nonlin):
    cfg = _cfg(nonlin_eos=nonlin, salinity=True)
    jg, tg = _grids(cfg)
    (zw, zr, hz), (tzw, tzr, thz) = _depths(jg, tg, cfg)
    rng = np.random.default_rng(8)
    t = np.stack([10.0 + 5.0 * rng.random((NZ, JY, IX)),
                  34.0 + rng.random((NZ, JY, IX))])
    je = jeos.rho_eos(_j(t), zr, zw, hz, jg.rmask, cfg)
    te = teos.rho_eos(_t(t), tzr, tzw, thz, tg.rmask, cfg)
    ref = jprs.prsgrd(je.rho, je.rho1, je.qp1, zr, zw, hz, jg, cfg)
    got = tprs.prsgrd(te.rho, te.rho1, te.qp1, tzr, tzw, thz, tg, cfg)
    for a, b in zip(ref, got):
        _close(b, a, rtol=0, scale_atol=1e-11)


# ---------------------------------------------------------------- advection
@pytest.mark.parametrize("scheme", list(AdvScheme))
@pytest.mark.parametrize("periodic", [True, False])
def test_horiz_tracer_flux(scheme, periodic):
    cfg = _cfg(periodic=periodic)
    jg, tg = _grids(cfg)
    rng = np.random.default_rng(9)
    tk = 10.0 + rng.standard_normal((NT, NZ, JY, IX))
    fu = 0.1 * rng.standard_normal((NZ, JY, IX))
    fv = 0.1 * rng.standard_normal((NZ, JY, IX))
    ref = jadv.horiz_tracer_flux(_j(tk), _j(fu), _j(fv), jg, cfg, scheme)
    got = tadv.horiz_tracer_flux(_t(tk), _t(fu), _t(fv), tg, port_cfg(cfg),
                                 TAdvScheme[scheme.name])
    for a, b in zip(ref, got):
        _close(b, a)


@pytest.mark.parametrize("scheme", [AdvScheme.UPSTREAM3,
                                    AdvScheme.CENTERED4])
@pytest.mark.parametrize("periodic", [True, False])
def test_momentum_advection(scheme, periodic):
    cfg = _cfg(periodic=periodic, curvgrid=True)
    jg, tg = _grids(cfg)
    (zw, _, hz), (_, _, thz) = _depths(jg, tg, cfg)
    u, v = _uv()
    fu, fv = jkin.set_huv(_j(u), _j(v), hz, jg)
    for a, b in zip(jadv.coriolis_rhs(_j(u), _j(v), hz, jg, cfg),
                    tadv.coriolis_rhs(_t(u), _t(v), thz, tg, cfg)):
        _close(b, a)
    for a, b in zip(
            jadv.horiz_uv_adv_rhs(_j(u), _j(v), fu, fv, jg, cfg, scheme),
            tadv.horiz_uv_adv_rhs(_t(u), _t(v), _t(fu), _t(fv), tg,
                                  port_cfg(cfg), TAdvScheme[scheme.name])):
        _close(b, a, scale_atol=1e-13)


@pytest.mark.parametrize("masking", [True, False])
def test_vertical_splines(masking):
    cfg = _cfg(masking=masking)
    jg, tg = _grids(cfg)
    (_, _, hz), (_, _, thz) = _depths(jg, tg, cfg)
    rng = np.random.default_rng(10)
    tk = 10.0 + rng.standard_normal((NT, NZ, JY, IX))
    we = 0.05 * rng.standard_normal((NZ + 1, JY, IX))
    u, v = _uv()
    ref = np.stack([np.asarray(jadv.vert_tracer_flux_spline(
        _j(tk[i]), hz, _j(we))) for i in range(NT)])
    _close(tadv.vert_tracer_flux_spline(_t(tk), thz, _t(we)), ref)
    for q, mask, st in ((u, "umask", "u"), (v, "vmask", "v")):
        ref = jadv.vert_uv_rhs_spline(_j(q), hz, _j(we), getattr(jg, mask),
                                      jg, cfg, st)
        got = tadv.vert_uv_rhs_spline(_t(q), thz, _t(we), getattr(tg, mask),
                                      tg, cfg, st)
        _close(got, ref, scale_atol=1e-13)


# ---------------------------------------------------------------- vmix
@pytest.mark.parametrize("apply_mask", [True, False])
def test_tracer_implicit_all(apply_mask):
    cfg = _cfg(salinity=True)
    jg, tg = _grids(cfg)
    rng = np.random.default_rng(11)
    t_rhs = 50.0 + rng.standard_normal((NT, NZ, JY, IX))
    hz = 5.0 + 0.5 * rng.random((NZ, JY, IX))
    akt = 1e-3 + 5e-4 * rng.random((2, NZ + 1, JY, IX))
    wi = 0.05 * rng.standard_normal((NZ + 1, JY, IX))
    pmn = jg.pm * jg.pn
    ref = jvmix.tracer_implicit_all(
        _j(t_rhs), _j(hz), jvmix.gather_akt(_j(akt), cfg), _j(wi), pmn,
        60.0, jg.rmask, cfg, apply_mask=apply_mask)
    got = tvmix.tracer_implicit_all(
        _t(t_rhs), _t(hz), tvmix.gather_akt(_t(akt), cfg), _t(wi),
        tg.pm * tg.pn, 60.0, tg.rmask, cfg, apply_mask=apply_mask)
    _close(got, ref)


@pytest.mark.parametrize("zob", [1e-2, 0.0])
def test_bottom_drag(zob):
    cfg = _cfg(zob=zob, rdrg=3e-4)
    jg, tg = _grids(cfg)
    (_, _, hz), (_, _, thz) = _depths(jg, tg, cfg)
    u, v = _uv()
    _close(tvmix.bottom_drag(_t(u), _t(v), thz, cfg),
           jvmix.bottom_drag(_j(u), _j(v), hz, cfg))


# ---------------------------------------------------------------- barotropic
def test_fast_loop():
    cfg = _cfg(ndtfast=10, dt=20.0)
    jg, tg = _grids(cfg)
    rng = np.random.default_rng(12)

    def r(scale):
        return jhalo.periodic_fill(_j(scale * rng.standard_normal((JY, IX))))

    zeta, ubar, vbar = r(0.05), r(0.05), r(0.05)
    rufrc, rvfrc = r(1e-2), r(1e-2)
    rho_s, rho_a = r(1e-3), r(1e-3)
    avg = [r(1.0) for _ in range(4)]
    jfrc = j_zero_forcing(cfg).replace(swflx=r(1e-7))
    tfrc = t_zero_forcing(cfg, F64, CPU).replace(swflx=_t(jfrc.swflx))
    w1, w2, _ = set_weights(cfg.ndtfast)
    ref = jbaro.fast_loop(zeta, ubar, vbar, rufrc, rvfrc, rho_s, rho_a,
                          jfrc, *avg, _j(w1), _j(w2), jg, cfg,
                          jhalo.make_halo_fill(cfg))
    got = tbaro.fast_loop(*[_t(a) for a in (zeta, ubar, vbar, rufrc, rvfrc,
                                            rho_s, rho_a)],
                          tfrc, *[_t(a) for a in avg], w1, w2, tg, cfg,
                          thalo.make_halo_fill(cfg))
    assert set(got) == set(ref)
    for k in ref:
        _close(got[k], ref[k], rtol=0, scale_atol=1e-11)
