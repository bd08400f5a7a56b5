"""The port's non-hydrostatic projection on the CPU, in float64:

(a) `nh_solve` against roms_tpu.nhmg.nh_solve on tests/test_nhmg.py's
    seamount at 16x16x8 with a seeded random trial (u, v, w), with the
    sigma-slope terms on and off: p, u, v and w at atol
    1e-9 * max(1, max|ref|), res and res0 at rtol 1e-6.  The solves run
    NH_ITERS iterations: beyond about 25 on this seamount the JAX
    package's own PCG amplifies round-off (its residual after 40
    iterations moves by 8.8e-4 relative with the sigma terms, 0.13
    without, when one value of u moves by one ulp), so no two orders of
    summation agree there to these tolerances.  At the step's default 40
    iterations the port is held to 4 times the distance between two runs
    of the JAX package's own solve that differ only in XLA's fusion (under
    `jax.jit` and not), quantity by quantity;
(b) the hand-written adjoint `_gradient_t`: <G x, y> = <x, G^T y> to
    1e-13 relative, and G^T y equal to the JAX package's
    `jax.linear_transpose` of its gradient; the face coefficients, the
    gradient, the orthogonal operator `_apply` and the line
    preconditioner against the JAX package's;
(c) the port's projection converges on the seamount and leaves a
    non-divergent field alone (tests/test_nhmg.py's checks);
(d) 3 steps of obc_basin 16x16x6 with non_hydrostatic (and the momentum
    budget, which reads the projected velocities) against
    roms_tpu.stepper.step, every state field and budget term at atol
    5e-11 * max(1, max|ref|).
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from roms_tpu import nhmg as jnhmg
from roms_tpu.cases import obc_basin as jbasin
from roms_tpu.config import ModelConfig as JModelConfig

from roms_tpu_torch import nhmg

from torch_helpers import assert_state_close, port_cfg, run_jax, run_port

torch.set_num_threads(1)


def _seamount(nx=16, ny=16, nz=8):
    """tests/test_nhmg.py's seamount (Lx = Ly = 10 km, a Gaussian seamount
    rising 2.5 km from 4 km), as numpy arrays."""
    cfg = JModelConfig(nx=nx, ny=ny, nz=nz, nt=1, masking=False,
                       ew_periodic=False, ns_periodic=False)
    jy, ix = ny + 4, nx + 4
    L = 1.0e4
    dx = L / nx
    x = dx * (np.arange(ix) - 1.5)[None, :]
    y = dx * (np.arange(jy) - 1.5)[:, None]
    h = 4000.0 - 2500.0 * np.exp(-((x - L / 2) ** 2 + (y - L / 2) ** 2)
                                 / (L / 5) ** 2)
    zw = h[None] * np.linspace(-1.0, 0.0, nz + 1)[:, None, None]
    hz = zw[1:] - zw[:-1]
    z_r = 0.5 * (zw[1:] + zw[:-1])
    pm = np.full((jy, ix), 1.0 / dx)
    return cfg, hz, z_r, pm, pm.copy()


def _trial(hz, seed=3):
    rng = np.random.default_rng(seed)
    nz, jy, ix = hz.shape
    return (0.1 * rng.standard_normal(hz.shape),
            0.1 * rng.standard_normal(hz.shape),
            1e-3 * rng.standard_normal((nz + 1, jy, ix)))


def _t(*a):
    return [torch.as_tensor(x) for x in a]


GRID = types.SimpleNamespace(umask=None, vmask=None)
# PCG iterations of the comparison with the JAX package: the residual
# falls to 3.4e-3 (sigma terms) and 3.0e-3 (without) of its start, and a
# one-ulp change of the input moves the JAX package's own result by at
# most 2e-13 relative
NH_ITERS = 20


@pytest.mark.parametrize("sigma", [True, False])
def test_nh_solve_matches_jax(sigma):
    cfg, hz, z_r, pm, pn = _seamount()
    cfg = cfg.replace(nh_sigma_terms=sigma)
    u, v, w = _trial(hz)
    ref = jnhmg.nh_solve(*map(jnp.asarray, (u, v, w, hz, z_r, pm, pn)),
                         GRID, cfg, n_iter=NH_ITERS)
    got = nhmg.nh_solve(*_t(u, v, w, hz, z_r, pm, pn), GRID, port_cfg(cfg),
                        n_iter=NH_ITERS)
    for name in ("p", "u", "v", "w"):
        a = np.asarray(getattr(ref, name))
        np.testing.assert_allclose(getattr(got, name).numpy(), a, rtol=0,
                                   atol=1e-9 * max(1.0, np.abs(a).max()),
                                   err_msg=name)
    for name in ("res0", "res"):
        np.testing.assert_allclose(float(getattr(got, name)),
                                   float(getattr(ref, name)), rtol=1e-6,
                                   err_msg=name)
    assert float(got.res) < 1e-2 * float(got.res0)


def _distance(got, ref):
    """res/res0 relative, and p, u, v, w in max|diff| / max(1, max|ref|),
    of two NHResults as numpy arrays."""
    ratio = float(ref["res"] / ref["res0"])
    out = {"res/res0": abs(float(got["res"] / got["res0"]) - ratio) / ratio}
    for name in ("p", "u", "v", "w"):
        out[name] = float(np.abs(got[name] - ref[name]).max()
                          / max(1.0, np.abs(ref[name]).max()))
    return out


@pytest.mark.parametrize("sigma", [True, False])
def test_nh_solve_default_iterations_match_jax(sigma):
    """At the default nh_iters (40) the JAX package's own result moves by
    up to 0.3 in res/res0 and 5e-5 * scale in p between its solve under
    `jax.jit` and without; the port stays within 4 times that, quantity by
    quantity (and within the 20-iteration tolerances where the JAX
    package's two runs agree closer than those), and both solves cut the
    residual below 1e-3 of its start."""
    cfg, hz, z_r, pm, pn = _seamount()
    cfg = cfg.replace(nh_sigma_terms=sigma)
    assert cfg.nh_iters == 40
    u, v, w = _trial(hz)
    args = list(map(jnp.asarray, (u, v, w, hz, z_r, pm, pn)))

    def fields(r):
        return {k: np.asarray(getattr(r, k))
                for k in ("p", "u", "v", "w", "res", "res0")}

    ref = fields(jnhmg.nh_solve(*args, GRID, cfg))
    fused = fields(jax.jit(lambda *a: jnhmg.nh_solve(*a, GRID, cfg))(*args))
    got = fields(nhmg.nh_solve(*_t(u, v, w, hz, z_r, pm, pn), GRID,
                               port_cfg(cfg)))
    own, port = _distance(fused, ref), _distance(got, ref)
    floor = {"res/res0": 1e-6, "p": 1e-9, "u": 1e-9, "v": 1e-9, "w": 1e-9}
    for name, d in port.items():
        assert d <= max(4.0 * own[name], floor[name]), (name, d, own[name])
    for r in (ref, got):
        assert float(r["res"]) < 1e-3 * float(r["res0"])


@pytest.mark.parametrize("sigma", [True, False])
def test_gradient_adjoint(sigma):
    cfg, hz, z_r, pm, pn = _seamount()
    cfg = cfg.replace(nh_sigma_terms=sigma)
    rng = np.random.default_rng(11)
    x = rng.standard_normal(hz.shape)
    ys = (rng.standard_normal(hz.shape), rng.standard_normal(hz.shape),
          rng.standard_normal((hz.shape[0] + 1,) + hz.shape[1:]))
    geo = nhmg._geometry(*_t(hz, z_r, pm, pn), None, None, port_cfg(cfg))
    gx = nhmg._gradient(torch.as_tensor(x), geo)
    gty = nhmg._gradient_t(*_t(*ys), geo)
    lhs = sum(float(torch.sum(g * y)) for g, y in zip(gx, _t(*ys)))
    rhs = float(torch.sum(torch.as_tensor(x) * gty))
    assert abs(lhs - rhs) <= 1e-13 * max(abs(lhs), abs(rhs))

    jgeo = jnhmg._geometry(*map(jnp.asarray, (hz, z_r, pm, pn)), None,
                           None, cfg)
    gt_fn = jax.linear_transpose(lambda q: jnhmg._gradient(q, jgeo),
                                 jnp.zeros_like(jnp.asarray(hz)))
    (ref,) = gt_fn(tuple(map(jnp.asarray, ys)))
    ref = np.asarray(ref)
    np.testing.assert_allclose(gty.numpy(), ref, rtol=0,
                               atol=1e-13 * np.abs(ref).max())


@pytest.mark.parametrize("sigma", [True, False])
def test_operator_pieces_match_jax(sigma):
    """The geometry, the gradient, the orthogonal operator `_apply` and
    the line preconditioner against the JAX package's on a seeded field,
    at 1e-13 * max(1, max|ref|)."""
    cfg, hz, z_r, pm, pn = _seamount()
    cfg = cfg.replace(nh_sigma_terms=sigma)
    x = np.random.default_rng(5).standard_normal(hz.shape)
    geo = nhmg._geometry(*_t(hz, z_r, pm, pn), None, None, port_cfg(cfg))
    jgeo = jnhmg._geometry(*map(jnp.asarray, (hz, z_r, pm, pn)), None,
                           None, cfg)
    coef = ("au", "av", "aw_int", "aw_top", "cell")
    pairs = [(getattr(geo, k), getattr(jgeo, k)) for k in coef]
    pairs += list(zip(nhmg._gradient(torch.as_tensor(x), geo),
                      jnhmg._gradient(jnp.asarray(x), jgeo)))
    pairs.append((nhmg._apply(torch.as_tensor(x),
                              *[getattr(geo, k) for k in coef]),
                  jnhmg._apply(jnp.asarray(x),
                               *[getattr(jgeo, k) for k in coef])))
    pairs.append((nhmg._line_precond(torch.as_tensor(x),
                                     *[getattr(geo, k) for k in coef]),
                  jnhmg._line_precond(jnp.asarray(x),
                                      *[getattr(jgeo, k) for k in coef])))
    for i, (got, ref) in enumerate(pairs):
        ref = np.asarray(ref)
        np.testing.assert_allclose(got.numpy(), ref, rtol=0,
                                   atol=1e-13 * max(1.0, np.abs(ref).max()),
                                   err_msg=str(i))


def test_seamount_projection_converges():
    cfg, hz, z_r, pm, pn = _seamount()
    tcfg = port_cfg(cfg)
    u, v, w = _trial(hz)
    res = nhmg.nh_solve(*_t(u, v, w, hz, z_r, pm, pn), GRID, tcfg,
                        n_iter=160)
    assert float(res.res) < 1e-6 * float(res.res0)
    div = nhmg.divergence(res.u, res.v, res.w, *_t(hz, pm, pn), tcfg,
                          z_r=torch.as_tensor(z_r))
    assert float(div.abs().max()) < 1e-6 * float(res.res0)


def test_projection_leaves_divfree_flow_alone():
    cfg, hz, z_r, pm, pn = _seamount()
    z = np.zeros_like(hz)
    w = np.zeros((hz.shape[0] + 1,) + hz.shape[1:])
    res = nhmg.nh_solve(*_t(z, z, w, hz, z_r, pm, pn), GRID, port_cfg(cfg),
                        n_iter=10)
    assert float(res.u.abs().max()) == 0.0
    assert float(res.w.abs().max()) == 0.0


def test_nh_step_matches_jax():
    cfg = jbasin.config("radiating").replace(
        nx=16, ny=16, nz=6, ndtfast=20, non_hydrostatic=True,
        uv_diagnostics=True)
    jg, jst, jfrc = jbasin.setup(cfg)
    ref = run_jax(cfg, jg, jst, jfrc)
    got = run_port(cfg, jg, jst, jfrc)
    assert_state_close(got, ref, 5e-11)
