"""The port's kernel modules against the JAX package's Pallas kernels.

On the CPU `cuda_tracer.tracer_stage`, `cuda_solve.momentum_implicit`
and `cuda_uv_rhs.uv_rhs` take their plain PyTorch versions (a CPU tensor
never reaches a kernel); the Pallas kernels run in interpret mode, as
tests/test_pallas_*.py run them, and the momentum r.h.s. is held to the
JAX package's `stepper._uv_rhs`, ghost lines included.  Inputs are the random harnesses of those files, made with numpy
from a seed (`roms_tpu_torch.ops._harness`).  Tolerance rtol = atol =
1e-12 in float64, the bound of tests/test_pallas_*.py; the CUDA kernels themselves are held to their
plain versions on the card by chip_smoke.py (nvcc contracts a*b+c into
FMA there, which moves the last bit, inside the same bound).  Off a fully
periodic grid the outermost ghost lines are excluded, the rule of
tests/test_pallas_tracer.py:_close.
"""

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from roms_tpu import stepper as jstepper
from roms_tpu.config import AdvScheme
from roms_tpu.ops import pallas_solve, pallas_tracer

from roms_tpu_torch.config import AdvScheme as TAdvScheme
from roms_tpu_torch.ops import (_build, _harness, cuda_solve, cuda_tracer,
                                cuda_uv_rhs)

from torch_helpers import jax_cfg

torch.set_num_threads(1)

NX, NY, NZ, NT = 24, 18, 10, 3          # tests/test_pallas_tracer.py shapes
JY, IX = NY + 4, NX + 4


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    # pallas_solve imports _INTERPRET by value: patch both modules
    monkeypatch.setattr(pallas_tracer, "_INTERPRET", True)
    monkeypatch.setattr(pallas_solve, "_INTERPRET", True)


def _tracer_inputs(periodic=False):
    return _harness.tracer_inputs(NX, NY, NZ, NT, periodic=periodic)


def _both(name, d):
    """The same numpy inputs as (jnp arrays, torch tensors)."""
    return (jnp.asarray(d[name], jnp.float64),
            torch.as_tensor(np.array(d[name]), dtype=torch.float64))


def _run_both(cfg, d, hz_b, scheme, dtau, c_tk, c_sec, apply_mask, mode,
              stflx=False, mix=None):
    names = ("tk", "t_sec", "flx_u", "flx_v", "hz_n", hz_b, "we", "wi",
             "akt", "pmn", "rmask", "umask", "vmask")
    j = [_both(n, d)[0] for n in names]
    t = [_both(n, d)[1] for n in names]
    jkw, tkw = {}, {}
    if stflx:
        jkw["stflx"], tkw["stflx"] = _both("stflx", d)
    if mix is not None:
        jkw["mix"] = {k: jnp.asarray(v, jnp.float64) for k, v in mix.items()}
        tkw["mix"] = {k: torch.as_tensor(np.array(v), dtype=torch.float64)
                      for k, v in mix.items()}
    args = (dtau, c_tk, c_sec, apply_mask, mode)
    ref = pallas_tracer.tracer_stage(*j, jax_cfg(cfg), scheme, *args, **jkw)
    before = _build.kernel_stats["tracer_stage"]["launches"]
    got = cuda_tracer.tracer_stage(*t, cfg, TAdvScheme[scheme.name], *args,
                                   **tkw)
    # CPU: no launch
    assert _build.kernel_stats["tracer_stage"]["launches"] == before
    return got.numpy(), np.asarray(ref)


def _close(got, ref, cfg):
    sl = (Ellipsis,) if cfg.fully_periodic else (
        Ellipsis, slice(1, -1), slice(1, -1))
    np.testing.assert_allclose(got[sl], ref[sl], rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("scheme", [AdvScheme.UPSTREAM3,
                                    AdvScheme.CENTERED4, AdvScheme.AKIMA])
def test_corrector_stage_matches_pallas(scheme):
    cfg, d = _tracer_inputs()
    got, ref = _run_both(cfg, d, "hz_new", scheme, 60.0, 0.0, 1.0, True,
                         "corr", stflx=True)
    _close(got, ref, cfg)


@pytest.mark.parametrize("periodic", [False, True])
def test_predictor_stage_matches_pallas(periodic):
    cfg, d = _tracer_inputs(periodic=periodic)
    got, ref = _run_both(cfg, d, "hz_d", AdvScheme.CENTERED4, 50.0,
                         0.5 + 1.0 / 6.0, 0.5 - 1.0 / 6.0, False, "pred")
    _close(got, ref, cfg)


def test_nondivisible_jy():
    """jy = 22 is a multiple of no block size, on either device."""
    cfg, d = _tracer_inputs()
    assert JY % pallas_tracer.BJ != 0
    got, ref = _run_both(cfg, d, "hz_new", AdvScheme.UPSTREAM3, 60.0, 0.0,
                         1.0, True, "corr")
    _close(got, ref, cfg)


def test_corrector_with_fused_t3dmix_matches_pallas():
    cfg, d = _tracer_inputs()
    mix = {k: d[k] for k in ("diff2", "pmon_u", "pnom_v")}
    got, ref = _run_both(cfg, d, "hz_new", AdvScheme.UPSTREAM3, 60.0, 0.0,
                         1.0, True, "corr", stflx=True, mix=mix)
    _close(got, ref, cfg)


def test_mix_is_a_corrector_option():
    cfg, d = _tracer_inputs()
    t = {k: torch.as_tensor(np.array(v)) for k, v in d.items()}
    with pytest.raises(ValueError):
        cuda_tracer.tracer_stage(
            t["tk"], t["t_sec"], t["flx_u"], t["flx_v"], t["hz_n"],
            t["hz_d"], t["we"], t["wi"], t["akt"], t["pmn"], t["rmask"],
            t["umask"], t["vmask"], cfg, TAdvScheme.CENTERED4, 50.0, 1.0,
            0.0, False, "pred",
            mix={"diff2": t["stflx"], "pmon_u": t["pmn"], "pnom_v": t["pmn"]})


@pytest.mark.parametrize("drag", [True, False])
def test_momentum_solve_matches_pallas(drag):
    cfg, d = _harness.solve_inputs(NX, NY, NZ)
    names = ("rhs", "hzf", "akvf", "wif", "dc0")
    j = [_both(n, d)[0] for n in names]
    t = [_both(n, d)[1] for n in names]
    jd, td = _both("rd", d)
    js, ts = _both("sstr", d)
    ref = pallas_solve.momentum_implicit(
        *j, 200.0, js, jax_cfg(cfg), bottom_drag_coeff=jd if drag else None)
    before = _build.kernel_stats["momentum_solve"]["launches"]
    got = cuda_solve.momentum_implicit(
        *t, 200.0, ts, cfg, bottom_drag_coeff=td if drag else None)
    assert _build.kernel_stats["momentum_solve"]["launches"] == before
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-12,
                               atol=1e-12)


# (scheme, harness options, edge ownership (own_w, own_e, own_s, own_n)):
# each scheme with and without masking and the CURVGRID terms, doubly and
# singly periodic grids, a mesh block's partial ownership on the west and
# north edges and on the east and south, Coriolis alone, advection alone
UV_CASES = {
    "centered4": (AdvScheme.CENTERED4, {}, None),
    "upstream3": (AdvScheme.UPSTREAM3, {}, None),
    "akima_advects_as_centered4": (AdvScheme.AKIMA, {}, None),
    "centered4_periodic_plain": (
        AdvScheme.CENTERED4, dict(masking=False, curvgrid=False,
                                  ew_periodic=True, ns_periodic=True), None),
    "upstream3_periodic": (
        AdvScheme.UPSTREAM3, dict(ew_periodic=True, ns_periodic=True), None),
    "upstream3_ew_periodic_unmasked": (
        AdvScheme.UPSTREAM3, dict(masking=False, ew_periodic=True, seed=1),
        None),
    "upstream3_own_wn": (AdvScheme.UPSTREAM3, dict(seed=2),
                         (True, False, False, True)),
    "centered4_own_es": (AdvScheme.CENTERED4, dict(curvgrid=False, seed=3),
                         (False, True, True, False)),
    "coriolis_only": (AdvScheme.UPSTREAM3, dict(uv_adv=False), None),
    "advection_only": (AdvScheme.UPSTREAM3,
                       dict(uv_cor=False, curvgrid=False), None),
}


@pytest.mark.parametrize("case", sorted(UV_CASES))
def test_uv_rhs_matches_jax_stepper(case):
    """Five levels: the JAX chain runs op by op, its spline a Python loop
    over the levels (the card's tests take nz up to NZ_MAX)."""
    scheme, kw, own = UV_CASES[case]
    cfg, d = _harness.uv_rhs_inputs(NX, NY, NZ, **kw)
    own = own or (None,) * 4
    names = ("u", "v", "flx_u", "flx_v", "hz", "we")
    grids = [types.SimpleNamespace(
        **{k: _both(k, d)[n] for k in ("fomn", "dndx", "dmde", "umask",
                                       "vmask")},
        own_w=own[0], own_e=own[1], own_s=own[2], own_n=own[3])
        for n in (0, 1)]
    ref = jstepper._uv_rhs(*[_both(k, d)[0] for k in names], grids[0],
                           jax_cfg(cfg), scheme)
    stats = _build.kernel_stats["uv_rhs"]
    before = stats["launches"], stats["plain"]
    got = cuda_uv_rhs.uv_rhs(*[_both(k, d)[1] for k in names], grids[1],
                             cfg, TAdvScheme[scheme.name])
    # CPU: the plain version, no launch
    assert (stats["launches"], stats["plain"]) == (before[0], before[1] + 1)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-12,
                                   atol=1e-12)
