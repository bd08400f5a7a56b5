"""The port's KPP vertical mixing against the JAX package's, in float64 on
the CPU:

(a) each function of roms_tpu_torch/ops/kpp.py against its namesake in
    roms_tpu/ops/kpp.py, at rtol 1e-12 and atol 1e-12 * max(1, max|ref|)
    (the arithmetic is transcribed operation by operation; the port's cube
    root sign(x)*|x|**(1/3) and its sequential cumulative sum move the
    last bits only);
(b) `cuda_kpp.vmix_update`, which takes its plain version for a CPU
    tensor, against the TPU kernel `pallas_kpp.vmix_update` in interpret
    mode, over the cases of tests/test_pallas_kpp.py and on the [1:-1]
    interior that file compares;
(c) no fallback: a tensor on a device with no kernel raises;
(d) `cuda_kpp.vmix_update` on the CPU (its plain version, which the card
    holds the kernel to) against the JAX `interior_mix` + `lmd_kpp` with
    the ownership flags set: partial ownership, and a grid periodic in i
    only, where the physical-edge fill of the smoothers applies to some
    edges and not others; whole arrays at rtol 1e-12.

Inputs are the random harness of tests/test_pallas_kpp.py, made with
numpy from a seed (`roms_tpu_torch.ops._harness.kpp_inputs`).
"""

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from roms_tpu.ops import kpp as jkpp
from roms_tpu.ops import pallas_kpp

from roms_tpu_torch.ops import _harness, cuda_kpp
from roms_tpu_torch.ops import kpp as tkpp

from torch_helpers import jax_cfg

torch.set_num_threads(1)

CASES = {"salinity": dict(), "no_salinity": dict(salinity=False),
         "no_mask": dict(masking=False, seed=3),
         "periodic": dict(ew_periodic=True, ns_periodic=True, seed=5)}


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    monkeypatch.setattr(pallas_kpp, "_INTERPRET", True)


def _inputs(name):
    """(port cfg, JAX cfg, jnp arrays, torch tensors) of one case."""
    cfg, d = _harness.kpp_inputs(**CASES[name])
    return (cfg, jax_cfg(cfg), {k: jnp.asarray(v) for k, v in d.items()},
            {k: torch.as_tensor(v) for k, v in d.items()})


def _ns(x, own=(None,) * 4):
    """(grid, state, forcing) namespaces over one package's arrays; own:
    the (west, east, south, north) ownership flags, None = owned."""
    grid = types.SimpleNamespace(
        f=x["f"], rmask=x["rmask"], umask=x["umask"], vmask=x["vmask"],
        own_w=own[0], own_e=own[1], own_s=own[2], own_n=own[3])
    state = types.SimpleNamespace(swrf=x["swrf"], hbls=x["hbls"],
                                  hbbl=x["hbbl"])
    forcing = types.SimpleNamespace(stflx=x["stflx"], srflx=x["srflx"],
                                    sustr=x["sustr"], svstr=x["svstr"])
    return grid, state, forcing


def _close(got, ref, interior=False, rtol=1e-12):
    g = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    r = np.asarray(ref)
    assert g.shape == r.shape
    if interior:
        g, r = g[..., 1:-1, 1:-1], r[..., 1:-1, 1:-1]
    np.testing.assert_allclose(g, r, rtol=rtol,
                               atol=rtol * max(1.0, np.abs(r).max()))


# ------------------------------------------------------------- (a) functions
@pytest.mark.parametrize("nonlin,salinity", [(True, True), (True, False),
                                             (False, True), (False, False)])
def test_alfabeta(nonlin, salinity):
    cfg, _, j, t = _inputs("salinity")
    cfg = cfg.replace(nonlin_eos=nonlin, salinity=salinity)
    jc = jax_cfg(cfg)
    for a, b in zip(jkpp.alfabeta(j["t"][:, -1], jc),
                    tkpp.alfabeta(t["t"][:, -1], cfg)):
        _close(b, a)


def test_swr_frac():
    cfg, jc, j, t = _inputs("salinity")
    _close(tkpp.swr_frac(t["hz"], cfg), jkpp.swr_frac(j["hz"], jc))


@pytest.mark.parametrize("name", ["salinity", "no_mask", "periodic"])
def test_edge_fill_and_smoother(name):
    cfg, jc, j, t = _inputs(name)
    jg, tg = _ns(j)[0], _ns(t)[0]
    jf = jkpp._fill_phys_edges_2d(j["hbls"], jc, jg)
    tf = tkpp._fill_phys_edges_2d(t["hbls"], cfg, tg)
    _close(tf, jf)
    _close(tkpp._smooth2d(tf, tg, cfg), jkpp._smooth2d(jf, jg, jc))


@pytest.mark.parametrize("masking", [True, False])
def test_wscale(masking):
    cfg, jc, j, t = _inputs("salinity")
    cfg, jc = cfg.replace(masking=masking), jc.replace(masking=masking)
    rng = np.random.default_rng(11)
    # zscale, bfsfc, ustar, hbl spanning the stable, unstable and
    # convective branches
    zs = 50.0 * rng.random((3, 6, 7))
    bf = 1e-7 * rng.standard_normal((3, 6, 7))
    us = 1e-2 * rng.random((6, 7))
    hb = 10.0 + 40.0 * rng.random((6, 7))
    rm = (rng.random((6, 7)) > 0.2).astype(np.float64)
    ja = [jnp.asarray(a) for a in (zs, bf, us[None], hb[None], rm[None])]
    ta = [torch.as_tensor(a) for a in (zs, bf, us[None], hb[None], rm[None])]
    _close(tkpp._wscale_ws(*ta, cfg), jkpp._wscale_ws(*ja, jc))
    for a, b in zip(jkpp._wscale_wm_ws(*ja, jc), tkpp._wscale_wm_ws(*ta, cfg)):
        _close(b, a)


@pytest.mark.parametrize("name", list(CASES))
def test_interior_mix(name):
    cfg, jc, j, t = _inputs(name)
    ref = jkpp.interior_mix(j["u"], j["v"], j["bvf"], j["z_r"], j["z_w"],
                            _ns(j)[0], jc)
    got = tkpp.interior_mix(t["u"], t["v"], t["bvf"], t["z_r"], t["z_w"],
                            _ns(t)[0], cfg)
    for a, b in zip(ref, got):
        _close(b, a)


@pytest.mark.parametrize("first_step", [True, False])
@pytest.mark.parametrize("name", ["salinity", "no_salinity"])
def test_lmd_kpp(name, first_step):
    cfg, jc, j, t = _inputs(name)
    out = []
    for x, mod, c in ((j, jkpp, jc), (t, tkpp, cfg)):
        grid, state, forcing = _ns(x)
        kv, kt, ks = mod.interior_mix(x["u"], x["v"], x["bvf"], x["z_r"],
                                      x["z_w"], grid, c)
        out.append(mod.lmd_kpp(x["u"], x["v"], x["t"], x["bvf"], x["z_r"],
                               x["z_w"], x["hz"], kv, kt, ks, state.swrf,
                               forcing, state.hbls, state.hbbl, grid, c,
                               first_step))
    for name_ in out[0]._fields:
        _close(getattr(out[1], name_), getattr(out[0], name_))


# ---------------------------------------------------- (b) the TPU kernel
@pytest.mark.parametrize("first_step", [True, False])
@pytest.mark.parametrize("name", list(CASES))
def test_vmix_update_matches_pallas(name, first_step):
    cfg, jc, j, t = _inputs(name)
    jgrid, jstate, jfrc = _ns(j)
    ref = pallas_kpp.vmix_update(jstate, j["u"], j["v"], j["t"], j["bvf"],
                                 j["z_r"], j["z_w"], j["hz"], jfrc, jgrid,
                                 jc, first_step)
    tgrid, tstate, tfrc = _ns(t)
    before = cuda_kpp.vmix_update.launches
    got = cuda_kpp.vmix_update(tstate, t["u"], t["v"], t["t"], t["bvf"],
                               t["z_r"], t["z_w"], t["hz"], tfrc, tgrid,
                               cfg, first_step)
    assert cuda_kpp.vmix_update.launches == before      # CPU: no launch
    for field in ref._fields:
        _close(getattr(got, field), getattr(ref, field), interior=True)


# ---------------------------------------------------- (c) no fallback
def test_vmix_update_never_falls_back():
    cfg, _, _, t = _inputs("salinity")
    meta = {k: torch.empty(v.shape, dtype=v.dtype, device="meta")
            for k, v in t.items()}
    grid, state, forcing = _ns(meta)
    with pytest.raises(ValueError, match="no kernel"):
        cuda_kpp.vmix_update(state, meta["u"], meta["v"], meta["t"],
                             meta["bvf"], meta["z_r"], meta["z_w"],
                             meta["hz"], forcing, grid, cfg, False)


# ---------------------------------------------------- (d) ownership flags
OWN_CASES = {
    # a block on the west and north physical edges only
    "west_north": (dict(seed=8), (True, False, False, True)),
    # a block on the south and east edges only, without masking
    "south_east": (dict(masking=False, seed=10), (False, True, True, False)),
    # periodic in i only: the fill applies to the rows alone
    "ew_periodic": (dict(ew_periodic=True, seed=9), (None,) * 4),
    "ew_periodic_south": (dict(ew_periodic=True, salinity=False, seed=11),
                          (True, True, True, False)),
}


@pytest.mark.parametrize("first_step", [True, False])
@pytest.mark.parametrize("name", list(OWN_CASES))
def test_vmix_update_with_ownership_matches_jax(name, first_step):
    kw, own = OWN_CASES[name]
    cfg, d = _harness.kpp_inputs(**kw)
    jc = jax_cfg(cfg)
    j = {k: jnp.asarray(v) for k, v in d.items()}
    t = {k: torch.as_tensor(v) for k, v in d.items()}
    jgrid, jstate, jfrc = _ns(j, own)
    kv, kt, ks = jkpp.interior_mix(j["u"], j["v"], j["bvf"], j["z_r"],
                                   j["z_w"], jgrid, jc)
    ref = jkpp.lmd_kpp(j["u"], j["v"], j["t"], j["bvf"], j["z_r"], j["z_w"],
                       j["hz"], kv, kt, ks, jstate.swrf, jfrc, jstate.hbls,
                       jstate.hbbl, jgrid, jc, first_step)
    tgrid, tstate, tfrc = _ns(t, own)
    before = cuda_kpp.vmix_update.launches
    got = cuda_kpp.vmix_update(tstate, t["u"], t["v"], t["t"], t["bvf"],
                               t["z_r"], t["z_w"], t["hz"], tfrc, tgrid,
                               cfg, first_step)
    assert cuda_kpp.vmix_update.launches == before      # CPU: no launch
    for field in ref._fields:
        _close(getattr(got, field), getattr(ref, field))
