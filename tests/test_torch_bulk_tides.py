"""The port's bulk-COARE fluxes, tides and the bgc_real assembly against
the JAX package's, in float64 on the CPU:

(a) twins of tests/test_bulk.py and tests/test_tides.py: `bulk_psiu`,
    `bulk_psit`, `bulk_flux` (winds from calm to gale, stable and unstable
    air, the very-stable freeze of the Monin-Obukhov iteration, a land
    mask, surface currents) and `diurnal_modulation`; `set_tides` with and
    without the potential tide, on top of boundary data, replacing it, and
    from none — on seeded random inputs handed to both packages, at rtol
    1e-13 with atol 1e-13 * max|ref|;
(c) `assemble` of bgc_real in both variants (MARBL, nt=34; BEC, nt=28),
    built from the inputs each package writes: the grid, the initial state,
    `forcing0` and the tidal forcing at 1e-13, and `forcing_fn(t, base,
    state)` — bulk fluxes from the state's SST and surface currents, the
    boundary and potential tides, the BGC series — at 1e-14 at the four
    offsets of tests/test_torch_realdata.py;
(e) one step of the BEC variant through `Experiment.run` against rows 0-1
    of tests/data/bgc_real_bec_oracle.txt at the per-column rtols of
    tests/realcase_utils.py:check_against_oracle.
"""

import inspect
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from realcase_utils import check_against_oracle, oracle_path

from roms_tpu.cases import bgc_real as jbgc_real
from roms_tpu.config import ModelConfig as JModelConfig
from roms_tpu.ops import bulk as jbulk
from roms_tpu.state import zero_boundary as jzero_boundary
from roms_tpu.tides import TidalForcing as JTides
from roms_tpu.tides import set_tides as jset_tides

from roms_tpu_torch import bridge
from roms_tpu_torch.cases import bgc_real as tbgc_real
from roms_tpu_torch.ops import bulk as tbulk
from roms_tpu_torch.state import zero_boundary as tzero_boundary
from roms_tpu_torch.tides import set_tides as tset_tides

from torch_helpers import (F64, assert_fields_close, np_fields, np_tree,
                           port_cfg)

torch.set_num_threads(1)

TOL = 1e-13
RTOL = inspect.signature(check_against_oracle).parameters["rtol"].default
DAY = 86400.0


def _close(got, ref, tol=TOL, what=""):
    ref = np.asarray(ref)
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, ref, rtol=tol,
                               atol=tol * max(float(np.abs(ref).max()),
                                              1e-300), err_msg=what)


def test_stability_functions_match_jax():
    zol = np.concatenate([np.linspace(-60.0, 60.0, 241),
                          np.random.default_rng(0).normal(0.0, 3.0, 200)])
    for fn in ("bulk_psiu", "bulk_psit"):
        _close(getattr(tbulk, fn)(torch.as_tensor(zol)),
               getattr(jbulk, fn)(jnp.asarray(zol)), what=fn)


def _bulk_inputs(seed, jy=14, ix=17):
    """Seeded atmospheric and sea-surface state: winds 0-25 m/s, air 8 K
    colder to 12 K warmer than the sea (the warm calm points freeze the
    iteration), a land mask and surface currents."""
    rng = np.random.default_rng(seed)
    shp = (jy, ix)
    sst = rng.uniform(5.0, 28.0, shp)
    d = dict(uwnd=rng.uniform(-25.0, 25.0, shp),
             vwnd=rng.uniform(-10.0, 10.0, shp),
             tair=sst + rng.uniform(-8.0, 12.0, shp),
             qair=rng.uniform(0.002, 0.02, shp),
             prate=rng.uniform(0.0, 5.0, shp),
             radlw_down=rng.uniform(250.0, 420.0, shp),
             radsw=rng.uniform(0.0, 900.0, shp), sst=sst,
             u_sfc=rng.normal(0.0, 0.3, shp),
             v_sfc=rng.normal(0.0, 0.3, shp))
    calm = rng.random(shp) < 0.2
    d["uwnd"][calm] *= 0.01
    d["vwnd"][calm] *= 0.01
    d["tair"][calm] = sst[calm] + 10.0
    rmask = (rng.random(shp) > 0.2).astype(np.float64)
    masks = dict(rmask=rmask, umask=rmask * np.roll(rmask, 1, 1),
                 vmask=rmask * np.roll(rmask, 1, 0))
    return d, masks


@pytest.mark.parametrize("masking", [True, False])
def test_bulk_flux_matches_jax(masking):
    d, masks = _bulk_inputs(1)
    jcfg = JModelConfig(nx=13, ny=10, nz=4, masking=masking, rho0=1027.5)
    ref = jbulk.bulk_flux(**{k: jnp.asarray(v) for k, v in d.items()},
                          grid=SimpleNamespace(**{k: jnp.asarray(v) for k, v
                                                  in masks.items()}),
                          cfg=jcfg)
    got = tbulk.bulk_flux(**{k: torch.as_tensor(v) for k, v in d.items()},
                          grid=SimpleNamespace(**{k: torch.as_tensor(v) for
                                                  k, v in masks.items()}),
                          cfg=port_cfg(jcfg))
    for g, r, n in zip(got, ref, ref._fields):
        _close(g, r, what=n)
        assert bool(torch.isfinite(g).all()), n


def test_diurnal_modulation_matches_jax():
    rng = np.random.default_rng(3)
    srflx = rng.uniform(0.0, 1e-4, (6, 8))
    lon = rng.uniform(-180.0, 180.0, (6, 8))
    lat = rng.uniform(-70.0, 70.0, (6, 8))
    for time in (0.0, 3.7e4, 8.64e4 * 200.25, 3.3e7):
        ref = jbulk.diurnal_modulation(jnp.asarray(srflx), jnp.asarray(time),
                                       jnp.asarray(lon), jnp.asarray(lat))
        got = tbulk.diurnal_modulation(torch.as_tensor(srflx),
                                       torch.tensor(time, dtype=F64),
                                       torch.as_tensor(lon),
                                       torch.as_tensor(lat))
        _close(got, ref, what=f"t={time}")


def _tides(jcfg, pot=True, ntides=3):
    h = jcfg.halo
    shape = (ntides, jcfg.ny + 2 * h, jcfg.nx + 2 * h)
    rng = np.random.default_rng(4)
    d = {k: rng.normal(size=shape) for k in
         ("ztide_re", "ztide_im", "utide_re", "utide_im", "vtide_re",
          "vtide_im") + (("ptide_re", "ptide_im") if pot else ())}
    d["ftide"] = np.array([1.405189e-4, 1.454441e-4, 7.29e-5])[:ntides]
    return (JTides(**{k: jnp.asarray(v) for k, v in d.items()}),
            bridge.tides_from_numpy(d, dtype=F64, device="cpu"))


@pytest.mark.parametrize("pot", [True, False], ids=["pot", "no_pot"])
@pytest.mark.parametrize("bry", ["zero", "data", "none"])
@pytest.mark.parametrize("add", [True, False], ids=["add", "replace"])
def test_set_tides_matches_jax(pot, bry, add):
    jcfg = JModelConfig(nx=12, ny=9, nz=3, ew_periodic=False,
                        ns_periodic=False, obc_west=True, obc_east=True,
                        obc_south=True, obc_north=True, dt=40.0)
    tcfg = port_cfg(jcfg)
    jt, tt = _tides(jcfg, pot)
    jb = tb = None
    if bry != "none":
        jb, tb = jzero_boundary(jcfg), tzero_boundary(tcfg, F64, "cpu")
    if bry == "data":
        jb = jb.replace(zeta_west=jnp.full_like(jb.zeta_west, 0.5),
                        ubar_north=jnp.full_like(jb.ubar_north, -0.2))
        tb = tb.replace(zeta_west=torch.full_like(tb.zeta_west, 0.5),
                        ubar_north=torch.full_like(tb.ubar_north, -0.2))
    for time in (0.0, 3600.0, 3.3e6):
        rb, rp = jset_tides(jt, jnp.asarray(time), jcfg, jb, add_to_bry=add)
        gb, gp = tset_tides(tt, torch.tensor(time, dtype=F64), tcfg, tb,
                            add_to_bry=add)
        assert (gp is None) == (rp is None) and not (pot and gp is None)
        if rp is not None:
            _close(gp, rp, what="ptide")
        assert_fields_close(rb, gb, TOL)


@pytest.fixture(scope="module", params=["marbl", "bec"])
def built(request, tmp_path_factory):
    """(variant, JAX experiment, port experiment), each assembled from the
    inputs its own package wrote."""
    variant = request.param
    work = tmp_path_factory.mktemp(f"bgc_real_{variant}")
    jexp = jbgc_real.build(str(work / "jax"), ntimes=1, variant=variant,
                           dtype=jnp.float64)
    texp = tbgc_real.build(str(work / "port"), ntimes=1, variant=variant,
                           dtype=F64, device="cpu")
    yield variant, jexp, texp
    jexp.fileset.close()
    texp.fileset.close()


def test_assemble_matches_jax(built):
    variant, jexp, texp = built
    assert texp.cfg == port_cfg(jexp.cfg)
    assert texp.cfg.nt == {"marbl": 34, "bec": 28}[variant]
    assert_fields_close(jexp.grid, texp.grid, 1e-13)
    got = bridge.to_numpy(texp.state)
    for name, ref in np_fields(jexp.state).items():
        # omega's vertical integral: the port's cumsum against the JAX
        # package's associative scan (the bound of tests/test_torch_ops.py)
        tol = 1e-11 if name in ("we", "wi") else 1e-13
        np.testing.assert_allclose(
            got[name], ref, rtol=tol,
            atol=tol * (max(1.0, np.abs(ref).max()) if name in ("we", "wi")
                        else 1.0), err_msg=name)
    assert_fields_close(jexp.forcing0, texp.forcing0, 1e-13)
    assert texp.tides.bry_tides and texp.tides.pot_tides
    assert_fields_close(jexp.tides, texp.tides, 1e-13)
    assert texp.forcing_fn.needs_state and jexp.forcing_fn.needs_state


@pytest.mark.parametrize("offset_days", [0.0, 0.3, 0.5, 1.2],
                         ids=["start", "inside", "boundary", "past_first"])
def test_forcing_fn_matches_jax(built, offset_days):
    _, jexp, texp = built
    t = float(texp.state.time) + offset_days * DAY
    ref = jexp.forcing_fn(t, jexp.forcing0, jexp.state)
    got = texp.forcing_fn(t, texp.forcing0, texp.state)
    assert got.ptide is not None and got.bgc and got.cdr is None
    assert_fields_close(ref, got, 1e-14)


def test_bec_step_matches_oracle(tmp_path):
    texp = tbgc_real.build(str(tmp_path), ntimes=1, variant="bec",
                           dtype=F64, device="cpu")
    try:
        _, rows = texp.run(nsteps=1)
    finally:
        texp.fileset.close()
    oracle = np.loadtxt(oracle_path("bgc_real_bec"))[:2]
    assert rows.shape == oracle.shape
    for col, rtol in zip((1, 2, 3, 4), RTOL):
        np.testing.assert_allclose(rows[:, col], oracle[:, col], rtol=rtol,
                                   atol=1e-300, err_msg=f"column {col}")


def test_bridge_carries_tides():
    jcfg = JModelConfig(nx=6, ny=5, nz=2)
    jt, tt = _tides(jcfg, pot=True, ntides=2)
    assert_fields_close(jt, tt, 0.0)
    assert tt.ftide.dtype == F64 and tt.ptide_re.dtype == F64
    assert np_tree(jt).keys() == bridge.to_numpy(tt).keys()
