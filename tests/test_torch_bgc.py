"""The port's biogeochemistry against the JAX package's, in float64 on the
CPU (roms_tpu_torch/bgc against roms_tpu/bgc):

(a) twins of tests/test_bgc.py, tests/test_bgc_bec.py and
    tests/test_carbonate.py: each engine's registry entry, initial
    profiles, interior tendency (with every registered diagnostic), surface
    flux and diagnose; the particulate column solves of every class; the
    gas-exchange helpers; and the carbonate solver's constants, residual,
    [H+] solve, CO2 system and flux — on seeded random inputs handed to
    both packages, at rtol 1e-13 with atol 1e-13 * max|ref|; [H+] and
    everything derived from it, pH included, at every ocean point at rtol
    1e-12 where the solve has converged (60 iterations), 1e-11 after the
    model's 25 iterations from its closed-form seed, and 1e-9 after 25
    from no seed or a random one (see SOLVES), each with a residual under
    1e-12 mol/kg;
    the port's tendencies conserve C, Si and P as test_bgc_bec.py asks of
    the JAX package's; a surface flux without a wind speed warns;
(d) one step of bgc_real MARBL (199x99x50, nt=34: tides, bulk, rivers,
    sponge, KPP, the BGC block) through `Experiment.run` against the JAX
    package's, every state field at atol 5e-11 * max(1, max|ref|), `we`,
    `akv` and `akt` at bench_production.CONDITIONED_TOL, over all 34
    tracers.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from roms_tpu.bgc import bec as jbec
from roms_tpu.bgc import carbonate as jcarb
from roms_tpu.bgc.api import BGCContext as JCtx
from roms_tpu.bgc.api import get_model as jget
from roms_tpu.cases import bgc_real as jbgc_real

from roms_tpu_torch import bridge
from roms_tpu_torch.bgc import bec as tbec
from roms_tpu_torch.bgc import carbonate as tcarb
from roms_tpu_torch.bgc.api import BGCContext as TCtx
from roms_tpu_torch.bgc.api import get_model as tget
from roms_tpu_torch.cases import bgc_real as tbgc_real
from roms_tpu_torch.cases.bench_production import CONDITIONED_TOL, STEP_TOL

from torch_helpers import F64, assert_state_close, port_cfg

torch.set_num_threads(1)

TOL = 1e-13
TOL_H = 1e-12
MODELS = ("npzd", "bec2", "bec2_base", "marbl32")
BEC = ("bec2", "bec2_base", "marbl32")


def _close(got, ref, tol=TOL, what=""):
    ref = np.asarray(ref)
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    assert got.shape == ref.shape, what
    np.testing.assert_allclose(got, ref, rtol=tol,
                               atol=tol * max(float(np.abs(ref).max()),
                                              1e-300), err_msg=what)


def _both(d):
    """(JAX arrays, port tensors) of a dict of numpy arrays."""
    return ({k: jnp.asarray(v) for k, v in d.items()},
            {k: torch.as_tensor(v, dtype=F64) for k, v in d.items()})


def _ctx(seed, nz=12, jy=5, ix=6):
    """(JAX, port) BGCContext on a seeded random column stack."""
    rng = np.random.default_rng(seed)
    hz = rng.uniform(2.0, 20.0, (nz, jy, ix))
    z_w = np.concatenate([-hz.sum(0)[None], -hz.sum(0)[None]
                          + np.cumsum(hz, 0)], 0)
    z_r = 0.5 * (z_w[1:] + z_w[:-1])
    rmask = (rng.random((jy, ix)) > 0.15).astype(np.float64)
    d = dict(temp=rng.uniform(2.0, 25.0, (nz, jy, ix)),
             salt=rng.uniform(30.0, 36.0, (nz, jy, ix)), z_r=z_r, z_w=z_w,
             hz=hz, srflx=rng.uniform(0.0, 400.0, (jy, ix)) / (1027.5 * 3985.),
             swr_frac=np.exp(z_w / 15.0), rmask=rmask)
    j, t = _both(d)
    return (JCtx(**j, dt=600.0, time=jnp.zeros(())),
            TCtx(**t, dt=600.0, time=torch.zeros((), dtype=F64)), d)


def _tracers(name, d, seed):
    """Seeded tracers around the engine's initial profiles, O2 from anoxic
    to saturated and a few negative values, so the suboxic branch and the
    clamps both run."""
    rng = np.random.default_rng(seed)
    trc = np.asarray(jget(name).init_tracers(None, jnp.asarray(d["z_r"])))
    trc = trc * rng.uniform(0.5, 1.5, trc.shape)
    names = [n.upper() for n in jget(name).tracer_names]
    if "O2" in names:
        trc[names.index("O2")] = rng.uniform(0.0, 300.0, trc.shape[1:])
    trc[rng.random(trc.shape) < 0.02] *= -0.01
    return trc


def _forcing(shape, seed, lfreq=False):
    rng = np.random.default_rng(seed)
    d = {"pco2_air": rng.uniform(300.0, 500.0, shape),
         "pco2_air_alt": rng.uniform(200.0, 300.0, shape),
         "wspd": rng.uniform(0.0, 15.0, shape),
         "dust": rng.uniform(0.0, 1e-9, shape),
         "iron": rng.uniform(0.0, 1e-3, shape),
         "nox": rng.uniform(0.0, 1e-10, shape),
         "nhy": rng.uniform(0.0, 1e-10, shape)}
    if lfreq:
        d["swrad_LFreq"] = rng.uniform(0.0, 300.0, shape)
    return _both(d)


def test_registry_matches_jax():
    for name in MODELS:
        assert tuple(tget(name).tracer_names) == tuple(jget(name).tracer_names)
        assert tget(name).ntracers == jget(name).ntracers
    with pytest.raises(KeyError):
        tget("no_such_model")


@pytest.mark.parametrize("name", MODELS)
def test_init_tracers_match_jax(name):
    _, _, d = _ctx(0)
    ref = jget(name).init_tracers(None, jnp.asarray(d["z_r"]))
    got = tget(name).init_tracers(None, torch.as_tensor(d["z_r"]), F64)
    _close(got, ref, what=name)


@pytest.mark.parametrize("lfreq", [False, True], ids=["srflx", "lfreq"])
@pytest.mark.parametrize("name", MODELS)
def test_interior_matches_jax(name, lfreq):
    jc, tc, d = _ctx(1)
    trc = _tracers(name, d, 2)
    jf, tf = _forcing(d["rmask"].shape, 3, lfreq)
    names = jget(name).tracer_names
    if name in BEC:
        # the JAX engine's interior_tendency is its kernel's tendency
        # (roms_tpu/bgc/bec.py:566-568): one evaluation gives both
        ref, jd = jbec.make_interior(names).kernel(jnp.asarray(trc), jc,
                                                   None, jf)
    else:
        ref, _ = jget(name).interior_tendency(jnp.asarray(trc), jc, None,
                                              jf)
    got, saved = tget(name).interior_tendency(torch.as_tensor(trc), tc,
                                              None, tf)
    assert saved is None
    for i, n in enumerate(names):
        _close(got[i], ref[i], what=f"{name} d{n}")
    if name in BEC:
        _, td = tbec.make_interior(names).kernel(torch.as_tensor(trc), tc,
                                                 None, tf)
        assert sorted(td) == sorted(jd)
        for k in jd:
            _close(td[k], jd[k], what=f"{name} diag {k}")


@pytest.mark.parametrize("name", MODELS)
def test_surface_flux_matches_jax(name):
    jc, tc, d = _ctx(4)
    trc = _tracers(name, d, 5)
    jf, tf = _forcing(d["rmask"].shape, 6)
    ref = jget(name).surface_flux(jnp.asarray(trc), jc, jf)
    got = tget(name).surface_flux(torch.as_tensor(trc), tc, tf)
    for i, n in enumerate(jget(name).tracer_names):
        # the CO2 fluxes carry [H+]
        tol = TOL_H if n.upper().startswith("DIC") else TOL
        _close(got[i], ref[i], tol, what=f"{name} flux {n}")


@pytest.mark.parametrize("name", BEC)
def test_diagnose_matches_jax(name):
    jc, tc, d = _ctx(7)
    trc = _tracers(name, d, 8)
    jf, tf = _forcing(d["rmask"].shape, 9)
    ref = jget(name).diagnose(jnp.asarray(trc), jc, jf)
    got = tget(name).diagnose(torch.as_tensor(trc), tc, tf)
    assert sorted(got) == sorted(ref)
    carbonate = {"pCO2_oc", "pH_surf", "CO3_surf", "HCO3_surf",
                 "CO2STAR_surf", "Omega_calcite", "Omega_aragonite",
                 "FG_CO2"}
    for k in ref:
        _close(got[k], ref[k], TOL_H if k in carbonate else TOL, what=k)


def test_surface_flux_without_wind_speed_warns():
    _, tc, d = _ctx(10)
    trc = torch.as_tensor(_tracers("marbl32", d, 11))
    with pytest.warns(UserWarning, match="wspd"):
        tget("marbl32").surface_flux(trc, tc, {})


@pytest.mark.parametrize("klass", ["PART_POC", "PART_CACO3", "PART_SIO2",
                                   "PART_DUST"])
def test_particulate_flux_matches_jax(klass):
    rng = np.random.default_rng(12)
    prod = np.abs(rng.standard_normal((14, 4, 5))) * 1e-6
    hz = 3.0 + np.abs(rng.standard_normal((14, 4, 5)))
    ref = jbec.particulate_flux(jnp.asarray(prod), jnp.asarray(hz),
                                getattr(jbec, klass))
    got = tbec.particulate_flux(torch.as_tensor(prod), torch.as_tensor(hz),
                                getattr(tbec, klass))
    for g, r, n in zip(got, ref, ("remin", "flux", "f_bot")):
        _close(g, r, what=f"{klass} {n}")
    # exactly conservative, as tests/test_bgc_bec.py asks
    np.testing.assert_allclose((got[0] * torch.as_tensor(hz)).sum(0),
                               (prod * hz).sum(0), rtol=1e-12)


def test_stacked_sweep_is_each_class_alone():
    """One sweep over several classes gives each class's lone solve."""
    rng = np.random.default_rng(13)
    hz = torch.as_tensor(3.0 + np.abs(rng.standard_normal((10, 3, 4))))
    prods = [torch.as_tensor(np.abs(rng.standard_normal((10, 3, 4))))
             for _ in range(3)]
    klasses = (tbec.PART_POC, tbec.PART_CACO3, tbec.PART_SIO2)
    for (g, alone) in zip(tbec.particulate_fluxes(prods, hz, klasses),
                          [tbec.particulate_flux(p, hz, k)
                           for p, k in zip(prods, klasses)]):
        for a, b in zip(g, alone):
            assert torch.equal(a, b)


def test_gas_exchange_helpers_match_jax():
    rng = np.random.default_rng(14)
    temp = rng.uniform(-1.0, 30.0, (6, 7))
    salt = rng.uniform(28.0, 38.0, (6, 7))
    ws = rng.uniform(0.0, 20.0, (6, 7))
    sx, sy = rng.normal(0.0, 2e-4, (2, 6, 7))
    dic = rng.uniform(1800.0, 2400.0, (6, 7))
    alk = rng.uniform(2000.0, 2500.0, (6, 7))
    j, t = _both(dict(temp=temp, salt=salt, ws=ws, sx=sx, sy=sy, dic=dic,
                      alk=alk))
    for fn, args in (("o2_saturation", ("temp", "salt")),
                     ("schmidt_o2", ("temp",)), ("schmidt_co2", ("temp",))):
        _close(getattr(tbec, fn)(*[t[a] for a in args]),
               getattr(jbec, fn)(*[j[a] for a in args]), what=fn)
    _close(tbec.gas_transfer_velocity(t["ws"], tbec.schmidt_co2(t["temp"])),
           jbec.gas_transfer_velocity(j["ws"], jbec.schmidt_co2(j["temp"])))
    _close(tbec.wind_speed_from_stress(t["sx"], t["sy"], 1027.5),
           jbec.wind_speed_from_stress(j["sx"], j["sy"], 1027.5))
    for g, r, n in zip(
            tbec._co2_equilibrium(t["dic"], t["alk"], t["temp"], t["salt"]),
            jbec._co2_equilibrium(j["dic"], j["alk"], j["temp"], j["salt"]),
            ("pco2", "ph", "co2star")):
        _close(g, r, what=f"closed form {n}")


def _chem(seed, n=40):
    """Seeded surface chemistry from polar to tropical; the first LAND
    points are zeros (the solve must stay finite there, and the model
    masks them)."""
    rng = np.random.default_rng(seed)
    d = dict(dic=rng.uniform(1800.0, 2400.0, n) * 1.0261,
             ta=rng.uniform(2050.0, 2500.0, n) * 1.0261,
             t=rng.uniform(-1.5, 30.0, n), s=rng.uniform(29.0, 38.0, n),
             po4=rng.uniform(0.0, 3.0, n), sio3=rng.uniform(0.0, 120.0, n),
             kw=rng.uniform(1e-6, 1e-4, n), pco2=rng.uniform(250.0, 600.0, n))
    for k in ("dic", "ta", "t", "s"):
        d[k][:LAND] = 0.0
    return _both(d)


LAND = 3


def _close_ocean(got, ref, tol, what):
    """Relative agreement at every ocean point; finite values on land."""
    assert bool(torch.isfinite(got).all()), what
    np.testing.assert_allclose(got.numpy()[LAND:], np.asarray(ref)[LAND:],
                               rtol=tol, atol=0, err_msg=what)


def test_carbonate_constants_match_jax():
    j, t = _chem(15)
    ref = jcarb.constants(j["t"], j["s"])
    got = tcarb.constants(t["t"], t["s"])
    for g, r, n in zip(got, ref, ref._fields):
        _close(g, r, what=n)
    for g, r in zip(tcarb._ksp_mucci(t["t"], t["s"]),
                    jcarb._ksp_mucci(j["t"], j["s"])):
        _close(g, r, what="ksp")


def _seed_h(j, t, kind, seed):
    """(JAX, port) [H+] seeds of the solve: the closed-form
    carbonate-alkalinity solution the model seeds it with, a random
    guess, or none."""
    if kind == "closed_form":
        _, ph_j, _ = jbec._co2_equilibrium(j["dic"], j["ta"], j["t"], j["s"])
        _, ph_t, _ = tbec._co2_equilibrium(t["dic"], t["ta"], t["t"], t["s"])
        return 10.0 ** (-ph_j), 10.0 ** (-ph_t)
    if kind == "random":
        h0 = np.random.default_rng(seed).uniform(1e-9, 1e-7, j["dic"].shape)
        return jnp.asarray(h0), torch.as_tensor(h0)
    return None, None


# (seed, iterations, rtol at every ocean point).  The fixed 25 iterations
# stop short of round-off on some inputs, and the two packages' Newton and
# bisection choices then follow the residual's last bits: from the
# closed-form seed the model gives the solve, [H+] then sits up to about
# 7e-12 from its root, so the packages are held at 1e-11; run to
# convergence (60 iterations) they agree at 1e-12; from no seed or a
# random one, 25 iterations are held to the bounds of
# tests/test_carbonate.py, rtol 1e-9 between two solves.  Every solve's
# residual is under the 1e-12 mol/kg of tests/test_carbonate.py.
SOLVES = [("closed_form", 25, 1e-11), ("none", 60, TOL_H),
          ("none", 25, 1e-9), ("random", 25, 1e-9)]


@pytest.mark.parametrize("kind,iters,tol", SOLVES,
                         ids=["closed_form", "unseeded_converged",
                              "unseeded_25", "random_seed_25"])
@pytest.mark.parametrize("seed", [16, 17])
def test_residual_and_solve_h_match_jax(seed, kind, iters, tol):
    j, t = _chem(seed)
    m = jcarb.VOL_TO_MASS
    jc, tc = jcarb.constants(j["t"], j["s"]), tcarb.constants(t["t"], t["s"])
    jargs = [j[k] * m for k in ("dic", "ta", "po4", "sio3")]
    targs = [t[k] * m for k in ("dic", "ta", "po4", "sio3")]
    h0 = np.random.default_rng(seed).uniform(1e-9, 1e-7, j["dic"].shape)
    for g, r in zip(tcarb.ta_residual(torch.as_tensor(h0), *targs, tc),
                    jcarb.ta_residual(jnp.asarray(h0), *jargs, jc)):
        _close(g, r, what="ta_residual")
    jh, th = _seed_h(j, t, kind, seed)
    ref = jcarb.solve_h(*jargs, jc, h_init=jh, iters=iters)
    got = tcarb.solve_h(*targs, tc, h_init=th, iters=iters)
    _close_ocean(got, ref, tol, f"solve_h {kind} iters={iters}")
    fn, _ = tcarb.ta_residual(got, *targs, tc)
    assert float(fn[LAND:].abs().max()) < 1e-12


@pytest.mark.parametrize("kind,tol", [("closed_form", 1e-11),
                                      ("none", 1e-9)])
@pytest.mark.parametrize("nutrients", [True, False])
def test_co2_system_and_flux_match_jax(nutrients, kind, tol):
    j, t = _chem(18)
    jh, th = _seed_h(j, t, kind, 18)
    extra = ("po4", "sio3") if nutrients else ()
    ref = jcarb.co2_system(j["dic"], j["ta"], j["t"], j["s"],
                           *[j[k] for k in extra], h_init=jh)
    got = tcarb.co2_system(t["dic"], t["ta"], t["t"], t["s"],
                           *[t[k] for k in extra], h_init=th)
    for g, r, n in zip(got, ref, ref._fields):
        _close_ocean(g, r, tol, n)
    fr, _ = jcarb.co2_flux(j["dic"], j["ta"], j["t"], j["s"], j["kw"],
                           j["pco2"], *[j[k] for k in extra], h_init=jh)
    fg, _ = tcarb.co2_flux(t["dic"], t["ta"], t["t"], t["s"], t["kw"],
                           t["pco2"], *[t[k] for k in extra], h_init=th)
    # the flux is a difference of two CO2* values: held at the scale of
    # the air-side term
    scale = float(np.abs(np.asarray(j["kw"]) * 20.0).max())
    np.testing.assert_allclose(fg.numpy()[LAND:], np.asarray(fr)[LAND:],
                               rtol=0, atol=tol * scale, err_msg="co2_flux")


@pytest.mark.parametrize("name", ["bec2", "marbl32"])
def test_port_interior_conserves_elements(name):
    """The C, Si and P budgets of tests/test_bgc_bec.py, on the port's
    tendencies."""
    _, tc, d = _ctx(19, jy=3, ix=3)
    tc = tc._replace(rmask=torch.ones_like(tc.rmask))
    m = tget(name)
    trc = m.init_tracers(None, tc.z_r, F64)
    dt, _ = m.interior_tendency(trc, tc, None, None)
    idx = {n.upper(): i for i, n in enumerate(m.tracer_names)}
    col = (dt * tc.hz[None]).sum(dim=1)
    scale = float(col.abs().max())

    def s(*names):
        return sum(col[idx[k]] for k in names if k in idx)

    c_tot = s("DIC", "DOC", "DOCR", "SPC", "DIATC", "DIAZC", "ZOOC",
              "SPCACO3")
    if "SPP" in idx:
        p_org = s("SPP", "DIATP", "DIAZP")
    else:
        p_org = tbec.Q_CP * s("SPC", "DIATC", "DIAZC")
    p_tot = s("PO4", "DOP", "DOPR") + p_org + tbec.Q_CP * s("ZOOC")
    for what, tot in (("C", c_tot), ("Si", s("SIO3", "DIATSI")),
                      ("P", p_tot)):
        assert float(tot.abs().max()) < 1e-12 * scale, what


def test_one_bgc_real_step_matches_jax(tmp_path):
    jexp = jbgc_real.build(str(tmp_path / "jax"), ntimes=1,
                           dtype=jnp.float64)
    texp = tbgc_real.build(str(tmp_path / "port"), ntimes=1, dtype=F64,
                           device="cpu")
    try:
        assert texp.cfg == port_cfg(jexp.cfg) and texp.cfg.nt == 34
        ref, _ = jexp.run(nsteps=1, collect_diag=False)
        got, _ = texp.run(nsteps=1, collect_diag=False)
    finally:
        jexp.fileset.close()
        texp.fileset.close()
    assert_state_close(bridge.to_numpy(got), ref, STEP_TOL,
                       loose=CONDITIONED_TOL)
    # every tracer on its own scale, the 32 BGC tracers included
    t, tr = bridge.to_numpy(got)["t"], np.asarray(ref.t)
    for i in range(t.shape[0]):
        np.testing.assert_allclose(
            t[i], tr[i], rtol=0,
            atol=STEP_TOL * max(1.0, float(np.abs(tr[i]).max())),
            err_msg=f"tracer {i}")
