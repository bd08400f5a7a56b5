"""The port's mCDR releases against the JAX package's, in float64 on the
CPU:

(a) twins of tests/test_cdr.py: `remap_src_to_grid` (a numpy copy, so
    bitwise), `ll2dist`, the three release builders on the closed basin's
    grid (Gaussian and single-level footprints, remapped profiles, dense
    3D fields; the point indices int64) and `apply_cdr_all` /
    `apply_cdr` on seeded random inputs, at rtol 1e-13 with atol
    1e-13 * max|ref|; and, in the port, the mass budgets of
    tests/test_cdr.py: a parameterized release and a dense 3D one raise
    the closed basin's tracer content by flx*dt a step, through the
    tracer kernel's path (its plain version here);
(b) two releases whose footprints overlap: the scatter adds both where
    they share cells (as the JAX package's `.at[].add` does), and the
    content rises by their summed flux;
(c) `assemble` of cdr_parameterized, cdr_dp and cdr_3d built from the
    inputs each package writes: grid, initial state, `forcing0` at 1e-13
    and `forcing_fn(t, base, state)` (bulk fluxes, BGC series, the
    releases) at 1e-14 at the four offsets of tests/test_torch_realdata.py;
(f) a twin of test_realcases_regression.py::test_cdr_actually_fires: the
    3d mode's releases inject ALK and take up DIC; and the JAX package's
    own masses after the cases' 10 steps (tests/data/cdr_*_mass_jax.txt,
    tests/jax_cdr_masses.py), which chip_smoke.py holds the port to,
    differ from the cases' mass oracles in DIC and DIC_ALT_CO2 alone: the
    oracles were frozen before the full carbonate solver took over the
    air-sea CO2 flux;
(g) the release fires on the tracer kernel's path: the closed basin
    (no rivers, so `cuda_tracer.usable`) with MARBL's 32 tracers and a
    dense ALK/DIC release at depth, two steps through the plain tracer
    stage, equal the same steps through the batched branch (forced by
    the gate) at the step tolerances of tests/test_torch_step.py, and
    ALK and DIC move by the release's content against a run without it.
    The three cdr_* cases all run rivers, so their oracles cannot show
    this; chip_smoke.py runs cdr_3d without rivers on the card.
"""

import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from roms_tpu import cdr as jcdr
from roms_tpu import remap as jremap
from roms_tpu.cases import cdr_real as jcdr_real
from roms_tpu.cases import obc_basin as jbasin

from roms_tpu_torch import bridge
from roms_tpu_torch import cdr as tcdr
from roms_tpu_torch import remap as tremap
from roms_tpu_torch.bgc.api import get_model
from roms_tpu_torch.cases import cdr_real as tcdr_real
from roms_tpu_torch.cases import obc_basin as tbasin
from roms_tpu_torch.cases.bench_production import CONDITIONED_TOL, STEP_TOL
from roms_tpu_torch.driver import run
from roms_tpu_torch.ops import cuda_tracer

from torch_helpers import (F64, assert_fields_close, assert_state_close,
                           np_fields, np_tree, port_cfg)

torch.set_num_threads(1)

TOL = 1e-13
DAY = 86400.0
MODES = ("parameterized", "dp", "3d")


def _close(got, ref, tol=TOL, what=""):
    ref = np.asarray(ref)
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    assert got.shape == ref.shape, what
    np.testing.assert_allclose(got, ref, rtol=tol,
                               atol=tol * max(float(np.abs(ref).max()),
                                              1e-300), err_msg=what)


def test_remap_is_the_jax_packages():
    rng = np.random.default_rng(1)
    for n_src, n_tgt in ((12, 20), (3, 7), (30, 9)):
        h_src = rng.uniform(1.0, 5.0, n_src)
        t_src = rng.normal(size=n_src) ** 2
        h_tgt = rng.uniform(0.5, 4.0, n_tgt)
        got = tremap.remap_src_to_grid(h_src, t_src, h_tgt)
        np.testing.assert_array_equal(
            got, jremap.remap_src_to_grid(h_src, t_src, h_tgt))
        np.testing.assert_allclose(np.sum(got * h_tgt),
                                   np.sum(t_src * h_src), rtol=1e-12)


def test_ll2dist_is_the_jax_packages():
    rng = np.random.default_rng(2)
    lon, lat = rng.uniform(-130, -115, 50), rng.uniform(25, 45, 50)
    np.testing.assert_array_equal(tcdr.ll2dist(lon, lat, -121.5, 34.0),
                                  jcdr.ll2dist(lon, lat, -121.5, 34.0))


@pytest.fixture(scope="module")
def basin():
    """(JAX config, JAX grid and state, port grid and state) of the closed
    basin at 16x16x8."""
    cfg = jbasin.config("closed", ntimes=4).replace(
        nx=16, ny=16, nz=8, dt=30.0, ndtfast=20, nt=3)
    jg, jst, _ = jbasin.setup(cfg)
    tg = bridge.grid_from_numpy(np_tree(jg), dtype=F64, device="cpu")
    tst = bridge.state_from_numpy(np_tree(jst), dtype=F64, device="cpu")
    return cfg, jg, jst, tg, tst


# (lon, lat, depth, horizontal scale, vertical scale) of each release;
# the first two overlap
RELEASES = dict(lon=[8000.0, 9500.0, 3000.0], lat=[8000.0, 8600.0, 12000.0],
                dep=[50.0, 30.0, 20.0], hsc=[3000.0, 2500.0, 0.0],
                vsc=[20.0, 0.0, 10.0])


def _parameterized(cfg, grid, st, mod, **kw):
    r = RELEASES
    flx = np.random.default_rng(3).uniform(-200.0, 500.0, (3, cfg.nt))
    return mod.parameterized_releases(
        cfg, grid, st.z_r, st.hz, r["lon"], r["lat"], r["dep"], r["hsc"],
        r["vsc"], flx, xy_dist=True, **kw)


def _profile(cfg, grid, st, mod, **kw):
    rng = np.random.default_rng(4)
    h_src = rng.uniform(5.0, 15.0, (2, 12))
    prof = rng.uniform(0.0, 1.0, (2, 2, 12))
    return mod.profile_releases(cfg, grid, st.hz, [4000.0, 11000.0],
                                [5000.0, 9000.0], h_src, prof,
                                tracer_indices=(2, 0), xy_dist=True, **kw)


def _dense(cfg, grid, st, mod, **kw):
    flx3 = np.random.default_rng(5).uniform(
        0.0, 1e-4, (cfg.nt, cfg.nz) + tuple(st.zeta.shape))
    return mod.cdr_3d(cfg, flx3, **kw)


BUILDERS = {"parameterized": _parameterized, "profile": _profile,
            "dense": _dense}


@pytest.mark.parametrize("kind", sorted(BUILDERS))
def test_releases_match_jax(kind, basin):
    cfg, jg, jst, tg, tst = basin
    ref = BUILDERS[kind](cfg, jg, jst, jcdr)
    got = BUILDERS[kind](port_cfg(cfg), tg, tst, tcdr, dtype=F64)
    assert_fields_close(ref, got, TOL)
    for name in ("iloc", "jloc", "icdr"):
        if getattr(got, name) is not None:
            assert getattr(got, name).dtype == torch.int64
            np.testing.assert_array_equal(getattr(got, name),
                                          getattr(ref, name))
    # the bridge carries the JAX package's release data the same way
    via = bridge.cdr_from_numpy(np_tree(ref), dtype=F64, device="cpu")
    assert_fields_close(ref, via, 0.0)
    assert via.iloc is None or via.iloc.dtype == torch.int64


@pytest.mark.parametrize("kind", sorted(BUILDERS))
def test_apply_cdr_matches_jax(kind, basin):
    cfg, jg, jst, tg, tst = basin
    jr = BUILDERS[kind](cfg, jg, jst, jcdr)
    tr = BUILDERS[kind](port_cfg(cfg), tg, tst, tcdr, dtype=F64)
    rng = np.random.default_rng(6)
    rhs = rng.normal(size=(cfg.nt, cfg.nz) + tuple(jst.zeta.shape))
    pmn = np.array(jg.pm * jg.pn)
    ref = jcdr.apply_cdr_all(jnp.asarray(rhs), jr, jnp.asarray(pmn), 30.0)
    got = tcdr.apply_cdr_all(torch.as_tensor(rhs), tr, torch.as_tensor(pmn),
                             30.0)
    _close(got, ref, what="apply_cdr_all")
    for itrc in range(cfg.nt):
        ref1 = jcdr.apply_cdr(jnp.asarray(rhs[itrc]), itrc, jr,
                              jnp.asarray(pmn), 30.0)
        got1 = tcdr.apply_cdr(torch.as_tensor(rhs[itrc]), itrc, tr,
                              torch.as_tensor(pmn), 30.0)
        _close(got1, ref1, what=f"apply_cdr {itrc}")
        _close(got1, got[itrc], what=f"apply_cdr {itrc} vs all")


def test_overlapping_footprints_add_up(basin):
    cfg, jg, jst, tg, tst = basin
    tcfg = port_cfg(cfg)
    cdr = _parameterized(tcfg, tg, tst, tcdr, dtype=F64)
    cells = [set(zip(cdr.jloc[cdr.icdr == ic].tolist(),
                     cdr.iloc[cdr.icdr == ic].tolist())) for ic in (0, 1)]
    assert len(cells[0] & cells[1]) > 10      # the footprints overlap
    zero = torch.zeros((tcfg.nt, tcfg.nz) + tuple(tst.zeta.shape), dtype=F64)
    pmn = tg.pm * tg.pn
    got = tcdr.apply_cdr_all(zero, cdr, pmn, 30.0)
    assert bool((zero == 0).all())            # the input stays as it was
    # each release alone, summed
    alone = sum(tcdr.apply_cdr_all(zero, cdr.replace(
        iloc=cdr.iloc[cdr.icdr == ic], jloc=cdr.jloc[cdr.icdr == ic],
        prf=cdr.prf[cdr.icdr == ic], icdr=cdr.icdr[cdr.icdr == ic]), pmn,
        30.0) for ic in range(3))
    _close(got, alone, 1e-15, what="overlap")
    # the content each tracer gains is the summed flux times dt
    content = (got / pmn).sum(dim=(1, 2, 3))
    _close(content, cdr.flx.sum(0) * 30.0, 1e-12, what="content")
    # against the JAX package's .at[].add
    ref = jcdr.apply_cdr_all(jnp.zeros(zero.shape),
                             _parameterized(cfg, jg, jst, jcdr),
                             jnp.asarray(jg.pm * jg.pn), 30.0)
    _close(got, ref, what="overlap vs JAX")


def _content(st, grid, cfg, itrc):
    h = cfg.halo
    hz = st.hz[:, h:-h, h:-h]
    da = 1.0 / (grid.pm * grid.pn)[h:-h, h:-h]
    return float((st.t[itrc, :, h:-h, h:-h] * hz * da[None]).sum())


@pytest.mark.parametrize("kind", ["parameterized", "dense"])
def test_release_mass_budget_on_the_kernel_path(kind, basin):
    """tests/test_cdr.py's budgets, run by the port through the tracer
    kernel's path (`cuda_tracer.usable`; its plain version on the CPU)."""
    tcfg = port_cfg(basin[0]).replace(nt=1)
    assert cuda_tracer.usable(tcfg)
    grid, st, frc = tbasin.setup(tcfg, dtype=F64, device="cpu")
    if kind == "parameterized":
        cdr = tcdr.parameterized_releases(
            tcfg, grid, st.z_r, st.hz, [8000.0], [8000.0], [50.0], [3000.0],
            [20.0], np.full((1, 1), 500.0), xy_dist=True, dtype=F64)
        expect, rtol = 500.0, 1e-7
    else:
        flx3 = np.zeros((1, tcfg.nz) + tuple(st.zeta.shape))
        flx3[0, :, 2:-2, 2:-2] = 1.0e-4
        cdr = tcdr.cdr_3d(tcfg, flx3, dtype=F64)
        # a small difference of large content integrals (tests/test_cdr.py)
        expect, rtol = float(flx3.sum()), 1e-4
    c0 = _content(st, grid, tcfg, 0)
    st_end, _ = run(grid, st, frc.replace(cdr=cdr), tcfg, nsteps=4,
                    collect_diag=False)
    np.testing.assert_allclose(_content(st_end, grid, tcfg, 0) - c0,
                               expect * tcfg.dt * 4, rtol=rtol)


@pytest.fixture(scope="module", params=MODES)
def built(request, tmp_path_factory):
    mode = request.param
    work = tmp_path_factory.mktemp(f"cdr_{mode}")
    jexp = jcdr_real.build(str(work / "jax"), mode, ntimes=1,
                           dtype=jnp.float64)
    texp = tcdr_real.build(str(work / "port"), mode, ntimes=1, dtype=F64,
                           device="cpu")
    yield mode, jexp, texp
    jexp.fileset.close()
    texp.fileset.close()


def test_assemble_matches_jax(built):
    _, jexp, texp = built
    assert texp.cfg == port_cfg(jexp.cfg) and texp.cfg.nt == 34
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
    assert texp.tides is None and jexp.tides is None


@pytest.mark.parametrize("offset_days", [0.0, 0.3, 0.5, 1.2],
                         ids=["start", "inside", "boundary", "past_first"])
def test_forcing_fn_matches_jax(built, offset_days):
    _, jexp, texp = built
    t = float(texp.state.time) + offset_days * DAY
    ref = jexp.forcing_fn(t, jexp.forcing0, jexp.state)
    got = texp.forcing_fn(t, texp.forcing0, texp.state)
    assert got.cdr is not None and got.bgc and got.ptide is None
    assert_fields_close(ref, got, 1e-14)


def test_cdr_actually_fires(tmp_path):
    exp = tcdr_real.build(str(tmp_path), "3d", ntimes=1, dtype=F64,
                          device="cpu")
    frc = exp.forcing_fn(float(exp.state.time), exp.forcing0, exp.state)
    exp.fileset.close()
    assert frc.cdr is not None
    flx = frc.cdr.flx_3d
    assert float(flx[tcdr_real.IALK].sum()) > 0.0
    assert float(flx[tcdr_real.IDIC].sum()) < 0.0


@pytest.mark.parametrize("mode", MODES)
def test_jax_masses_differ_from_the_oracle_in_dic_alone(mode):
    names = [n.upper() for n in tcdr_real.TRACER_NAMES]
    data = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
    jax = np.loadtxt(os.path.join(data, f"cdr_{mode}_mass_jax.txt"))
    oracle = np.loadtxt(os.path.join(data, f"cdr_{mode}_mass_oracle.txt"))
    dev = np.abs(jax - oracle) / np.abs(oracle)
    stale = [names.index("DIC"), names.index("DIC_ALT_CO2")]
    rest = np.delete(dev, stale)
    assert rest.max() < 1e-12
    # the whole air-sea CO2 exchange of 10 steps is of this size
    assert 0.0 < dev[stale].max() < 1e-5


def test_release_fires_on_the_kernel_path(monkeypatch):
    model = get_model("marbl32")
    cfg = tbasin.config("closed", ntimes=2).replace(
        nx=16, ny=16, nz=8, dt=30.0, ndtfast=20, nt=1 + model.ntracers,
        bgc_model="marbl32", n_bgc=model.ntracers)
    assert cuda_tracer.usable(cfg)
    grid, st, frc = tbasin.setup(cfg, dtype=F64, device="cpu")
    t = torch.cat([st.t[:1], model.init_tracers(cfg, st.z_r, F64)])
    st = st.replace(t=t, t_prev=t)
    ialk = 1 + [n.upper() for n in model.tracer_names].index("ALK")
    idic = 1 + [n.upper() for n in model.tracer_names].index("DIC")
    # at the bottom levels only, about +1 and -0.25 mmol/m3 a step
    flx3 = np.zeros((cfg.nt, cfg.nz) + tuple(st.zeta.shape))
    flx3[ialk, :3, 6:12, 5:11] = 4.0e5
    flx3[idic, :3, 6:12, 5:11] = -1.0e5
    cdr = tcdr.cdr_3d(cfg, flx3, dtype=F64)

    def steps(release):
        out, _ = run(grid, st, frc.replace(cdr=release), cfg, nsteps=2,
                     collect_diag=False)
        return out

    kernel = steps(cdr)
    dry = steps(None)
    monkeypatch.setattr(cuda_tracer, "usable", lambda cfg: False)
    batched = steps(cdr)
    assert_state_close(bridge.to_numpy(kernel), batched, STEP_TOL,
                       loose=CONDITIONED_TOL)
    h = cfg.halo
    da = (1.0 / (grid.pm * grid.pn))[h:-h, h:-h]
    for i in (ialk, idic):
        moved = ((kernel.t[i] - dry.t[i]) * kernel.hz)[:, h:-h, h:-h]
        np.testing.assert_allclose(float((moved * da).sum()),
                                   float(flx3[i].sum()) * cfg.dt * 2,
                                   rtol=1e-9)
        # the release's cells, and nothing far from them
        diff = (kernel.t[i] - dry.t[i]).abs()
        assert float(diff[:3, 7:11, 6:10].min()) > 0.2
        assert float(diff[:, 15:, :].max()) < 1e-6
