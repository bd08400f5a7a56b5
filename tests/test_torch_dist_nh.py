"""The port's non-hydrostatic projection on a rank mesh (roms_tpu_torch/nhmg.py
under roms_tpu_torch/parallel/dist.py), on the CPU in float64, with gloo
ranks spawned by `dist.launch` (a FileStore under the test's temporary
directory).  The port solves one global problem on the mesh, so it is held
to the JAX package's single-device projection and to its own single block:

(i) `nh_solve` on the 2x2 blocks of tests/test_torch_nhmg.py's seamount
    (16x16x8, the seeded trial) with each block's edge ownership, the
    mesh's halo refresh and world sum, against roms_tpu.nhmg.nh_solve on
    the global arrays, at NH_ITERS (20) iterations, with the sigma-slope
    terms on and off, open and with a coastline: land along the west
    edge and an island over the blocks' corner, so walls cross both block
    edges.  p, u, v and w at 1e-9 * max(1, max|ref|), res0 and res at rtol
    1e-6.  With the coastline the trial is zero on land (u times umask, v
    times vmask, w times rmask), as the step's is: forced, each land
    column is a vertical problem of its own, where the JAX package's own
    PCG amplifies round-off to 4.3e-9 * scale in p between its solve
    under `jax.jit` and without at 20 iterations (2.7e-15 on the masked
    trial);
(ii) the same, open, at the default 40 iterations, within 4 times the JAX
    package's own jit-against-eager distance, quantity by quantity, as
    tests/test_torch_nhmg.py::test_nh_solve_default_iterations_match_jax;
(iii) the step with `bench_production.OPTIONS["nh"]` (the projection and
    the momentum budget) at 48x32x16 nt=4, nh_iters=20, 2 steps on 2x2
    ranks against the single block: the main fields at 1e-11 * max(1,
    max|ref|), the arrays bench_production.OPTION_CONDITIONED_TOL["nh"]
    names at their bound, every other array at 1e-11 (the momentum terms
    on the reference's update range), the diagnostics rows equal on every
    rank and within 1e-11 of the single block's;
(iv) the same configuration on a 1x1 mesh: every field and row bitwise
    equal to `driver.run`;
(v) a grid the mesh does not divide (49x33x8 nt=2, padded by one row and
    one column onto 2x2) with the projection, against its single block at
    (iii)'s bounds;
and the divergence on the blocks (`nhmg.divergence` with the halo
refresh) of a projection run to convergence (160 iterations, the
coastline) bitwise equal to the single block's divergence of the joined
fields, and below 1e-6 of res0.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from roms_tpu import nhmg as jnhmg

from roms_tpu_torch import bridge, nhmg
from roms_tpu_torch.cases import bench_production
from roms_tpu_torch.driver import run
from roms_tpu_torch.parallel import dist

import torch_dist_ranks as ranks
from test_torch_nhmg import NH_ITERS, _distance, _seamount, _trial
from torch_helpers import port_cfg

torch.set_num_threads(1)

H = 2
TIMEOUT = 300.0
# the port's blocks against the JAX package's single device; the mesh's
# global PCG against the port's own single block (readings 4e-16 to 3e-14
# * scale in the main fields)
NH_TOL = 1e-9
MESH_NH_TOL = 1e-11
NH_LOOSE = bench_production.OPTION_CONDITIONED_TOL["nh"]
NH_FLAGS = dict(bench_production.OPTIONS["nh"], nh_iters=20)
NH = ("bench_production", dict(nx=48, ny=32, nz=16, nt=4, **NH_FLAGS), {})
NH_PADDED = ("bench_production", dict(nx=49, ny=33, nz=8, nt=2, **NH_FLAGS),
             {})
NSTEPS = 2
# the solve cases of one launch: (sigma terms, coastline, iterations)
SOLVES = [(True, False, NH_ITERS), (True, True, NH_ITERS),
          (False, False, NH_ITERS), (False, True, NH_ITERS),
          (True, False, 40), (False, False, 40), (True, True, 160)]


def _coast(jy, ix):
    """(rmask, umask, vmask): land along the west edge (interior columns
    2-4, across the blocks' row boundary) and an island over rows 7-12,
    columns 8-11 (across both block boundaries, at 10, and their
    corner)."""
    rm = np.ones((jy, ix))
    rm[:, :5] = 0.0
    rm[7:13, 8:12] = 0.0
    return rm, rm * np.roll(rm, 1, -1), rm * np.roll(rm, 1, -2)


def _solve_case(sigma, coast, n_iter):
    """(global arrays, JAX config, iterations) of one solve case."""
    cfg, hz, z_r, pm, pn = _seamount()
    cfg = cfg.replace(nh_sigma_terms=sigma, masking=coast)
    u, v, w = _trial(hz)
    arrays = dict(u=u, v=v, w=w, hz=hz, z_r=z_r, pm=pm, pn=pn)
    if coast:
        rm, um, vm = _coast(*pm.shape)
        arrays.update(u=u * um, v=v * vm, w=w * rm, umask=um, vmask=vm)
    return arrays, cfg, n_iter


def _jax_solve(arrays, cfg, n_iter, jit=False):
    """roms_tpu.nhmg.nh_solve on the global arrays, as numpy."""
    grid = types.SimpleNamespace(
        **{k: (jnp.asarray(arrays[k]) if k in arrays else None)
           for k in ("umask", "vmask")})
    args = [jnp.asarray(arrays[k])
            for k in ("u", "v", "w", "hz", "z_r", "pm", "pn")]

    def solve(*a):
        return jnhmg.nh_solve(*a, grid, cfg, n_iter=n_iter)
    r = (jax.jit(solve) if jit else solve)(*args)
    return {k: np.asarray(getattr(r, k))
            for k in ("p", "u", "v", "w", "res0", "res")}


@pytest.fixture(scope="module")
def solves(tmp_path_factory):
    """Every case of SOLVES on 2x2 ranks, in one launch: {case: (the
    joined fields with res0 and res, the global arrays, the JAX
    config)}."""
    cases = [_solve_case(*c) for c in SOLVES]
    got = dist.launch(ranks.nh_blocks, 4, "gloo", "cpu",
                      args=([(a, port_cfg(cfg), n) for a, cfg, n in cases],),
                      timeout=TIMEOUT,
                      store_dir=str(tmp_path_factory.mktemp("nh_solves")))
    out = {}
    for i, (key, (arrays, cfg, _)) in enumerate(zip(SOLVES, cases)):
        fields, res0, res = got[0][i]
        for r in range(1, 4):
            assert got[r][i][1:] == (res0, res), (key, r)
        out[key] = (dict(fields, res0=res0, res=res), arrays, cfg)
    return out


@pytest.mark.parametrize("coast", [False, True], ids=["open", "coast"])
@pytest.mark.parametrize("sigma", [True, False], ids=["sigma", "orthogonal"])
def test_nh_solve_on_blocks_matches_jax(solves, sigma, coast):
    got, arrays, cfg = solves[sigma, coast, NH_ITERS]
    ref = _jax_solve(arrays, cfg, NH_ITERS)
    for name in ("p", "u", "v", "w"):
        a = ref[name]
        np.testing.assert_allclose(got[name], a, rtol=0,
                                   atol=NH_TOL * max(1.0, np.abs(a).max()),
                                   err_msg=name)
    for name in ("res0", "res"):
        np.testing.assert_allclose(got[name], float(ref[name]), rtol=1e-6,
                                   err_msg=name)
    assert got["res"] < 1e-2 * got["res0"]


@pytest.mark.parametrize("sigma", [True, False], ids=["sigma", "orthogonal"])
def test_nh_solve_on_blocks_default_iterations_match_jax(solves, sigma):
    got, arrays, cfg = solves[sigma, False, 40]
    assert cfg.nh_iters == 40
    ref = _jax_solve(arrays, cfg, 40)
    fused = _jax_solve(arrays, cfg, 40, jit=True)
    own, port = _distance(fused, ref), _distance(got, ref)
    floor = {"res/res0": 1e-6, "p": 1e-9, "u": 1e-9, "v": 1e-9, "w": 1e-9}
    for name, d in port.items():
        assert d <= max(4.0 * own[name], floor[name]), (name, d, own[name])
    assert got["res"] < 1e-3 * got["res0"]


def test_divergence_on_blocks(solves):
    """The blocks' divergence of their converged projection: bitwise the
    single block's divergence of the joined fields, and below 1e-6 of
    res0."""
    got, arrays, cfg = solves[True, True, 160]
    t = {k: torch.as_tensor(v) for k, v in arrays.items()}
    grid = types.SimpleNamespace(umask=t["umask"], vmask=t["vmask"])
    div = nhmg.divergence(*(torch.as_tensor(got[k]) for k in "uvw"),
                          t["hz"], t["pm"], t["pn"], port_cfg(cfg), grid,
                          t["z_r"]).numpy()
    assert np.array_equal(got["div"], div)
    assert np.abs(got["div"]).max() < 1e-6 * got["res0"]
    assert got["res"] < 1e-6 * got["res0"]


def _flat(d, pre=""):
    out = {}
    for k, v in d.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{pre}{k}."))
        elif v is not None:
            out[pre + k] = np.asarray(v)
    return out


def _single(spec):
    cfg, grid, st, frc = ranks.build(spec)
    s, rows = run(grid, st, frc, cfg, nsteps=NSTEPS)
    return _flat(bridge.to_numpy(s)), rows


def _region(name):
    """The interior; the momentum terms on the reference's update range
    istrU..iend / jstrV..jend (tests/test_torch_dist.py:_region)."""
    if name.startswith("uv_budget.u."):
        return (Ellipsis, slice(H, -H), slice(H + 1, -H))
    if name.startswith("uv_budget.v."):
        return (Ellipsis, slice(H + 1, -H), slice(H, -H))
    return (Ellipsis, slice(H, -H), slice(H, -H))


def _compare(got, ref):
    """Every array of the single block's state against the mesh run's:
    the conditioned ones at NH_LOOSE, the others at MESH_NH_TOL, each times
    max(1, max|ref|)."""
    for name, a in ref.items():
        if a.ndim < 2:
            assert np.array_equal(got[name], a), name
            continue
        sl = _region(name)
        a, b = a[sl], got[name][sl]
        err = float(np.abs(b - a).max()) / max(1.0, float(np.abs(a).max()))
        tol = NH_LOOSE.get(name, MESH_NH_TOL)
        assert np.isfinite(b).all() and err <= tol, (name, err, tol)


@pytest.fixture(scope="module")
def steps(tmp_path_factory):
    """NH and NH_PADDED, NSTEPS each on 2x2 ranks, in one launch."""
    return dist.launch(ranks.run_cases, 4, "gloo", "cpu",
                       args=([NH, NH_PADDED], NSTEPS), timeout=TIMEOUT,
                       store_dir=str(tmp_path_factory.mktemp("nh_steps")))


@pytest.mark.parametrize("which", [0, 1], ids=["48x32", "49x33_padded"])
def test_nh_step_2x2_matches_single_block(steps, which):
    spec = (NH, NH_PADDED)[which]
    ref, rows = _single(spec)
    for r, per_rank in enumerate(steps):
        state, drows = per_rank[which]
        _compare(_flat(state), ref)
        assert np.array_equal(drows, steps[0][which][1]), r
    drows = steps[0][which][1]
    np.testing.assert_allclose(drows[:, 1:], rows[:, 1:], rtol=MESH_NH_TOL,
                               atol=1e-300)
    if which == 1:
        cfg = ranks.build(spec)[0]
        cfg_p = dist.pad_for_mesh(cfg, dist.Mesh(dist.rank_grid(4)))
        assert (cfg_p.pad_n, cfg_p.pad_e) == (1, 1)


def test_nh_one_block_mesh_is_bitwise_single_block(tmp_path):
    ref, rows = _single(NH)
    (per_rank,) = dist.launch(ranks.run_cases, 1, "gloo", "cpu",
                              args=([NH], NSTEPS), timeout=TIMEOUT,
                              store_dir=str(tmp_path))
    ((state, drows),) = per_rank
    state = _flat(state)
    assert set(state) == set(ref)
    for name, a in ref.items():
        assert np.array_equal(state[name], a), name
    assert np.array_equal(drows, rows)
