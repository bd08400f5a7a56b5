"""The port's distributed stepping (roms_tpu_torch/parallel/dist.py) on
the CPU, in float64, against the port's own single block:

(a) the mesh layout against the JAX package's layout functions (no step
    compiles): `mesh_shape` against `make_mesh(n)` for n = 1..8 on the
    virtual CPU devices, the multi-node rule against `_multihost_mesh`,
    `to_block`/`join_blocks` against `to_blocked(put=False)`/
    `from_blocked` with the mesh-divisibility pad, exactly;
(b) gloo ranks spawned on this host (`dist.launch`, a FileStore under
    tmp_path, a timeout on every group and every join):
    - `HaloExchange` and `halo_group` on a 2x2 mesh against
      `periodic_fill`/`mixed_fill` of the global array, bitwise, for each
      periodicity (as tests/test_distributed.py:67 for the JAX package);
    - bench_production 48x32x16 nt=4 with the budgets and the upscale
      capture, 3 steps on 2x2 ranks against the single block: the
      fields tests/test_distributed.py compares (zeta ubar vbar u v t hz)
      and every other state field and budget term at
      1e-12 * max(1, max|ref|) over the interior, the arrays
      bench_production's CONDITIONED_TOL or OPTION_CONDITIONED_TOL name
      at 1e-8, and so the four boundary strips (each is the face volume
      flux flx_u or flx_v, which those hold at 1e-8, times a tracer); the
      momentum terms on the reference's update range, as
      tests/test_distributed.py:279-293 holds the JAX package's; the
      tracer budget's terms at 1e-8 of their own largest value.  The JAX
      package's own mesh run misses 1e-12 * max(1, max|ref|) on this case
      in the tracer budget (up to 5.5e-11) and in the north strip
      (3.8e-12), and reaches 1.7e-9 of its own largest value in the
      budget's vmix term, whose round-off comes from the Hz-weighted
      content it is a difference of (tests/jax_dist_nh.py); so 1e-8, with
      a misplaced release or a wrong halo several orders above it; the
      diagnostics rows: the last bitwise that of `compute_diag` on the
      gathered state, all within round-off of the single block's;
    - the same on a 1x1 mesh: every field and row bitwise equal to
      `driver.run`;
    - Rivers_ana (river sources, land, KPP) and production 48x32x8 with
      mCDR point releases and a 3-argument bulk-forcing hook (the
      releases made block-local by the step's offsets, the hook reading
      the gathered surface view) on 2x2 ranks against the single block,
      at the same bounds;
    - a grid the mesh does not divide (49x33, padded by one row and one
      column) against its single block;
    - the distributed diagnostics bitwise equal to `compute_diag` on the
      Filament grid (canonical: 64x64) and on 67x45;
    - the distributed particle step bitwise equal to `advance_particles`;
    - a NaN in one rank's block makes every rank raise BlowupError, with
      no hang;
    - `dryrun_multichip(4)` in float32;
    - a rank runs on its card unless asked for the CPU, and a tensor on
      another kind of device than the rank's raises.
The non-hydrostatic projection on a mesh: tests/test_torch_dist_nh.py.
"""

import dataclasses

import numpy as np
import pytest
import torch

from roms_tpu.cases import obc_basin as jbasin
from roms_tpu.parallel.dist import _multihost_mesh, from_blocked
from roms_tpu.parallel.dist import make_mesh as jmake_mesh
from roms_tpu.parallel.dist import pad_for_mesh as jpad_for_mesh
from roms_tpu.parallel.dist import to_blocked

from roms_tpu_torch import bridge
from roms_tpu_torch.cases import bench_production
from roms_tpu_torch.diag import compute_diag
from roms_tpu_torch.driver import run
from roms_tpu_torch.ops.weights import set_weights
from roms_tpu_torch.parallel import dist
from roms_tpu_torch.particles import advance_particles, seed_particles
from roms_tpu_torch.stepper import step

import torch_dist_ranks as ranks
from torch_helpers import np_tree, port_cfg

torch.set_num_threads(1)

H = 2
TIMEOUT = 300.0
PRODUCTION = ("bench_production", dict(
    nx=48, ny=32, nz=16, nt=4, tracer_diagnostics=True, uv_diagnostics=True,
    upscale_output=True), {})
RIVERS = ("rivers_ana", {}, {})
FORCED = ("bench_production", dict(nx=48, ny=32, nz=8, nt=2), {})
MAIN = ("zeta", "ubar", "vbar", "u", "v", "t", "hz")
TOL = 1e-12
LOOSE = 1e-8
# the tracer budget's terms against their own largest value (see the
# module docstring)
BUDGET = 1e-8
# the arrays the reference itself moves beyond STEP_TOL under round-off
CONDITIONED = set(bench_production.CONDITIONED_TOL).union(
    *bench_production.OPTION_CONDITIONED_TOL.values())


def _launch(tmp_path, fn, n, *args, timeout=TIMEOUT):
    return dist.launch(fn, n, "gloo", "cpu", args=args, timeout=timeout,
                       store_dir=str(tmp_path))


def _flat(d, pre=""):
    out = {}
    for k, v in d.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{pre}{k}."))
        elif v is not None:
            out[pre + k] = np.asarray(v)
    return out


def _region(name):
    """The compared region: the interior; the momentum terms on the
    reference's update range istrU..iend / jstrV..jend (the first
    staggered line is a boundary point whose interior-formula value the
    boundary conditions overwrite, and whose stencil reaches past the
    ghosts); the strips along their edge."""
    if name.startswith("upscale."):
        return (Ellipsis, slice(H, -H))
    if name.startswith("uv_budget.u."):
        return (Ellipsis, slice(H, -H), slice(H + 1, -H))
    if name.startswith("uv_budget.v."):
        return (Ellipsis, slice(H + 1, -H), slice(H, -H))
    return (Ellipsis, slice(H, -H), slice(H, -H))


def _compare(got, ref):
    """Every array of `ref` (a flat dict) against `got` as the module
    docstring says; returns {name: relative error}."""
    errs = {}
    for name, a in ref.items():
        if a.ndim < 2 and not name.startswith("upscale."):
            assert np.array_equal(got[name], a), name
            continue
        sl = _region(name)
        a, b = a[sl], got[name][sl]
        if name.startswith("t_budget."):
            scale, tol = float(np.abs(a).max()), BUDGET
        else:
            scale = max(1.0, float(np.abs(a).max()))
            tol = LOOSE if (name in CONDITIONED
                            or name.startswith("upscale.")) else TOL
        err = float(np.abs(b - a).max()) / scale
        errs[name] = err
        assert np.isfinite(b).all() and err <= tol, (name, err, tol)
    return errs


# ------------------------------------------------------------------ (a)
@pytest.mark.parametrize("n", range(1, 9))
def test_mesh_shape_matches_make_mesh(n):
    assert dist.mesh_shape(n) == jmake_mesh(n).devices.shape
    assert dist.rank_grid(n).tolist() == np.arange(n).reshape(
        jmake_mesh(n).devices.shape).tolist()


@pytest.mark.parametrize("dcn_axis", ["y", "x"])
def test_multinode_layout_matches_multihost_mesh(dcn_axis):
    @dataclasses.dataclass(frozen=True)
    class FakeDev:
        process_index: int
        id: int

    for nnodes, per in ((2, 4), (4, 2), (3, 2)):
        devs = [FakeDev(p, p * per + i) for p in range(nnodes)
                for i in range(per)]
        want = np.vectorize(lambda d: d.id)(
            _multihost_mesh(devs, nnodes, dcn_axis).devices)
        got = dist.rank_grid(nnodes * per, nnodes, dcn_axis)
        assert got.tolist() == want.tolist()


def test_blocks_match_jax_layout():
    """67x45 on a 2x4 mesh (padded by one row and one column): each
    rank's block is the JAX package's blocked array's block, and the
    blocks join back to `from_blocked`'s arrays, every leaf exactly."""
    cfg = jbasin.config("radiating").replace(nx=67, ny=45, nz=4)
    jg, jst, jfrc = jbasin.setup(cfg)
    jmesh = jmake_mesh(8)
    assert jmesh.devices.shape == (2, 4)
    jcfg_p = jpad_for_mesh(cfg, jmesh)
    pads = (jcfg_p.pad_n, jcfg_p.pad_e)
    assert pads == (1, 1)
    assert dist.pad_for_mesh(port_cfg(cfg), dist.Mesh(dist.rank_grid(8))) == \
        port_cfg(jcfg_p)
    trees = {"state": (jst, bridge.state_from_numpy),
             "forcing": (jfrc, bridge.forcing_from_numpy),
             "grid": (jg, bridge.grid_from_numpy)}
    for what, (jtree, to_port) in trees.items():
        blocked = _flat(np_tree(to_blocked(jtree, jmesh, H, put=False,
                                           pads=pads)))
        joined = _flat(np_tree(from_blocked(
            to_blocked(jtree, jmesh, H, put=False, pads=pads), jmesh, H,
            pads=pads)))
        ttree = to_port(np_tree(jtree), dtype=torch.float64, device="cpu")
        blocks = []
        for r in range(8):
            blk = dist.to_block(ttree, dist.Mesh(dist.rank_grid(8), rank=r),
                                H, pads)
            blocks.append(blk)
            iy, ix = divmod(r, 4)
            for name, a in _flat(bridge.to_numpy(blk)).items():
                b = blocked[name]
                kind = dist._leaf_kind(name.split(".")[-1], a)
                if kind in ("spatial", "edge_y"):
                    ax = -2 if kind == "spatial" else -1
                    m = a.shape[ax]
                    b = np.take(b, range(iy * m, (iy + 1) * m), axis=ax)
                if kind in ("spatial", "edge_x"):
                    m = a.shape[-1]
                    b = b[..., ix * m:(ix + 1) * m]
                assert np.array_equal(a, b), (what, name, r)
        back = _flat(bridge.to_numpy(dist.join_blocks(blocks,
                                                      np.arange(8).reshape(
                                                          2, 4), H, pads)))
        assert set(back) == set(joined)
        for name, a in joined.items():
            assert np.array_equal(back[name], a), (what, name)


# ------------------------------------------------------------------ (b)
def test_halo_exchange_matches_single_block_fills(tmp_path):
    shape = (3, 16 + 2 * H, 24 + 2 * H)
    got = _launch(tmp_path, ranks.halo, 4, shape, 5)
    want = ranks.reference_fills(shape, 5)
    for r, per_rank in enumerate(got):
        for (ew, ns), g, w in zip(ranks.FILLS, per_rank, want):
            for name, ref in (("f", w), ("g0", w[0]), ("g1", w[1:])):
                assert np.array_equal(g[name], ref), (r, ew, ns, name)


def _single(spec, nsteps):
    cfg, grid, st, frc = ranks.build(spec)
    s, rows = run(grid, st, frc, cfg, nsteps=nsteps)
    return _flat(bridge.to_numpy(s)), rows


def _check_rows(spec, state, drows, rows):
    """The mesh run's diagnostics: the last row bitwise that of
    `compute_diag` on its gathered state; every row within round-off of
    the single block's: energies rtol 1e-13 and the advective Courant
    number 1e-12, as tests/test_distributed.py:169-173; the vertical one,
    read from `we`, at its conditioning (bench_production.CONDITIONED_TOL:
    1e-8)."""
    cfg, grid, _, _ = ranks.build(spec)
    st = bridge.state_from_numpy(state, dtype=torch.float64, device="cpu")
    d = compute_diag(st, grid, cfg)
    assert [float(d.avke), float(d.avke2b), float(d.cu_adv),
            float(d.cu_w)] == drows[-1, 1:].tolist()
    np.testing.assert_allclose(drows[:, 1:3], rows[:, 1:3], rtol=1e-13,
                               atol=1e-300)
    np.testing.assert_allclose(drows[:, 3], rows[:, 3], rtol=1e-12)
    np.testing.assert_allclose(drows[:, 4], rows[:, 4], rtol=LOOSE)


def test_production_2x2_matches_single_block(tmp_path):
    ref, rows = _single(PRODUCTION, 3)
    got = _launch(tmp_path, ranks.run_case, 4, PRODUCTION, 3)
    for r, (state, drows) in enumerate(got):
        errs = _compare(_flat(state), ref)
        assert max(errs[k] for k in MAIN) <= TOL
        assert np.array_equal(drows, got[0][1]), r
    _check_rows(PRODUCTION, got[0][0], got[0][1], rows)
    assert {k for k in ref if k.startswith("upscale.")} == {
        "upscale.west", "upscale.east", "upscale.south", "upscale.north"}


def test_river_sources_2x2_match_single_block(tmp_path):
    """Rivers_ana (land, river sources on faces, nonlinear EOS, KPP, a
    closed basin; tests/test_distributed.py:129 holds the JAX package's)
    on 2x2 ranks against the single block, 3 steps."""
    ref, rows = _single(RIVERS, 3)
    got = _launch(tmp_path, ranks.run_case, 4, RIVERS, 3)
    for r, (state, drows) in enumerate(got):
        errs = _compare(_flat(state), ref)
        assert max(errs[k] for k in MAIN) <= TOL
        assert np.array_equal(drows, got[0][1]), r
    _check_rows(RIVERS, got[0][0], got[0][1], rows)


def test_cdr_releases_and_bulk_hook_2x2_match_single_block(tmp_path):
    """mCDR point releases at global cells (inside blocks, on both sides
    of the block boundaries and their corner, two in one cell, by the
    physical edges), made block-local on each rank by the step's offsets,
    and a 3-argument bulk-forcing hook that reads the surface view each
    rank gathers from the blocks: 3 steps on 2x2 ranks against the single
    block with the same releases and hook."""
    cfg, grid, st, frc, hook = ranks.forced(FORCED)
    s, rows = run(grid, st, frc, cfg, nsteps=3, forcing_fn=hook)
    ref = _flat(bridge.to_numpy(s))
    got = _launch(tmp_path, ranks.run_forced, 4, FORCED, 3)
    for r, (state, drows) in enumerate(got):
        errs = _compare(_flat(state), ref)
        assert max(errs[k] for k in MAIN) <= TOL
        assert np.array_equal(drows, got[0][1]), r
    _check_rows(FORCED, got[0][0], got[0][1], rows)


def test_one_block_mesh_is_bitwise_single_block(tmp_path):
    ref, rows = _single(PRODUCTION, 3)
    (state, drows), = _launch(tmp_path, ranks.run_case, 1, PRODUCTION, 3)
    state = _flat(state)
    assert set(state) == set(ref)
    for name, a in ref.items():
        assert np.array_equal(state[name], a), name
    assert np.array_equal(drows, rows)


def test_nondivisible_grid_pads_onto_the_mesh(tmp_path):
    spec = ("bench_production", dict(nx=49, ny=33, nz=8, nt=2), {})
    cfg = ranks.build(spec)[0]
    cfg_p = dist.pad_for_mesh(cfg, dist.Mesh(dist.rank_grid(4)))
    assert (cfg_p.pad_n, cfg_p.pad_e) == (1, 1)
    ref, rows = _single(spec, 3)
    (state, drows), *_ = _launch(tmp_path, ranks.run_case, 4, spec, 3)
    flat = _flat(state)
    assert flat["zeta"].shape == ref["zeta"].shape
    errs = _compare(flat, ref)
    assert max(errs[k] for k in MAIN) <= TOL
    _check_rows(spec, state, drows, rows)


@pytest.mark.parametrize("spec", [
    ("filament", dict(nz=8), {}),
    ("bench_production", dict(nx=67, ny=45, nz=6, nt=2), {})],
    ids=["filament_64x64", "production_67x45"])
def test_distributed_diag_is_bitwise(tmp_path, spec):
    cfg, grid, st, frc = ranks.build(spec)
    w1, w2, _ = set_weights(cfg.ndtfast)
    st = step(st, frc, grid, w1, w2, cfg, first_step=True)
    want = [float(x) for x in compute_diag(st, grid, cfg)]
    got = _launch(tmp_path, ranks.diag, 4, spec, bridge.to_numpy(st))
    for r, d in enumerate(got):
        assert d == want, (r, d, want)


def test_distributed_particles_are_bitwise(tmp_path):
    """Smooth random fields on the production grid (open edges, land),
    particles over the whole domain, on the block boundaries, outside it,
    at NaN and inactive: 3 steps on 2x2 ranks against advance_particles."""
    spec = ("bench_production", dict(nx=48, ny=32, nz=8, nt=2), {})
    cfg, grid, st, _ = ranks.build(spec)
    rng = np.random.default_rng(11)
    nz, jy, ix = st.hz.shape
    k = np.arange(nz + 1)[:, None, None] / nz
    j = np.arange(jy)[None, :, None] / cfg.ny
    i = np.arange(ix)[None, None, :] / cfg.nx

    def wave(amp, nk=nz):
        ph = rng.uniform(0, 2 * np.pi, 3)
        return amp * (np.sin(2 * np.pi * i + ph[0])
                      * np.cos(2 * np.pi * j + ph[1])
                      * np.cos(np.pi * k[:nk] + ph[2]))

    fields = {"u": wave(0.5), "v": wave(0.4), "we": wave(3e3, nz + 1),
              "wi": wave(1e3, nz + 1), "hz": st.hz.numpy()}
    n = 400
    px = np.concatenate([rng.uniform(-1.0, cfg.nx + 1.0, n - 8),
                         [23.5, 23.49, 23.51, -0.5, cfg.nx - 0.5, np.nan,
                          10.0, 30.0]])
    py = np.concatenate([rng.uniform(-1.0, cfg.ny + 1.0, n - 8),
                         [15.5, 15.5, 15.49, 3.0, 3.0, 3.0, 15.51, 40.0]])
    pz = rng.uniform(-0.5, nz + 0.5, n)
    ps = seed_particles(px, py, pz, npart_max=n + 8, device="cpu")
    ps_np = bridge.to_numpy(ps)
    t = {name: torch.as_tensor(v) for name, v in fields.items()}
    want = ps
    for _ in range(3):
        want = advance_particles(want, t["u"], t["v"], t["we"], t["wi"],
                                 t["hz"], grid, cfg)
    want = bridge.to_numpy(want)
    got = _launch(tmp_path, ranks.particles, 4, spec, fields, ps_np, 3)
    for r, g in enumerate(got):
        for name, a in want.items():
            assert np.array_equal(g[name], a, equal_nan=True), (r, name)


def test_nan_on_one_rank_fails_every_rank(tmp_path):
    """NaN in u at one point of rank 3's block (it enters the diagnostics
    with the first step, through u_prev): the diagnostics are gathered,
    so every rank sees it and raises at the same row, none hangs."""
    spec = ("obc:radiating", dict(nx=24, ny=20, nz=6), {})
    msgs = _launch(tmp_path, ranks.blowup, 4, spec, (18, 20), timeout=120.0)
    assert msgs[0] is not None and "BLOWUP at step 1" in msgs[0], msgs
    assert all(m == msgs[0] for m in msgs), msgs


def test_dryrun_multichip_four_ranks_f32():
    dist.dryrun_multichip(4, device="cpu", backend="gloo", timeout=TIMEOUT)


def test_ranks_run_on_the_card_unless_asked(tmp_path):
    """A rank's device defaults to its card (cuda:LOCAL_RANK), for gloo
    as for NCCL; without a card that raises, naming device='cpu'.  A
    tensor on another kind of device than the rank's raises in
    `to_block` instead of moving the run."""
    store = torch.distributed.FileStore(str(tmp_path / "store"), 1)
    if torch.cuda.is_available():
        assert dist._rank_device(None, 0) == torch.device("cuda", 0)
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            dist.init_distributed("gloo", store, rank=0, world_size=1)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            dist.launch(ranks.run_case, 1, "gloo", args=(PRODUCTION, 1))
    assert dist._rank_device("cpu", 0) == torch.device("cpu")
    card = dist.Mesh(dist.rank_grid(4), device=torch.device("cuda", 0))
    with pytest.raises(ValueError, match="zeta is on cpu"):
        dist.to_block({"zeta": torch.zeros(20, 28)}, card, H)
    with pytest.raises(ValueError, match="runs on cpu"):
        dist.to_block({"zeta": torch.zeros(20, 28, device="meta")},
                      dist.Mesh(dist.rank_grid(4)), H)


def test_nccl_refuses_two_ranks_on_one_card():
    with pytest.raises(ValueError, match="same GPU"):
        dist.launch(ranks.run_case, 2, "nccl", "cuda:0",
                    args=(PRODUCTION, 1))
