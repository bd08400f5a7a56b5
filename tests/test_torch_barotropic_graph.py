"""The barotropic fast loop as one CUDA graph (`ops/barotropic.py`).

On the CPU (float64, one thread):
(a) the cached interior masks equal the host construction they replace,
    for both staggers, on a single block, on every ownership pattern of a
    mesh block and with pad_e/pad_n; a second call hands out the same
    tensor, the cache holds its grid, and the least recently used entry
    goes beyond `MASK_CACHE`;
(b) the CPU and a 1x1 gloo mesh take the eager path: `graph_stats`
    counts eager calls and no capture or replay, and `graph_rule` refuses
    the mesh's own arguments even on a CUDA device;
(c) `fast_loop` returns bitwise what `_fast_loop_eager` returns.

On the card (marked `h100`; each test skips where there is no CUDA
device, deciding inside the test), at small doubly periodic
Filament-like and production-like (4 open Flather sides, masked) grids:
three consecutive calls with new zeta0, rufrc and boundary data are
bitwise `_fast_loop_eager`, with one capture and two replays; writing
into a returned tensor changes nothing in the next call's result; a new
shape makes a new capture.  On the card this file runs without the
repository's conftest (which loads JAX):

    python -m pytest --noconftest -p no:cacheprovider \\
        tests/test_torch_barotropic_graph.py
"""

import dataclasses
import gc
import itertools
import weakref

import numpy as np
import pytest
import torch
import torch.distributed as tdist

from roms_tpu_torch.cases import bench_production as tbp
from roms_tpu_torch.cases import filament as tfilament
from roms_tpu_torch.driver import run, run_distributed
from roms_tpu_torch.ops import barotropic
from roms_tpu_torch.ops.weights import set_weights
from roms_tpu_torch.parallel import dist
from roms_tpu_torch.parallel.halo import HaloExchange, make_halo_fill
from roms_tpu_torch.state import BoundaryData

torch.set_num_threads(1)

BRY_ALL = tuple(f.name for f in dataclasses.fields(BoundaryData))
ARGS = ("zeta0", "ubar0", "vbar0", "rufrc", "rvfrc", "rho_s", "rho_a",
        "du_avg1_in", "dv_avg1_in", "du_avg2_in", "dv_avg2_in")

CASES = {
    "filament": (tfilament,
                 tfilament.config().replace(nx=16, ny=12, nz=4, ndtfast=6)),
    "production": (tbp, tbp.config(nx=10, ny=8, nz=4, nt=3)),
}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the test runs only on the card")
    return torch.device("cuda")


@pytest.fixture(autouse=True)
def fresh_caches():
    barotropic._graphs.clear()
    barotropic._masks.clear()
    for k in barotropic.graph_stats:
        barotropic.graph_stats[k] = 0
    yield
    barotropic._graphs.clear()
    barotropic._masks.clear()


def _mask_on_host(shape, cfg, stagger, own):
    """The construction the cached masks replace, written out again."""
    jy, ix = shape
    m = np.ones(shape, bool)
    wlim = 3 if stagger == "u" else 2
    slim = 3 if stagger == "v" else 2
    if not cfg.ew_periodic:
        if own[0]:
            m[:, :wlim] = False
        if own[1]:
            m[:, ix - 2 - cfg.pad_e:] = False
    if not cfg.ns_periodic:
        if own[2]:
            m[:slim, :] = False
        if own[3]:
            m[jy - 2 - cfg.pad_n:, :] = False
    return m


class _Block:
    """What `_interior_mask` reads of a grid: its device and ownership."""

    def __init__(self, own=(None, None, None, None)):
        self.h = torch.zeros(1)
        self.own_w, self.own_e, self.own_s, self.own_n = own


@pytest.mark.parametrize("pads", [(0, 0), (1, 3)])
@pytest.mark.parametrize("periodic", [(False, False), (True, False),
                                      (False, True)])
def test_cached_masks_equal_the_host_construction(periodic, pads):
    cfg = tbp.config(nx=10, ny=8, nz=4, nt=3).replace(
        ew_periodic=periodic[0], ns_periodic=periodic[1],
        pad_e=pads[0], pad_n=pads[1])
    shape = (cfg.ny + 2 * cfg.halo + pads[1], cfg.nx + 2 * cfg.halo + pads[0])
    owns = [(None,) * 4] + list(itertools.product((False, True), repeat=4))
    for own in owns:
        block = _Block(own)
        for stagger in "uv":
            got = barotropic._interior_mask(shape, cfg, stagger, block)
            want = _mask_on_host(shape, cfg, stagger,
                                 [o is None or o for o in own])
            assert got.dtype == torch.bool and got.device == block.h.device
            assert np.array_equal(got.numpy(), want), (own, stagger)
            assert barotropic._interior_mask(shape, cfg, stagger,
                                             block) is got


def test_mask_cache_holds_its_grid_and_stays_small():
    cfg = CASES["production"][1]
    shape = (cfg.ny + 4, cfg.nx + 4)
    block = _Block()
    first = barotropic._interior_mask(shape, cfg, "u", block)
    alive = weakref.ref(block)
    del block
    gc.collect()
    assert alive() is not None          # the entry holds the grid
    others = [_Block() for _ in range(barotropic.MASK_CACHE)]
    for b in others:
        barotropic._interior_mask(shape, cfg, "u", b)
    gc.collect()
    assert alive() is None              # evicted, so the grid is freed
    assert len(barotropic._masks) == barotropic.MASK_CACHE
    assert np.array_equal(first.numpy(),
                          _mask_on_host(shape, cfg, "u", [True] * 4))


def _setup(case, dtype=torch.float64, device="cpu", **change):
    mod, cfg = CASES[case]
    cfg = cfg.replace(**change)
    grid, st, frc = mod.setup(cfg, dtype=dtype, device=device)
    return cfg, grid, st, frc


@pytest.mark.parametrize("case", sorted(CASES))
def test_cpu_and_mesh_take_the_eager_path(case, tmp_path, monkeypatch):
    cfg, grid, st, frc = _setup(case)
    run(grid, st, frc, cfg, 2, collect_diag=False)
    assert barotropic.graph_stats == {"captures": 0, "replays": 0,
                                      "eager": 2}

    seen = []
    eager = barotropic.fast_loop

    def record(*a):
        seen.append((a[-3], a[-1]))     # the call's grid and halo fill
        return eager(*a)
    monkeypatch.setattr(barotropic, "fast_loop", record)
    store = tdist.FileStore(str(tmp_path / "store"), 1)
    mesh = dist.init_distributed("gloo", store, rank=0, world_size=1,
                                 device="cpu")
    try:
        run_distributed(grid, st, frc, cfg, mesh, 2, collect_diag=False)
    finally:
        tdist.destroy_process_group()
    assert barotropic.graph_stats == {"captures": 0, "replays": 0,
                                      "eager": 4}
    assert len(seen) == 2
    cuda = torch.device("cuda")
    for mgrid, halo in seen:
        assert isinstance(halo, HaloExchange)
        assert all(getattr(mgrid, f"own_{e}") is True for e in "wesn")
        # the mesh's block and exchange keep it eager on any device
        assert not barotropic.graph_rule(cuda, mgrid, make_halo_fill(cfg))
        assert not barotropic.graph_rule(cuda, grid, halo)
    assert not barotropic.graph_rule(torch.device("cpu"), grid,
                                     make_halo_fill(cfg))


def _loop_inputs(cfg, grid, st, frc, seed):
    """Arguments of one fast_loop call: the state's barotropic fields plus
    seeded noise, seeded 3D forcing and density terms, and the boundary
    data scaled by a seeded factor."""
    g = torch.Generator().manual_seed(seed)
    dtype, device = st.zeta.dtype, st.zeta.device

    def noise(scale, like):
        return like + scale * torch.randn(like.shape, generator=g,
                                          dtype=torch.float64).to(
            dtype=dtype, device=device)
    zero = torch.zeros_like(st.zeta)
    bry = frc.bry
    if bry is not None:
        s = 1.0 + 0.1 * seed
        bry = bry.replace(**{f: s * getattr(bry, f)
                             for f in BRY_ALL if getattr(bry, f) is not None})
    return dict(
        zeta0=noise(1e-2, st.zeta), ubar0=noise(1e-2, st.ubar),
        vbar0=noise(1e-2, st.vbar), rufrc=noise(1e-4, zero),
        rvfrc=noise(1e-4, zero), rho_s=noise(1e-3, zero),
        rho_a=noise(1e-3, zero), forcing=frc.replace(bry=bry),
        du_avg1_in=noise(1.0, zero), dv_avg1_in=noise(1.0, zero),
        du_avg2_in=noise(1.0, zero), dv_avg2_in=noise(1.0, zero))


def _call(fn, cfg, grid, args):
    w1, w2, _ = set_weights(cfg.ndtfast)
    return fn(**args, w1=w1, w2=w2, grid=grid, cfg=cfg,
              halo_fill=make_halo_fill(cfg))


def _assert_bitwise(got, ref, what):
    assert set(got) == set(ref)
    for k in ref:
        assert torch.equal(got[k], ref[k]), f"{what}: {k}"


@pytest.mark.parametrize("case", sorted(CASES))
def test_fast_loop_on_the_cpu_is_the_eager_loop(case):
    cfg, grid, st, frc = _setup(case)
    args = _loop_inputs(cfg, grid, st, frc, 1)
    _assert_bitwise(_call(barotropic.fast_loop, cfg, grid, args),
                    _call(barotropic._fast_loop_eager, cfg, grid, args),
                    case)
    assert barotropic.graph_stats["eager"] == 1


@pytest.mark.parametrize("case", sorted(CASES))
def test_the_graphs_forcing_holds_what_the_loop_reads(case):
    """The loop on the forcing a graph captures with (FORCING_READ and
    BRY_READ alone, every other field None) is the loop on the whole
    forcing, with every boundary field of the case present."""
    cfg, grid, st, frc = _setup(case)
    args = _loop_inputs(cfg, grid, st, frc, 1)
    if case == "production":
        assert all(getattr(frc.bry, f) is not None
                   for f in BRY_ALL if not f.startswith("ub_"))
    leaves = barotropic._leaves([args[k] for k in ARGS], args["forcing"])
    arrays, forcing = barotropic._unflatten(leaves,
                                            args["forcing"].bry is not None)
    assert forcing.sustr is None and forcing.stflx is None
    part = dict(zip(ARGS, arrays), forcing=forcing)
    _assert_bitwise(_call(barotropic._fast_loop_eager, cfg, grid, part),
                    _call(barotropic._fast_loop_eager, cfg, grid, args),
                    case)


@pytest.mark.h100
@pytest.mark.parametrize("case", sorted(CASES))
def test_replay_is_the_eager_loop_on_the_card(case, card):
    cfg, grid, st, frc = _setup(case, torch.float32, card)
    assert barotropic.graph_rule(card, grid, make_halo_fill(cfg))
    prev = None
    for k in range(3):
        args = _loop_inputs(cfg, grid, st, frc, k + 2)
        got = _call(barotropic.fast_loop, cfg, grid, args)
        if prev is not None:
            for t in prev.values():       # the caller owns what it got
                t.fill_(1.0e9)
        ref = _call(barotropic._fast_loop_eager, cfg, grid, args)
        _assert_bitwise(got, ref, f"{case} call {k + 1}")
        prev = got
    assert barotropic.graph_stats == {"captures": 1, "replays": 2,
                                      "eager": 0}

    # another shape: another graph, and the first is kept
    cfg2, grid2, st2, frc2 = _setup(case, torch.float32, card,
                                    nx=cfg.nx + 2)
    args = _loop_inputs(cfg2, grid2, st2, frc2, 7)
    _assert_bitwise(_call(barotropic.fast_loop, cfg2, grid2, args),
                    _call(barotropic._fast_loop_eager, cfg2, grid2, args),
                    f"{case} new shape")
    assert barotropic.graph_stats["captures"] == 2
    assert len(barotropic._graphs) == 2
