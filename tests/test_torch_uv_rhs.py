"""The momentum r.h.s. kernel (`ops/cuda_uv_rhs.py`, `csrc/uv_rhs.cu`).

On the CPU (float64, one thread): the launch planner (every accepted
(type, nz) fits one block's shared memory; the benchmark's depths keep
the most threads an SM), the step's dispatch (`stepper._uv_rhs` calls
the wrapper, which takes the plain version itself for a CPU tensor, a
padded grid or the budget's split) and the counter.
tests/test_torch_column_launch.py holds the gate, the nz range and the
device rule of all four kernels, and tests/test_torch_kernels.py the
plain version to the JAX package's `stepper._uv_rhs`.

On the card (marked `h100`; each test skips where there is no CUDA
device, deciding inside the test): the kernel against its plain version
on the random harness (`_harness.uv_rhs_inputs`), whole arrays, ghost
lines included, in float64 at rtol = atol = 1e-12 and in float32 at rtol
1e-5, atol 1e-5 * max|plain| (chip_smoke.py's bound: the two round the
same operations in another order, and nvcc contracts a*b+c into FMA):
both schemes; production's flags (masking, CURVGRID, four open edges)
and Filament's (doubly periodic, no CURVGRID); a mesh block's partial
ownership; ragged planes; nz = 60 and the kernel's deepest column.  On
the card this file runs without the repository's conftest (which loads
JAX):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_uv_rhs.py
"""

import types

import numpy as np
import pytest
import torch

from roms_tpu_torch import stepper
from roms_tpu_torch.config import AdvScheme
from roms_tpu_torch.ops import _build, _harness, cuda_uv_rhs

torch.set_num_threads(1)

FIELDS = ("u", "v", "flx_u", "flx_v", "hz", "we")


def _inputs(dtype=torch.float64, device="cpu", own=None, **kw):
    cfg, d = _harness.uv_rhs_inputs(**kw)
    x = {k: torch.as_tensor(v, dtype=dtype, device=device)
         for k, v in d.items()}
    own = own or (None,) * 4
    grid = types.SimpleNamespace(
        **{k: x[k] for k in ("fomn", "dndx", "dmde", "umask", "vmask")},
        own_w=own[0], own_e=own[1], own_s=own[2], own_n=own[3])
    return cfg, [x[k] for k in FIELDS], grid


@pytest.mark.parametrize("elem", [4, 8])
def test_every_accepted_nz_fits_one_block(elem):
    for nz in range(2, cuda_uv_rhs.NZ_MAX + 1):
        tj, smem = cuda_uv_rhs.launch_plan(elem, nz)
        assert smem == cuda_uv_rhs.smem_bytes(tj, nz, elem)
        assert smem <= _build.SMEM_BLOCK
        assert 2 * cuda_uv_rhs.TILE_I * tj <= cuda_uv_rhs.THREADS_SM[elem]


@pytest.mark.parametrize("nz, tj, threads", [(60, 7, 448), (50, 7, 448)])
def test_benchmark_depths_keep_the_most_threads(nz, tj, threads):
    """nz = 60 (Filament and production at bench width) and 50 (USWC) in
    float32: the tallest tile among those that keep the most threads an
    SM, one block of tj rows."""
    got, smem = cuda_uv_rhs.launch_plan(4, nz)
    assert got == tj
    blocks = _build.SMEM_SM // (smem + _build.SMEM_RESERVED)
    assert blocks * 2 * cuda_uv_rhs.TILE_I * tj == threads
    for other in range(1, 8):
        b = cuda_uv_rhs.smem_bytes(other, nz, 4)
        if b <= _build.SMEM_BLOCK:
            n = min(_build.SMEM_SM // (b + _build.SMEM_RESERVED),
                    cuda_uv_rhs.THREADS_SM[4] // (64 * other))
            assert n * 64 * other <= threads


@pytest.mark.parametrize("parts, change, takes", [
    (False, {}, ["uv_rhs", "uv_rhs_plain"]),
    (True, {}, ["uv_rhs", "uv_rhs_plain"]),
    (False, dict(pad_e=1), ["uv_rhs", "uv_rhs_plain"]),
    (False, dict(nz=cuda_uv_rhs.NZ_MAX + 1), ["uv_rhs", "uv_rhs_plain"]),
])
def test_step_dispatch(monkeypatch, parts, change, takes):
    """`stepper._uv_rhs` calls the wrapper for every call, the budget's
    split included, whatever the configuration: the wrapper decides its
    own path (here, on the CPU, the plain version, which alone returns the
    Coriolis part)."""
    cfg, args, grid = _inputs()
    cfg = cfg.replace(**change)
    seen = []
    for name in ("uv_rhs", "uv_rhs_plain"):
        real = getattr(cuda_uv_rhs, name)

        def record(*a, _name=name, _real=real, **kw):
            seen.append(_name)
            return _real(*a, **kw)
        monkeypatch.setattr(cuda_uv_rhs, name, record)
    out = stepper._uv_rhs(*args, grid, cfg, AdvScheme.UPSTREAM3, parts=parts)
    assert seen == takes
    assert len(out) == (4 if parts else 2)


def test_counters_on_the_cpu():
    """A CPU tensor takes the plain version: no launch, one plain call a
    call; the budget's split returns the Coriolis part beside the sum."""
    cfg, args, grid = _inputs(seed=4)
    stats = _build.kernel_stats["uv_rhs"]
    before = stats["launches"], stats["plain"]
    ru, rv = cuda_uv_rhs.uv_rhs(*args, grid, cfg, AdvScheme.CENTERED4)
    assert (stats["launches"], stats["plain"]) == (before[0], before[1] + 1)
    ru2, rv2, cu, cv = cuda_uv_rhs.uv_rhs(
        *args, grid, cfg, AdvScheme.CENTERED4, parts=True)
    assert (stats["launches"], stats["plain"]) == (before[0], before[1] + 2)
    assert torch.equal(ru, ru2) and torch.equal(rv, rv2)
    assert cu.abs().max() > 0 and cv.abs().max() > 0


# ---------------------------------------------------------------- the card
@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the test runs only on the card")
    return torch.device("cuda")


# (harness options, edge ownership): production's flags; Filament's;
# a mesh block owning the west and north edges, and the east and south;
# planes that are whole tiles in neither direction; nz = 60 and NZ_MAX
CARD_CASES = {
    "production": (dict(), None),
    "filament": (dict(curvgrid=False, ew_periodic=True, ns_periodic=True),
                 None),
    "own_wn": (dict(seed=2), (True, False, False, True)),
    "own_es": (dict(masking=False, seed=3), (False, True, True, False)),
    "ragged": (dict(nx=61, ny=23, seed=5), None),
    "nz60": (dict(nx=40, ny=24, nz=60, seed=6), None),
    "nz_max": (dict(nx=20, ny=10, nz=cuda_uv_rhs.NZ_MAX, seed=7), None),
    "coriolis_only": (dict(uv_adv=False, seed=8), None),
    "advection_only": (dict(uv_cor=False, curvgrid=False, seed=9), None),
}
TOL = {torch.float64: (1e-12, 1e-12), torch.float32: (1e-5, 1e-5)}


@pytest.mark.h100
@pytest.mark.parametrize("scheme", [AdvScheme.CENTERED4, AdvScheme.UPSTREAM3])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("case", sorted(CARD_CASES))
def test_kernel_is_its_plain_version_on_the_card(card, case, dtype, scheme):
    kw, own = CARD_CASES[case]
    cfg, args, grid = _inputs(dtype, card, own, **kw)
    stats = _build.kernel_stats["uv_rhs"]
    before = stats["launches"]
    got = cuda_uv_rhs.uv_rhs(*args, grid, cfg, scheme)
    ref = cuda_uv_rhs.uv_rhs_plain(*args, grid, cfg, scheme)
    torch.cuda.synchronize()
    assert stats["launches"] == before + 1
    rtol, atol = TOL[dtype]
    for g, r in zip(got, ref):
        r = r.double()
        a = atol * (float(r.abs().max()) if dtype == torch.float32 else 1.0)
        np.testing.assert_allclose(g.double().cpu().numpy(), r.cpu().numpy(),
                                   rtol=rtol, atol=a)


@pytest.mark.h100
def test_step_takes_the_kernel_on_the_card(card):
    """Two launches a step and no plain call on a single block (Filament
    at a small size, float64), and the step equals the same step with the
    plain version in the wrapper's place to 1e-12 of each field's
    largest value."""
    from roms_tpu_torch.cases import filament
    from roms_tpu_torch.driver import run
    cfg = filament.config().replace(nx=32, ny=24, nz=8, ndtfast=6)

    def steps():
        grid, st, frc = filament.setup(cfg, dtype=torch.float64, device=card)
        st, _ = run(grid, st, frc, cfg, nsteps=2, collect_diag=False)
        torch.cuda.synchronize()
        return st
    stats = _build.kernel_stats["uv_rhs"]
    n0 = stats["launches"], stats["plain"]
    got = steps()
    assert (stats["launches"] - n0[0], stats["plain"] - n0[1]) == (4, 0)
    kernel = cuda_uv_rhs.uv_rhs
    try:
        cuda_uv_rhs.uv_rhs = cuda_uv_rhs.uv_rhs_plain
        ref = steps()
    finally:
        cuda_uv_rhs.uv_rhs = kernel
    for name in ("zeta", "ubar", "vbar", "u", "v", "t"):
        g, r = getattr(got, name), getattr(ref, name)
        scale = max(1.0, float(r.abs().max()))
        assert float((g - r).abs().max()) <= 1e-12 * scale, name
