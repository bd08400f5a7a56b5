"""What of the CUDA kernels' entry points and of the tracer kernel's
launch planner can be checked without a card.

The ctypes argument lists of `roms_tpu_torch.ops._build.ENTRY_POINTS`
against the `extern "C"` signatures in `roms_tpu_torch/csrc/*.cu`, and
the lengths of the arrays each wrapper passes (its launch path run on
the CPU into a stand-in library, `torch_kernel_args.FakeLibrary`) against
the kernel's `LENGTHS`, which its entry points check: a mismatch would
otherwise show only on the card.  The tracer kernel's launch planner
(`ops/cuda_tracer.py:launch_plan`): every (type, nz) it accepts fits one
block's shared memory, and the production width keeps three blocks an SM.

On the card (marked `h100`; skipped where there is no CUDA device, decided
inside the test) each entry point refuses lengths other than its own.
This file imports nothing of JAX; on the card:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_tracer_launch.py
"""

import array
import ctypes
import re
from pathlib import Path

import pytest
import torch

from roms_tpu_torch.config import AdvScheme
from roms_tpu_torch.ops import _build, cuda_tracer

import torch_kernel_args as ka

torch.set_num_threads(1)

CSRC = Path(_build.__file__).resolve().parents[1] / "csrc"


def _kind(param: str) -> str:
    """'ptr', 'int' or 'double' of one C parameter declaration."""
    if "*" in param:
        return "ptr"
    words = param.replace("const", "").split()
    if words[0] in ("int", "double"):
        return words[0]
    raise ValueError(f"unexpected C parameter {param!r}")


def _signatures() -> dict:
    """{entry point: ([kind of each parameter], the source's LENGTHS)}."""
    sigs = {}
    for path in sorted(CSRC.glob("*.cu")):
        src = path.read_text()
        lengths = tuple(map(int, re.search(
            r"constexpr Lengths LENGTHS = \{([\d, ]+)\};", src)
            .group(1).split(",")))
        for m in re.finditer(r'^extern "C" int (\w+)\((.*?)\)\s*\{', src,
                             re.S | re.M):
            sigs[m.group(1)] = ([_kind(p) for p in m.group(2).split(",")],
                                lengths)
    return sigs


def _ctypes_kind(t) -> str:
    if t is ctypes.c_void_p or issubclass(t, ctypes._Pointer):
        return "ptr"
    if t is ctypes.c_int:
        return "int"
    if t is ctypes.c_double:
        return "double"
    raise ValueError(f"unexpected argtype {t}")


# the occupancy query of each kernel at nz = 60 in float32
OCCUPANCY = {
    "tracer_stage": lambda: cuda_tracer.occupancy(
        torch.float32, 60, AdvScheme.UPSTREAM3, True),
    "momentum_solve": lambda: ka.MODULES["momentum_solve"].occupancy(
        torch.float32, 60),
    "kpp_vmix": lambda: ka.MODULES["kpp_vmix"].occupancy(torch.float32, 60),
    "uv_rhs": lambda: ka.MODULES["uv_rhs"].occupancy(
        torch.float32, 60, AdvScheme.CENTERED4),
}


def test_every_entry_point_is_in_the_sources():
    assert set(_signatures()) == set(_build.ENTRY_POINTS)


@pytest.mark.parametrize("name", sorted(_build.ENTRY_POINTS))
def test_argtypes_match_the_c_signature(name, monkeypatch):
    """Same parameters (the one form: arrays and the stream, as
    pointers), and the lengths heading the int array that the wrapper
    builds are the C side's: ctypes passes each argument as its argtype
    says, and the entry point refuses other lengths."""
    c_kinds, lengths = _signatures()[name]
    assert [_ctypes_kind(t) for t in _build.ENTRY_POINTS[name]] == c_kinds
    kernel, kind = re.fullmatch(r"roms_(\w+)_(f32|f64|occupancy)",
                                name).groups()
    lib = ka.fake_library(monkeypatch)
    if kind == "occupancy":
        OCCUPANCY[kernel]()
        expected = lengths[3:]
    else:
        a, kw = ka.args(kernel, 60, dtype=torch.float64 if kind == "f64"
                        else torch.float32)
        ka.MODULES[kernel]._launch(*a, **kw)
        expected = lengths[:3]
    assert lib.calls == [(name, expected)]


@pytest.mark.parametrize("mix", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_every_accepted_nz_fits_one_block(dtype, mix):
    elem = torch.empty((), dtype=dtype).element_size()
    for nz in range(2, cuda_tracer.NZ_MAX + 1):
        tj, smem = cuda_tracer.launch_plan(elem, nz, mix)
        assert tj in cuda_tracer.TILE_J
        assert smem == cuda_tracer.smem_bytes(tj, nz, elem, mix)
        assert smem <= _build.SMEM_BLOCK == 232_448


@pytest.mark.parametrize("mix", [False, True])
def test_production_width_keeps_three_blocks_an_sm(mix):
    """nz=60 in float32 (bench_production, Filament at bench width): tiles
    of 32 x 4 columns, three blocks (24 warps) an SM by shared memory."""
    tj, smem = cuda_tracer.launch_plan(4, 60, mix)
    assert tj == 4
    blocks = _build.SMEM_SM // (smem + _build.SMEM_RESERVED)
    assert blocks >= 3
    assert 3 * 2 * tj * cuda_tracer.TILE_I <= cuda_tracer.THREADS_SM


# ---------------------------------------------------------------- the card
@pytest.mark.h100
@pytest.mark.parametrize("name", sorted(_build.ENTRY_POINTS))
def test_entry_point_refuses_other_lengths(name):
    """Each entry point returns cudaErrorInvalidValue (1) for any length
    heading n other than its kernel's, one too many or one too few, before
    it reads anything else (on the card, where the library builds)."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the test runs only on the card")
    _, lengths = _signatures()[name]
    fn = getattr(_build.library(), name)
    occupancy = name.endswith("_occupancy")
    head = list(lengths[3:] if occupancy else lengths[:3])
    big = array.array("d", [0.0] * 64)      # room for any array read
    for k in range(len(head)):
        for off in (-1, 1):
            wrong = head.copy()
            wrong[k] += off
            n = array.array("i", wrong + [0] * 64)
            at = n.buffer_info()[0]
            err = fn(at, big.buffer_info()[0]) if occupancy else fn(
                big.buffer_info()[0], at, big.buffer_info()[0], 0)
            assert err == 1, (wrong, err)
