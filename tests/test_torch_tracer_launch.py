"""What of the CUDA kernels can be checked without a card.

The ctypes argument lists of `roms_tpu_torch.ops._build.ENTRY_POINTS`
against the `extern "C"` signatures in `roms_tpu_torch/csrc/*.cu` (a
mismatch would otherwise show only on the card, as garbage arguments),
and the tracer kernel's launch planner (`ops/cuda_tracer.py:launch_plan`):
every (type, nz) it accepts fits one block's shared memory, the
production width keeps three blocks an SM, and nz outside the kernel's
range raises before any launch.
"""

import ctypes
import re
from pathlib import Path

import pytest
import torch

from roms_tpu_torch.config import AdvScheme, ModelConfig
from roms_tpu_torch.ops import _build, cuda_tracer

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
    """{entry point: [kind of each parameter]} from the sources, with
    ROMS_*_ENTRY macros expanded by their instantiations."""
    sigs = {}
    for path in sorted(CSRC.glob("*.cu")):
        src = path.read_text()
        joined = src.replace("\\\n", " ")
        macros = {}
        for m in re.finditer(r'#define (\w+)\(NAME, T\)\s+extern "C" int '
                             r'NAME\((.*?)\)\s*\{', joined, re.S):
            macros[m.group(1)] = m.group(2)
        for name, params in macros.items():
            for inst in re.finditer(rf"^{name}\((\w+), \w+\)", src, re.M):
                sigs[inst.group(1)] = params
        for m in re.finditer(r'^extern "C" int (\w+)\((.*?)\)\s*\{', src,
                             re.S | re.M):
            sigs[m.group(1)] = m.group(2)
    return {name: [_kind(p) for p in params.split(",")]
            for name, params in sigs.items()}


def _ctypes_kind(t) -> str:
    if t is ctypes.c_void_p or issubclass(t, ctypes._Pointer):
        return "ptr"
    if t is ctypes.c_int:
        return "int"
    if t is ctypes.c_double:
        return "double"
    raise ValueError(f"unexpected argtype {t}")


def test_every_entry_point_is_in_the_sources():
    assert set(_signatures()) == set(_build.ENTRY_POINTS)


@pytest.mark.parametrize("name", sorted(_build.ENTRY_POINTS))
def test_argtypes_match_the_c_signature(name):
    """Same order of pointer, int and double parameters: ctypes passes
    each argument as its argtype says, so a missing int shifts every
    later argument."""
    c_kinds = _signatures()[name]
    py_kinds = [_ctypes_kind(t) for t in _build.ENTRY_POINTS[name]]
    assert py_kinds == c_kinds


@pytest.mark.parametrize("mix", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_every_accepted_nz_fits_one_block(dtype, mix):
    elem = torch.empty((), dtype=dtype).element_size()
    for nz in range(2, cuda_tracer.NZ_MAX + 1):
        tj, smem = cuda_tracer.launch_plan(elem, nz, mix)
        assert tj in cuda_tracer.TILE_J
        assert smem == cuda_tracer.smem_bytes(tj, nz, elem, mix)
        assert smem <= cuda_tracer.SMEM_BLOCK == 232_448


def test_nz_max_reaches_every_depth_the_repo_uses():
    assert cuda_tracer.NZ_MAX >= 128
    for nz in (10, 16, 32, 60):
        for elem in (4, 8):
            cuda_tracer.launch_plan(elem, nz, True)


@pytest.mark.parametrize("mix", [False, True])
def test_production_width_keeps_three_blocks_an_sm(mix):
    """nz=60 in float32 (bench_production, Filament at bench width): tiles
    of 32 x 4 columns, three blocks (24 warps) an SM by shared memory."""
    tj, smem = cuda_tracer.launch_plan(4, 60, mix)
    assert tj == 4
    blocks = cuda_tracer.SMEM_SM // (smem + cuda_tracer.SMEM_RESERVED)
    assert blocks >= 3
    assert 3 * 2 * tj * cuda_tracer.TILE_I <= cuda_tracer.THREADS_SM


@pytest.mark.parametrize("nz", [1, cuda_tracer.NZ_MAX + 1])
def test_nz_outside_the_kernel_raises(nz):
    """The wrapper refuses such a column before it looks at the device:
    shown on meta tensors, which take no memory."""
    jy, ix, nt = 8, 36, 2
    cfg = ModelConfig(nx=ix - 4, ny=jy - 4, nz=nz, nt=nt)

    def m(*shape):
        return torch.empty(shape, dtype=torch.float32, device="meta")

    t4, f3, w3, p2 = m(nt, nz, jy, ix), m(nz, jy, ix), m(nz + 1, jy, ix), \
        m(jy, ix)
    with pytest.raises(ValueError, match="nz"):
        cuda_tracer.tracer_stage(t4, t4, f3, f3, f3, f3, w3, w3,
                                 m(2, nz + 1, jy, ix), p2, p2, p2, p2, cfg,
                                 AdvScheme.UPSTREAM3, 1.0, 0.0, 1.0, True,
                                 "corr")
