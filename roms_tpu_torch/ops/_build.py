"""Build and load the port's CUDA kernels.

`nvcc` compiles the `.cu` files under `roms_tpu_torch/csrc/` for Hopper
(`sm_90a`) into one shared library with a plain C interface, at first
use, into `build/` at the repository root.  The library's name carries a
hash of the sources and flags, so a stale library is never loaded.  It is
bound with `ctypes`: every pointer and the CUDA stream go in as
`c_void_p`, and each entry point returns `cudaGetLastError()`, which
`check` turns into an exception.

Nothing here runs at import time: the CPU tests import every module on a
host with no `nvcc`.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[2]
CSRC = ROOT / "roms_tpu_torch" / "csrc"
BUILD = ROOT / "build"
SOURCES = ("tracer_stage.cu", "momentum_solve.cu")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_PTR, _INT, _DBL = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
# argtypes of the C entry points (see csrc/): pointers, ints, doubles, stream
_TRACER_ARGS = [_PTR] * 19 + [_INT] * 15 + [_DBL] * 3 + [_PTR]
_SOLVE_ARGS = [_PTR] * 9 + [_INT] * 3 + [_DBL] + [_PTR]
ENTRY_POINTS = {
    "roms_tracer_stage_f32": _TRACER_ARGS,
    "roms_tracer_stage_f64": _TRACER_ARGS,
    "roms_momentum_solve_f32": _SOLVE_ARGS,
    "roms_momentum_solve_f64": _SOLVE_ARGS,
}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels build only on "
                           "a machine with the CUDA toolkit")
    return path


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES:
        h.update((CSRC / name).read_bytes())
    return BUILD / f"libroms_kernels_{h.hexdigest()[:16]}.so"


def build() -> tuple[Path, float]:
    """Compile the kernels unless the library for these sources exists;
    returns (path, seconds spent compiling)."""
    out = library_path()
    if out.exists():
        return out, 0.0
    BUILD.mkdir(exist_ok=True)
    tmpdir = BUILD / "tmp"
    tmpdir.mkdir(exist_ok=True)
    partial = out.with_suffix(f".{os.getpid()}.part")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(partial),
           *[str(CSRC / s) for s in SOURCES]]
    t0 = time.perf_counter()
    res = subprocess.run(cmd, capture_output=True, text=True,
                         env={**os.environ, "TMPDIR": str(tmpdir)})
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed ({res.returncode}):\n{res.stderr}")
    os.replace(partial, out)
    return out, time.perf_counter() - t0


@functools.cache
def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    path, _ = build()
    lib = ctypes.CDLL(str(path))
    for name, argtypes in ENTRY_POINTS.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def check(err: int, what: str):
    """Raise on a nonzero cudaError_t from a launch."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error {err}")


def check_inputs(shapes: dict, ref):
    """Device, dtype, shape and contiguity checks before a launch.
    shapes: name -> (tensor, expected shape); ref fixes device and dtype."""
    if ref.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"kernel takes float32/float64, got {ref.dtype}")
    if ref.shape[-2] > 65535:
        raise ValueError("kernel grid: jy must be <= 65535")
    for name, (t, shape) in shapes.items():
        if t.device != ref.device or t.dtype != ref.dtype:
            raise TypeError(f"{name}: {t.dtype} on {t.device}, expected "
                            f"{ref.dtype} on {ref.device}")
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{name}: shape {tuple(t.shape)}, expected "
                             f"{tuple(shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: kernel needs a contiguous tensor")


def ptr(t) -> int | None:
    """Device pointer of a tensor, or None (NULL) for an absent input."""
    return None if t is None else t.data_ptr()
