"""Build and load the port's CUDA kernels.

`nvcc` compiles the `.cu` files under `roms_tpu_torch/csrc/` for Hopper
(`sm_90a`), one process per source, all started together, and links the
objects into one shared library with a plain C interface, at first use,
into `build/` at the repository root.  The library's name carries a hash
of the sources, the headers they include and the flags, so a stale
library is never loaded.  It is
bound with `ctypes`: every pointer and the CUDA stream go in as
`c_void_p` (the KPP entry points take arrays of pointers, ints and
doubles), and each entry point returns `cudaGetLastError()`, which
`check` turns into an exception.  `-Xptxas -v` reports each kernel's
registers and spills; `build` returns that log.

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
SOURCES = ("tracer_stage.cu", "momentum_solve.cu", "kpp_vmix.cu")
HEADERS = ("kernel_util.cuh",)  # included by the sources: hashed with them
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_PTR, _INT, _DBL = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
# argtypes of the C entry points (see csrc/): pointers, ints, doubles, stream
_TRACER_ARGS = [_PTR] * 18 + [_INT] * 17 + [_DBL] * 3 + [_PTR]
_SOLVE_ARGS = [_PTR] * 8 + [_INT] * 3 + [_DBL] + [_PTR]
_KPP_ARGS = [ctypes.POINTER(_PTR), ctypes.POINTER(_INT),
             ctypes.POINTER(_DBL), _PTR]
ENTRY_POINTS = {
    "roms_tracer_stage_f32": _TRACER_ARGS,
    "roms_tracer_stage_f64": _TRACER_ARGS,
    "roms_tracer_stage_occupancy": [_INT] * 6 + [ctypes.POINTER(_INT)],
    "roms_momentum_solve_f32": _SOLVE_ARGS,
    "roms_momentum_solve_f64": _SOLVE_ARGS,
    "roms_momentum_solve_occupancy": [_INT] * 2 + [ctypes.POINTER(_INT)],
    "roms_kpp_vmix_f32": _KPP_ARGS,
    "roms_kpp_vmix_f64": _KPP_ARGS,
    "roms_kpp_vmix_occupancy": [_INT] * 2 + [ctypes.POINTER(_INT)],
}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels build only on "
                           "a machine with the CUDA toolkit")
    return path


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in (*SOURCES, *HEADERS):
        h.update((CSRC / name).read_bytes())
    return BUILD / f"libroms_kernels_{h.hexdigest()[:16]}.so"


def build() -> tuple[Path, float, str]:
    """Compile the kernels unless the library for these sources exists;
    returns (path, seconds spent compiling, nvcc's log)."""
    out = library_path()
    if out.exists():
        return out, 0.0, ""
    BUILD.mkdir(exist_ok=True)
    tag = f"{out.stem}.{os.getpid()}"
    objs = [BUILD / f"{tag}.{Path(s).stem}.o" for s in SOURCES]
    t0 = time.perf_counter()
    procs = [subprocess.Popen([_nvcc(), *NVCC_FLAGS, "-c", "-o", str(o),
                               str(CSRC / s)], stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for s, o in zip(SOURCES, objs)]
    logs = [p.communicate()[0] for p in procs]
    for s, p, log in zip(SOURCES, procs, logs):
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed on {s} ({p.returncode}):\n{log}")
    partial = out.with_suffix(f".{os.getpid()}.part")
    res = subprocess.run([_nvcc(), "-shared", "-o", str(partial),
                          *map(str, objs)], capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc link failed ({res.returncode}):\n"
                           f"{res.stderr}")
    os.replace(partial, out)
    for o in objs:
        o.unlink()
    return out, time.perf_counter() - t0, "".join(logs)


@functools.cache
def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    path, _, _ = build()
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


def check_groups(ref, *groups):
    """Device, dtype, shape and contiguity checks before a launch, kept
    cheap: the host's work before a launch leaves the card idle.  Each
    group is (expected shape, names separated by spaces, tensors); ref
    fixes device and dtype."""
    dtype, dev = ref.dtype, ref.device
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"kernel takes float32/float64, got {dtype}")
    if ref.shape[-2] > 65535:
        raise ValueError("kernel grid: jy must be <= 65535")
    for shape, names, tensors in groups:
        for n, t in enumerate(tensors):
            if (t.shape != shape or t.dtype is not dtype or t.device != dev
                    or not t.is_contiguous()):
                _refuse(names.split()[n], t, shape, ref)


def _refuse(name, t, shape, ref):
    if t.device != ref.device or t.dtype is not ref.dtype:
        raise TypeError(f"{name}: {t.dtype} on {t.device}, expected "
                        f"{ref.dtype} on {ref.device}")
    if t.shape != shape:
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    raise ValueError(f"{name}: kernel needs a contiguous tensor")


def check_inputs(shapes: dict, ref):
    """`check_groups` with shapes: name -> (tensor, expected shape)."""
    check_groups(ref, *((tuple(shape), name, (t,))
                        for name, (t, shape) in shapes.items()))


def compulsory_bytes(inputs, outputs) -> int:
    """Bytes a launch must move: each distinct input read once, each output
    written once (None entries are absent inputs; scratch is left out)."""
    seen, n = set(), 0
    for t in (*inputs, *outputs):
        if t is not None and (t.data_ptr(), t.numel()) not in seen:
            seen.add((t.data_ptr(), t.numel()))
            n += t.numel() * t.element_size()
    return n


def stream(t) -> int:
    """Handle of PyTorch's current CUDA stream on t's device, as
    torch.cuda.current_stream(t.device).cuda_stream gives it, without
    building a Stream object."""
    return torch._C._cuda_getCurrentRawStream(t.get_device())


def occupancy_dict(out) -> dict:
    """{threads, smem, blocks_per_sm, warps_per_sm, registers, stack} of
    one kernel from the five ints an occupancy entry point writes."""
    threads, smem, blocks, regs, stack = out
    return {"threads": threads, "smem": smem, "blocks_per_sm": blocks,
            "warps_per_sm": blocks * threads // 32, "registers": regs,
            "stack": stack}


def ptr(t) -> int | None:
    """Device pointer of a tensor, or None (NULL) for an absent input."""
    return None if t is None else t.data_ptr()
