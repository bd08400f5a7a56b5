"""Build and load the port's CUDA kernels.

`nvcc` compiles the `.cu` files under `roms_tpu_torch/csrc/` for Hopper
(`sm_90a`), one process per source, all started together, and links the
objects into one shared library with a plain C interface, at first use,
into `build/` at the repository root.  The library's name carries a hash
of the sources, the headers they include and the flags, so a stale
library is never loaded.  It is
bound with `ctypes`, every entry point in one form (csrc/kernel_util.cuh):
a launch takes arrays of pointers, ints and doubles and the CUDA stream,
an occupancy query an array of ints and one for its output, each array
as a `c_void_p` to its buffer, the ints headed by the arrays' lengths,
which the entry point checks.  Each returns a cudaError_t, which `check`
turns into an exception.  `-Xptxas -v` reports each kernel's registers
and spills; `build` returns that log.

`library` binds every entry point once, into `ENTRY`.  `dispatch` is
every kernel wrapper's one path decision (device, the wrapper's gate,
plain version or launch), and the only place that counts, in
`kernel_stats`; `launch` and `occupancy` call the entry points.

Nothing here runs at import time: the CPU tests import every module on a
host with no `nvcc`.
"""

from __future__ import annotations

import array
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
SOURCES = ("tracer_stage.cu", "momentum_solve.cu", "kpp_vmix.cu",
           "uv_rhs.cu")
HEADERS = ("kernel_util.cuh",)  # included by the sources: hashed with them
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

KERNELS = ("tracer_stage", "momentum_solve", "kpp_vmix", "uv_rhs")
# argtypes of the C entry points: a launch's p, n, d and stream, an
# occupancy query's n and out
_LAUNCH_ARGS = [ctypes.c_void_p] * 4
_OCCUPANCY_ARGS = [ctypes.c_void_p] * 2
ENTRY_POINTS = {f"roms_{k}_{kind}": (_OCCUPANCY_ARGS if kind == "occupancy"
                                     else _LAUNCH_ARGS)
                for k in KERNELS for kind in ("f32", "f64", "occupancy")}
# sm_90's shared memory: the most one block may have, an SM's, and what
# each resident block reserves of it
SMEM_BLOCK = 232_448
SMEM_SM = 233_472            # 228 KB
SMEM_RESERVED = 1_024
NZ_MIN = 2                   # the shallowest column any kernel takes

# launches and plain-version calls of each kernel's wrapper, counted by
# `dispatch` alone
kernel_stats = {k: {"launches": 0, "plain": 0} for k in KERNELS}
# the bound entry points, filled by `library` (`bind`): a launch's by
# (kernel, dtype), an occupancy query's by (kernel, "occupancy")
ENTRY = {}
_KIND = {"f32": torch.float32, "f64": torch.float64,
         "occupancy": "occupancy"}


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
    bind(lib)
    return lib


def bind(lib):
    """Give each entry point of `lib` its argtypes and put it in ENTRY."""
    for name, argtypes in ENTRY_POINTS.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        kernel, kind = name[len("roms_"):].rsplit("_", 1)
        ENTRY[kernel, _KIND[kind]] = fn


def check(err: int, what: str):
    """Raise on a nonzero cudaError_t from a launch."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error {err}")


def dispatch(kernel: str, admit: bool, plain, launch_fn, *args, at=0,
             **kw):
    """Run a kernel wrapper's call, `args` and `kw` being its arguments
    and args[at] the tensor whose device decides: a CPU tensor takes
    `plain`; a device other than CUDA raises; on CUDA the call takes
    `launch_fn` where the wrapper's gate `admit` holds, else `plain`.
    Counts the path in `kernel_stats`."""
    dev = args[at].device.type
    if dev == "cuda" and admit:
        out = launch_fn(*args, **kw)
        kernel_stats[kernel]["launches"] += 1
        return out
    if dev != "cpu" and dev != "cuda":
        raise ValueError(f"{kernel}: no kernel for {args[at].device}")
    kernel_stats[kernel]["plain"] += 1
    return plain(*args, **kw)


def check_nz(kernel: str, nz: int, nz_max: int):
    """The launch guard of a kernel whose deepest column is nz_max: raise
    ValueError outside NZ_MIN <= nz <= nz_max."""
    if not NZ_MIN <= nz <= nz_max:
        raise ValueError(f"{kernel}: the kernel takes {NZ_MIN} <= nz <= "
                         f"{nz_max}, got nz={nz}")


def launch(kernel: str, ref, ptrs, ints, dbls=()):
    """Launch `kernel` for ref's dtype on PyTorch's current stream of ref's
    device (which a CUDA graph capture holds): ptrs are device pointers
    (`ptr`), ints and dbls the scalars, in the order of the entry point."""
    if not ENTRY:
        library()
    p = array.array("Q", ptrs)
    n = array.array("i", (len(ptrs), len(ints), len(dbls), *ints))
    d = array.array("d", dbls)
    check(ENTRY[kernel, ref.dtype](p.buffer_info()[0], n.buffer_info()[0],
                                   d.buffer_info()[0], stream(ref)), kernel)


def occupancy(kernel: str, ints, launches: int = 1) -> list:
    """`occupancy_dict` of each of the kernel's launches for the launch
    configuration that ints describe, as the library reports it."""
    out = array.array("i", [0] * (5 * launches))
    n = array.array("i", (len(ints), len(out), *ints))
    if not ENTRY:
        library()
    check(ENTRY[kernel, "occupancy"](n.buffer_info()[0],
                                     out.buffer_info()[0]),
          f"{kernel} occupancy")
    return [occupancy_dict(out[5 * q:5 * q + 5]) for q in range(launches)]


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


def owned(f) -> int:
    """An edge-ownership flag as a kernel takes it: None (a single block)
    owns the edge."""
    return 1 if f is None else int(bool(f))


def ptr(t) -> int:
    """Device pointer of a tensor, or 0 (NULL) for an absent input."""
    return 0 if t is None else t.data_ptr()
