"""Arguments of the four CUDA kernels' wrappers at any depth, and a
stand-in for the kernel library, for the CPU tests of the kernels' seam
(`roms_tpu_torch/ops/_build.py`): the launch path of each wrapper
(`_launch`) runs on the CPU up to the entry point, which the stand-in
takes in the library's place.

Imports nothing of JAX: the card runs the files that use it without the
repository's conftest.
"""

import ctypes
import types

import torch

from roms_tpu_torch.config import AdvScheme, ModelConfig
from roms_tpu_torch.ops import (_build, cuda_kpp, cuda_solve, cuda_tracer,
                                cuda_uv_rhs)

MODULES = {"tracer_stage": cuda_tracer, "momentum_solve": cuda_solve,
           "kpp_vmix": cuda_kpp, "uv_rhs": cuda_uv_rhs}
# each wrapper's public name and plain version
WRAPPERS = {"tracer_stage": ("tracer_stage", "tracer_stage_plain"),
            "momentum_solve": ("momentum_implicit",
                               "momentum_implicit_plain"),
            "kpp_vmix": ("vmix_update", "vmix_update_plain"),
            "uv_rhs": ("uv_rhs", "uv_rhs_plain")}
JY, IX, NT = 8, 36, 2


def config(kernel: str, nz: int) -> ModelConfig:
    """A configuration that every gate admits."""
    return ModelConfig(nx=IX - 4, ny=JY - 4, nz=nz, nt=NT,
                       lmd_kpp=kernel == "kpp_vmix")


def args(kernel: str, nz: int, dtype=torch.float32, device="cpu",
         ref=None, **change):
    """(positional, keyword) arguments of the kernel's wrapper on a JY x IX
    plane, zeros, its configuration `config` with `change`; `ref`, where
    given, stands in for the tensor whose device decides the path."""
    def z(*shape):
        return torch.zeros(shape, dtype=dtype, device=device)

    f3, w3, p2 = z(nz, JY, IX), z(nz + 1, JY, IX), z(JY, IX)
    lead = f3 if ref is None else ref
    cfg = config(kernel, nz).replace(**change)
    ns = types.SimpleNamespace
    grid = ns(f=p2, fomn=p2, dndx=p2, dmde=p2, rmask=p2, umask=p2, vmask=p2,
              own_w=None, own_e=None, own_s=None, own_n=None)
    if kernel == "tracer_stage":
        t4 = z(NT, nz, JY, IX)
        return ((t4 if ref is None else ref, t4, f3, f3, f3, f3, w3, w3,
                 z(NT, nz + 1, JY, IX), p2, p2, p2, p2, cfg,
                 AdvScheme.UPSTREAM3, 1.0, 0.0, 1.0, True, "corr"),
                {"stflx": z(NT, JY, IX),
                 "mix": {"diff2": z(NT, JY, IX), "pmon_u": p2,
                         "pnom_v": p2}, "own": None})
    if kernel == "momentum_solve":
        return (lead, f3, w3, w3, p2, 1.0, p2, cfg), {"bottom_drag_coeff": p2}
    if kernel == "kpp_vmix":
        return ((ns(swrf=w3, hbls=p2, hbbl=p2), lead, f3, z(NT, nz, JY, IX),
                 w3, f3, w3, f3,
                 ns(stflx=z(NT, JY, IX), srflx=p2, sustr=p2, svstr=p2), grid,
                 cfg, False), {})
    return (lead, f3, f3, f3, f3, w3, grid, cfg, AdvScheme.UPSTREAM3), {}


class FakeLibrary:
    """Takes the kernel library's place: each entry point returns 0 and
    records (name, the lengths heading its int array)."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        # a launch's n is its second argument, headed by three lengths;
        # an occupancy query's its first, headed by two
        n_at, head = (0, 2) if name.endswith("_occupancy") else (1, 3)

        def entry(*a):
            n = (ctypes.c_int * head).from_address(a[n_at])
            self.calls.append((name, tuple(n)))
            return 0
        return entry


def fake_library(monkeypatch) -> FakeLibrary:
    """A FakeLibrary bound in the library's place for this test."""
    lib = FakeLibrary()
    monkeypatch.setattr(_build, "ENTRY", {})
    monkeypatch.setattr(_build, "stream", lambda t: 0)
    _build.bind(lib)
    return lib
