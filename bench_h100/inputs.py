"""What every configuration's input module shares: the seeded generator,
the smooth seeded perturbation, and the two sides that derive a model
state from the same raw inputs.

The raw inputs of a run are float64 tensors made on the run's device from
`--seed`.  The program (roms_tpu_torch) and the plain reference
(`bench_h100.reference`) each derive their grid, state and forcing from
them with their own code: `side(PROGRAM)` and `side(REFERENCE)` hold the
modules that a configuration's `derive` calls, under the same names.
"""

from __future__ import annotations

import dataclasses
import importlib
import math
from types import SimpleNamespace

import torch

PROGRAM = "roms_tpu_torch"
REFERENCE = "bench_h100.reference"

# (module attribute, module path below the side's package)
_MODULES = (("config", "config"), ("grid", "grid"), ("vcoord", "vcoord"),
            ("state", "state"), ("kinematics", "ops.kinematics"),
            ("eos", "ops.eos"), ("kpp", "ops.kpp"),
            ("halo", "parallel.halo"))

# wavenumbers (along x, along y) of the seeded perturbation: the same for
# every seed, so every seed makes fields of the same size and smoothness
MODES = ((1, 1), (2, 1), (1, 2), (3, 1))


def side(prefix: str) -> SimpleNamespace:
    """The modules one side derives its state with, and `run(grid,
    state, forcing, cfg, nsteps)`, which advances the state through that
    side's step loop (the first step of each call is the LF-AM3 start)."""
    mods = {name: importlib.import_module(f"{prefix}.{path}")
            for name, path in _MODULES}
    if prefix == PROGRAM:
        driver = importlib.import_module(f"{prefix}.driver")

        def run(grid, state, forcing, cfg, nsteps):
            return driver.run(grid, state, forcing, cfg, nsteps=nsteps,
                              collect_diag=False)[0]
    else:
        run = importlib.import_module(f"{prefix}.loop").run
    return SimpleNamespace(prefix=prefix, run=run, **mods)


def model_config(lib, model: dict):
    """The side's ModelConfig from a configuration file's `model` object
    (enums by value)."""
    mc = lib.config.ModelConfig
    kw = {}
    for f in dataclasses.fields(mc):
        if f.name not in model:
            raise KeyError(f"configuration file lacks the field {f.name!r}")
        v = model[f.name]
        if f.name.endswith("_scheme"):
            v = lib.config.AdvScheme(v)
        kw[f.name] = v
    extra = set(model) - set(kw)
    if extra:
        raise KeyError(f"fields the model does not have: {sorted(extra)}")
    return mc(**kw)


def generator(seed: int, device) -> torch.Generator:
    """A generator on `device` seeded from `--seed` (any whole number;
    reduced to 64 bits)."""
    return torch.Generator(device=device).manual_seed(seed % 2**64)


def phases(gen: torch.Generator, n: int, device) -> torch.Tensor:
    """n phases in [0, 2 pi), float64, on `device`."""
    return 2.0 * math.pi * torch.rand(n, generator=gen, device=device,
                                      dtype=torch.float64)


def smooth_field(x, y, lx: float, ly: float, phase: torch.Tensor):
    """A smooth field of amplitude at most 1: the mean of the MODES'
    cosines, each with its phase; x, y broadcast against each other."""
    out = 0.0
    for (m, n), ph in zip(MODES, phase):
        out = out + torch.cos(2.0 * math.pi * (m * x / lx + n * y / ly) + ph)
    return out / len(MODES)


def host(a: torch.Tensor):
    """A 2D raw input as the numpy array that `grid.build_grid` takes."""
    return a.detach().cpu().numpy()
