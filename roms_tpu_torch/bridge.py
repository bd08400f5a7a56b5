"""Carry configurations, grids, states and forcing between the two
packages through plain Python and numpy.

The JAX package's pytrees go in as dicts of numpy arrays, one entry per
dataclass field (None for an absent optional field; `forcing.bry` and
`forcing.cdr` nested dicts of the same kind, `forcing.bgc` and the
state's `upscale` and budgets dicts of fields, nested for `uv_budget`), and come back out of the port the same way.  A configuration
goes in as `dataclasses.asdict` of the JAX package's `ModelConfig`.  This is how the tests feed both packages
identical inputs; nothing here imports the JAX package.
"""

from __future__ import annotations

import dataclasses
from enum import Enum

import numpy as np
import torch

from roms_tpu_torch.cdr import CdrForcing
from roms_tpu_torch.config import AdvScheme, ModelConfig
from roms_tpu_torch.grid import Grid
from roms_tpu_torch.state import BoundaryData, Forcing, OceanState
from roms_tpu_torch.tides import TidalForcing


def config_from_dict(d: dict) -> ModelConfig:
    """The port's ModelConfig from `dataclasses.asdict` of the JAX
    package's: every field by name, `AdvScheme` members by name."""
    return ModelConfig(**{k: AdvScheme[v.name] if isinstance(v, Enum) else v
                          for k, v in d.items()})


def _tensor(x, dtype, device):
    """Floating arrays take the model dtype; integer and bool arrays keep
    their kind."""
    if x is None:
        return None
    a = np.array(x)      # a private copy: never aliases the caller's array
    if np.issubdtype(a.dtype, np.floating):
        return torch.as_tensor(a, dtype=dtype, device=device)
    return torch.as_tensor(a, device=device)


def _from_numpy(cls, d: dict, dtype, device):
    return cls(**{f.name: _tensor(d[f.name], dtype, device)
                  for f in dataclasses.fields(cls) if f.name in d})


def grid_from_numpy(d: dict, *, dtype: torch.dtype,
                    device: torch.device) -> Grid:
    return _from_numpy(Grid, d, dtype, device)


def _tensor_tree(x, dtype, device):
    """An array, or a dict of them nested to any depth, as tensors."""
    if isinstance(x, dict):
        return {k: _tensor_tree(v, dtype, device) for k, v in x.items()}
    return _tensor(x, dtype, device)


def state_from_numpy(d: dict, *, dtype: torch.dtype,
                     device: torch.device) -> OceanState:
    """The state; its optional outputs `upscale` and `t_budget` (dicts of
    arrays) and `uv_budget` (a dict of such dicts) come along as the same
    dicts of tensors."""
    nested = ("upscale", "t_budget", "uv_budget")
    st = _from_numpy(OceanState, {k: v for k, v in d.items()
                                  if k not in nested}, dtype, device)
    return st.replace(**{k: _tensor_tree(d[k], dtype, device)
                         for k in nested if d.get(k) is not None})


def cdr_from_numpy(d: dict, *, dtype: torch.dtype,
                   device: torch.device) -> CdrForcing:
    """Release data; the point indices `jloc`, `iloc`, `icdr` become
    int64."""
    cdr = _from_numpy(CdrForcing, d, dtype, device)
    return cdr.replace(**{k: getattr(cdr, k).long()
                          for k in ("jloc", "iloc", "icdr")
                          if getattr(cdr, k) is not None})


def tides_from_numpy(d: dict, *, dtype: torch.dtype,
                     device: torch.device) -> TidalForcing:
    return _from_numpy(TidalForcing, d, dtype, device)


def forcing_from_numpy(d: dict, *, dtype: torch.dtype,
                       device: torch.device) -> Forcing:
    nested = ("bry", "cdr", "bgc")
    frc = _from_numpy(Forcing, {k: v for k, v in d.items()
                                if k not in nested}, dtype, device)
    if d.get("bry") is not None:
        frc = frc.replace(bry=_from_numpy(BoundaryData, d["bry"], dtype,
                                          device))
    if d.get("cdr") is not None:
        frc = frc.replace(cdr=cdr_from_numpy(d["cdr"], dtype=dtype,
                                             device=device))
    if d.get("bgc") is not None:
        frc = frc.replace(bgc={k: _tensor(v, dtype, device)
                               for k, v in d["bgc"].items()})
    return frc


def to_numpy(x):
    """Tensor -> ndarray; dataclass or dict of tensors (or of ndarrays, as
    `run_distributed` returns them) -> dict of ndarrays (None stays
    None)."""
    if x is None:
        return None
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    if isinstance(x, np.ndarray):
        return x
    if isinstance(x, dict):
        return {k: to_numpy(v) for k, v in x.items()}
    if dataclasses.is_dataclass(x):
        return {f.name: to_numpy(getattr(x, f.name))
                for f in dataclasses.fields(x)}
    raise TypeError(f"to_numpy: unsupported {type(x).__name__}")
