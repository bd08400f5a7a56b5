"""Fixed-depth slice output (port of roms_tpu/io/zslice.py; reference:
src/zslice_output.F; offline analog Tools-Roms/zslice.F +
sigma_to_z_intr.F).

`zslice` linearly interpolates a (nz, jy, ix) rho-level field onto fixed
z depths using the moving level depths z_r, masking points below the
local bottom or above the surface.  Every depth and column is searched at
once: one batched comparison against z_r and one gather, on the field's
device.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from roms_tpu_torch.config import ModelConfig
from roms_tpu_torch.io.netcdf import NCWriter
from roms_tpu_torch.io.output import RHO, host, provenance_attrs, tracer_name


def zslice(field: torch.Tensor, z_r: torch.Tensor, depths) -> torch.Tensor:
    """Interpolate to fixed depths (negative down).  Returns
    (ndepth, jy, ix); NaN where the depth is outside the water column."""
    d = torch.as_tensor(np.atleast_1d(host(depths)), dtype=field.dtype,
                        device=field.device)[:, None, None]   # (nd, 1, 1)
    nz = field.shape[0]
    # k such that z_r[k] <= depth <= z_r[k+1], for every (depth, column)
    below = (z_r[None] <= d[:, None]).sum(dim=1)              # (nd, jy, ix)
    k = torch.clamp(below - 1, 0, nz - 2)[:, None]            # (nd, 1, ...)

    def at(a, kk):
        return torch.take_along_dim(a[None], kk, dim=1)[:, 0]

    zk, zk1 = at(z_r, k), at(z_r, k + 1)
    fk, fk1 = at(field, k), at(field, k + 1)
    w = torch.where(zk1 > zk, (d - zk) / (zk1 - zk), 0.0)
    val = fk + torch.clamp(w, 0.0, 1.0) * (fk1 - fk)
    inside = (d >= z_r[0]) & (d <= z_r[-1])
    return torch.where(inside, val, torch.nan)


class ZsliceWriter:
    """Streaming z-slice file (reference: src/zslice_output.F)."""

    def __init__(self, path: str, grid, cfg: ModelConfig,
                 depths: Sequence[float],
                 varnames: Sequence[str] = ("temp",)):
        self.cfg = cfg
        self.depths = np.asarray(depths, np.float64)
        self.varnames = list(varnames)
        self.nc = NCWriter(path, provenance_attrs(cfg))
        self.nc.create_dim("time", None)
        self.nc.create_dim("depth", len(depths))
        self.nc.create_dim("eta_rho", cfg.ny + 2)
        self.nc.create_dim("xi_rho", cfg.nx + 2)
        self.nc.create_var("depth", ("depth",), "f8", {"units": "meter"})
        self.nc.write("depth", self.depths)
        self.nc.create_var("ocean_time", ("time",), "f8")
        for v in self.varnames:
            self.nc.create_var(v, ("time", "depth", "eta_rho", "xi_rho"),
                               "f4")
        self.rec = 0

    def write(self, state):
        self.nc.write("ocean_time", float(state.time), rec=self.rec)
        for v in self.varnames:
            f = None
            for i in range(self.cfg.nt):
                if v == tracer_name(self.cfg, i):
                    f = state.t[i]
            if f is None:
                f = getattr(state, v)
            sl = host(zslice(f, state.z_r, -np.abs(self.depths)))
            self.nc.write(v, sl[:, RHO, RHO].astype(np.float32),
                          rec=self.rec)
        self.rec += 1
        self.nc.sync()

    def close(self):
        self.nc.close()
