"""Online data extraction at arbitrary point sets ("objects": mooring
transects, child-grid boundaries) with vector rotation (port of
roms_tpu/io/extract.py; reference: src/extract_data.F:11-40; the offline
joiner Tools-Roms extract_data_join is unnecessary: output is already
global).

Each object is a list of fractional-index positions on the rho grid; fields
are bilinearly interpolated there.  Velocity pairs are averaged to rho
points first and optionally rotated to east/north with the grid angle
(reference: extract_data.F vector-rotation path).  The positions are
float64 tensors on the field's device, as the JAX package's are float64
arrays.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from roms_tpu_torch.config import ModelConfig
from roms_tpu_torch.io.netcdf import NCWriter
from roms_tpu_torch.io.output import host, provenance_attrs, tracer_name
from roms_tpu_torch.parallel.halo import shift


def _gather2(f, jj, ii, y, x):
    return ((1 - y) * ((1 - x) * f[..., jj, ii] + x * f[..., jj, ii + 1])
            + y * ((1 - x) * f[..., jj + 1, ii] + x * f[..., jj + 1, ii + 1]))


def _positions(p, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(host(p), dtype=torch.float64, device=like.device)


def extract_points(field: torch.Tensor, px, py, cfg: ModelConfig):
    """Bilinear interpolation of a (..., jy, ix) field at fractional rho
    indices (px, py) (Fortran convention as in particles)."""
    px = _positions(px, field)
    py = _positions(py, field)
    i = torch.floor(px).to(torch.int32)
    j = torch.floor(py).to(torch.int32)
    x = px - i
    y = py - j
    jy, ix = field.shape[-2:]
    ip = torch.clamp(i + 1, 0, ix - 2).long()   # Fortran -> padded index
    jp = torch.clamp(j + 1, 0, jy - 2).long()
    return _gather2(field, jp, ip, y, x)


def extract_uv(u, v, px, py, grid, cfg: ModelConfig, angler=None):
    """Interpolate a velocity pair at rho-point targets, with optional
    rotation to geographic east/north (reference: extract_data.F rotation)."""
    u_r = 0.5 * (u + shift(u, 0, 1))
    v_r = 0.5 * (v + shift(v, 1, 0))
    up = extract_points(u_r, px, py, cfg)
    vp = extract_points(v_r, px, py, cfg)
    if angler is not None:
        ang = extract_points(torch.as_tensor(host(angler), device=u.device),
                             px, py, cfg)
        ue = up * torch.cos(ang) - vp * torch.sin(ang)
        vn = up * torch.sin(ang) + vp * torch.cos(ang)
        return ue, vn
    return up, vp


class ExtractObject:
    """A named point set (reference: extract_data.F "objects", defined by
    Tools-Roms/scripts add_object.m)."""

    def __init__(self, name: str, px: Sequence[float], py: Sequence[float]):
        self.name = name
        self.px = np.asarray(px, np.float64)
        self.py = np.asarray(py, np.float64)


class ExtractWriter:
    """Per-object extraction file (reference: src/extract_data.F output)."""

    def __init__(self, path: str, objects: Sequence[ExtractObject],
                 cfg: ModelConfig, varnames=("zeta", "temp"),
                 rotate: bool = False, angler: Optional[np.ndarray] = None):
        self.cfg = cfg
        self.objects = list(objects)
        self.varnames = list(varnames)
        self.rotate = rotate
        self.angler = angler
        self.nc = NCWriter(path, provenance_attrs(cfg))
        self.nc.create_dim("time", None)
        self.nc.create_var("ocean_time", ("time",), "f8")
        for ob in self.objects:
            self.nc.create_dim(f"np_{ob.name}", ob.px.size)
            for v in self.varnames:
                dims = (("time", "s_rho", f"np_{ob.name}")
                        if v in ("u", "v", "temp", "salt")
                        else ("time", f"np_{ob.name}"))
                if "s_rho" in dims and "s_rho" not in self.nc.dimensions:
                    self.nc.create_dim("s_rho", cfg.nz)
                self.nc.create_var(f"{ob.name}_{v}", dims, "f8")
        self.rec = 0

    def write(self, state, grid):
        self.nc.write("ocean_time", float(state.time), rec=self.rec)
        for ob in self.objects:
            uv_done = False
            for v in self.varnames:
                if v in ("u", "v"):
                    if uv_done:
                        continue
                    ue, vn = extract_uv(state.u, state.v, ob.px, ob.py,
                                        grid, self.cfg,
                                        angler=self.angler if self.rotate
                                        else None)
                    if "u" in self.varnames:
                        self.nc.write(f"{ob.name}_u", host(ue),
                                      rec=self.rec)
                    if "v" in self.varnames:
                        self.nc.write(f"{ob.name}_v", host(vn),
                                      rec=self.rec)
                    uv_done = True
                    continue
                f = None
                for i in range(self.cfg.nt):
                    if v == tracer_name(self.cfg, i):
                        f = state.t[i]
                if f is None:
                    f = getattr(state, v)
                vals = extract_points(f, ob.px, ob.py, self.cfg)
                self.nc.write(f"{ob.name}_{v}", host(vals), rec=self.rec)
        self.rec += 1
        self.nc.sync()

    def close(self):
        self.nc.close()
