"""Upscaling output: time-averaged boundary advective tracer fluxes, which
build the CDR forcing of a parent domain from a child run (port of
roms_tpu/io/upscale.py; reference: src/upscale_output.F; the step
captures the rates when cfg.upscale_output, upscale_output.F:232-313).

For a tracer pair (perturbed, control), e.g. (ALK, ALK_alt) in the
reference, the recorded "added flux" is the difference of their outward
boundary fluxes: the flux of the CDR perturbation alone (reference:
upscale_output.F wrt_upscale ALK_add = rate - alt_rate).
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from roms_tpu_torch.config import ModelConfig
from roms_tpu_torch.io.netcdf import NCWriter
from roms_tpu_torch.io.output import host, provenance_attrs


class UpscaleWriter:
    """Accumulates the per-step boundary fluxes in float64 on the host and
    writes period averages.

    tracer_pairs: list of (name, itrc, itrc_control).  With
    itrc_control=None the raw outward flux of itrc is recorded.
    """

    def __init__(self, path: str, grid, cfg: ModelConfig,
                 tracer_pairs: Sequence[Tuple[str, int, Optional[int]]],
                 navg: int = 1):
        self.cfg = cfg
        self.pairs = list(tracer_pairs)
        self.navg = navg
        self.edges = [e for e in ("west", "east", "south", "north")
                      if getattr(cfg, f"obc_{e}")]
        self.nc = NCWriter(path, provenance_attrs(cfg))
        self.nc.create_dim("time", None)
        self.nc.create_dim("s_rho", cfg.nz)
        self.nc.create_dim("xi_rho", cfg.nx)
        self.nc.create_dim("eta_rho", cfg.ny)
        self.nc.create_var("ocean_time", ("time",), "f8")
        for e in self.edges:
            dim = "eta_rho" if e in ("west", "east") else "xi_rho"
            for name, _, _ in self.pairs:
                self.nc.create_var(
                    f"{name}_add_{e}", ("time", "s_rho", dim), "f8",
                    {"long_name": f"outward advective flux of {name} "
                                  f"through the {e} boundary",
                     "units": "tracer m^3 s^-1"})
        self._acc: Dict[str, np.ndarray] = {}
        self._count = 0
        self.rec = 0

    def accumulate(self, state):
        """Add one step's capture; the edges' strips come to the host in
        one copy."""
        if state.upscale is None:
            raise ValueError("state carries no upscale capture; "
                             "set cfg.upscale_output=True")
        strips = [state.upscale[e] for e in self.edges]
        flat = host(torch.cat([s.reshape(-1) for s in strips]))
        flat = flat.astype(np.float64)
        offs = np.cumsum([0] + [s.numel() for s in strips])
        for e, s, o in zip(self.edges, strips, offs):
            # captured at the full local edge length (halo rows included):
            # trimmed to the interior for output
            rate = flat[o:o + s.numel()].reshape(s.shape)[..., 2:-2]
            for name, itrc, ictl in self.pairs:
                add = rate[itrc] - (rate[ictl] if ictl is not None else 0.0)
                key = f"{name}_add_{e}"
                self._acc[key] = self._acc.get(key, 0.0) + add
        self._acc["ocean_time"] = self._acc.get("ocean_time", 0.0) \
            + float(state.time)
        self._count += 1
        if self._count >= self.navg:
            self._flush()

    def _flush(self):
        inv = 1.0 / self._count
        self.nc.write("ocean_time", self._acc.pop("ocean_time") * inv,
                      rec=self.rec)
        for key, val in self._acc.items():
            self.nc.write(key, val * inv, rec=self.rec)
        self.rec += 1
        self.nc.sync()
        self._acc = {}
        self._count = 0

    def close(self):
        if self._count:
            self._flush()
        self.nc.close()
