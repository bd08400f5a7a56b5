"""Orlanski-binding auto-tuning against the parent's baroclinic wave flux
(port of roms_tpu/sponge_tune.py; reference: src/sponge_tune.F
adjust_orlanski).

A nested child adjusts a per-point binding velocity ub along each open
edge every step by

    ub <- clip(ub +/- alpha * (pflx - cflx),  ub_mn, ub_mx)
    alpha = 0.5 * ub_mx * dt / sp_timscale

(reference: sponge_tune.F:202-246), pflx the parent's outward baroclinic
pressure flux at that edge and cflx the child's own from
`pflx.calc_pflx`.  The sign flips on the north and east edges.  The
tuned arrays ride in BoundaryData.ub_*, which `ops/bc.py` reads in place
of the scalar cfg.ubind in the Orlanski terms.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

import torch

from roms_tpu_torch.config import ModelConfig
from roms_tpu_torch.state import _Replace

UB_MAX = 2.0     # (reference: sponge_tune.F:213)
UB_MIN = -1.0


@dataclass
class SpongeTune(_Replace):
    ub_west: Optional[torch.Tensor] = None    # (jy,)
    ub_east: Optional[torch.Tensor] = None
    ub_south: Optional[torch.Tensor] = None   # (ix,)
    ub_north: Optional[torch.Tensor] = None


def init_sponge_tune(cfg: ModelConfig, dtype: torch.dtype = torch.float64,
                     device=None) -> SpongeTune:
    """Every open edge starts at the scalar cfg.ubind."""
    h = cfg.halo
    jy, ix = cfg.ny + 2 * h, cfg.nx + 2 * h
    kw = {}
    for e, n in (("west", jy), ("east", jy), ("south", ix), ("north", ix)):
        if getattr(cfg, f"obc_{e}"):
            kw[f"ub_{e}"] = torch.full((n,), cfg.ubind, dtype=dtype,
                                       device=device)
    return SpongeTune(**kw)


def adjust_orlanski(tun: SpongeTune, up, vp, pflx: Dict[str, torch.Tensor],
                    cfg: ModelConfig,
                    sp_timscale: float = 86400.0) -> SpongeTune:
    """One tuning update (reference: sponge_tune.F:202-246).

    up/vp: column-integrated fast pressure fluxes from
    `pflx.calc_pflx`; pflx: the parent's edge series (same units) by edge
    name; a missing edge is left as it is."""
    alpha = 0.5 * UB_MAX * cfg.dt / sp_timscale

    def upd(ub, cflx, edge, sign):
        if ub is None or edge not in pflx:
            return ub
        new = ub + sign * alpha * (pflx[edge] - cflx)
        return torch.clamp(new, UB_MIN, UB_MAX)

    # the child's flux one face inside the boundary (reference: comp_cflx
    # pos=2), pad-aware on the east and north sides
    return SpongeTune(
        ub_west=upd(tun.ub_west, up[:, 3], "west", +1.0),
        ub_east=upd(tun.ub_east, up[:, -4 - cfg.pad_e], "east", -1.0),
        ub_south=upd(tun.ub_south, vp[3, :], "south", +1.0),
        ub_north=upd(tun.ub_north, vp[-4 - cfg.pad_n, :], "north", -1.0))


def to_boundary(tun: SpongeTune, bry):
    """The step's BoundaryData with the tuned binding velocities."""
    return bry.replace(ub_west=tun.ub_west, ub_east=tun.ub_east,
                       ub_south=tun.ub_south, ub_north=tun.ub_north)
