"""Tidal forcing: boundary harmonic tides and the surface tidal potential
(port of roms_tpu/tides.py; reference: src/tides.F).

`ntides` harmonic constituents, each with complex amplitude fields:
boundary tides add `Re * cos(wT) - Im * sin(wT)` onto the per-edge
zeta/ubar/vbar boundary data (reference: tides.F:127-227), and the
potential tide sums the same harmonic over the whole domain into `ptide`,
a surface pressure offset in the pressure-gradient term (reference:
tides.F:229-251, prsgrd.F:210 `P(N) -= g*ptide`).

Amplitudes live on the padded grid; the edge extraction uses the BC
operators' index map (zeta/vbar at the ghost ring, ubar at the boundary
u-column).  The phase ftide*(t + dt/2) is evaluated in the model dtype,
as the JAX package does.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from roms_tpu_torch.config import ModelConfig
from roms_tpu_torch.state import BoundaryData, _Replace


@dataclass
class TidalForcing(_Replace):
    """Harmonic constituent data (reference: tides.F:21-26).

    Every amplitude field is (ntides, jy, ix) on the padded grid; any may
    be None (e.g. no potential tide).
    """
    ftide: torch.Tensor                       # (ntides,) frequencies [rad/s]
    ztide_re: Optional[torch.Tensor] = None   # free-surface amplitude [m]
    ztide_im: Optional[torch.Tensor] = None
    utide_re: Optional[torch.Tensor] = None   # barotropic u amplitude [m/s]
    utide_im: Optional[torch.Tensor] = None
    vtide_re: Optional[torch.Tensor] = None
    vtide_im: Optional[torch.Tensor] = None
    ptide_re: Optional[torch.Tensor] = None   # equilibrium-tide potential [m]
    ptide_im: Optional[torch.Tensor] = None

    @property
    def bry_tides(self) -> bool:
        return self.ztide_re is not None

    @property
    def pot_tides(self) -> bool:
        return self.ptide_re is not None


def _harm(re, im, cosw, sinw):
    """sum_k re_k cos(w_k T) - im_k sin(w_k T) over constituents."""
    shape = (-1,) + (1,) * (re.dim() - 1)
    return torch.sum(re * cosw.reshape(shape) - im * sinw.reshape(shape),
                     dim=0)


def set_tides(tides: TidalForcing, time, cfg: ModelConfig,
              bry: Optional[BoundaryData] = None, add_to_bry: bool = True):
    """Evaluate the tidal boundary data and potential at the half-step
    time omT = ftide*(time + dt/2) (reference: tides.F:129); `time` is a
    0-d tensor of the model dtype.

    Returns (bry_out, ptide).  With `add_to_bry` the harmonic values are
    ADDED to the existing boundary data (slowly varying OBC data + tides,
    as the reference does after set_bry_all); otherwise they replace it.
    """
    om = tides.ftide * (time + 0.5 * cfg.dt)
    cosw, sinw = torch.cos(om), torch.sin(om)

    ptide = None
    if tides.pot_tides:
        ptide = _harm(tides.ptide_re, tides.ptide_im, cosw, sinw)

    if not tides.bry_tides:
        return bry, ptide

    z = _harm(tides.ztide_re, tides.ztide_im, cosw, sinw)
    u = _harm(tides.utide_re, tides.utide_im, cosw, sinw)
    v = _harm(tides.vtide_re, tides.vtide_im, cosw, sinw)

    def base(name, like):
        cur = getattr(bry, name, None) if bry is not None else None
        if cur is not None and add_to_bry:
            return cur
        return torch.zeros_like(like)

    kw = {}
    # edge extraction (reference: tides.F:133-226); index map in ops/bc.py
    edges = (("west", cfg.obc_west, (slice(None), 1), (slice(None), 2),
              (slice(None), 1)),
             ("east", cfg.obc_east, (slice(None), -2), (slice(None), -2),
              (slice(None), -2)),
             ("south", cfg.obc_south, (1, slice(None)), (1, slice(None)),
              (2, slice(None))),
             ("north", cfg.obc_north, (-2, slice(None)), (-2, slice(None)),
              (-2, slice(None))))
    for edge, on, sz, su, sv in edges:
        if on:
            kw[f"zeta_{edge}"] = base(f"zeta_{edge}", z[sz]) + z[sz]
            kw[f"ubar_{edge}"] = base(f"ubar_{edge}", u[su]) + u[su]
            kw[f"vbar_{edge}"] = base(f"vbar_{edge}", v[sv]) + v[sv]

    bry_out = (bry if bry is not None else BoundaryData()).replace(**kw)
    return bry_out, ptide
