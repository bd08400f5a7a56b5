"""True (absolute) vertical velocity diagnostic at RHO points (port of
roms_tpu/ops/wvlcty.py; reference: src/wvlcty.F wvlcty_tile).

Three contributions: the omega-like vertical velocity from the bottom-up
integral of the flux divergence (without the moving-grid "breathing"
term, scaled by pm*pn so that it is a velocity), interpolated to the
RHO levels with the reference's 4th-order stencil; plus the projection of
the quasi-horizontal motion on the sloping S surfaces.  Purely
diagnostic: nothing feeds back into the model (reference: wvlcty.F:20-26).
"""

from __future__ import annotations

import torch

from roms_tpu_torch.config import ModelConfig
from roms_tpu_torch.parallel.halo import eset, shift


def wvlcty(u, v, flx_u, flx_v, z_r, grid, cfg: ModelConfig):
    """(nz, jy, ix) absolute vertical velocity [m/s] at rho points."""
    pmn = grid.pm * grid.pn

    # bottom-up integral of the flux divergence, scaled to a velocity
    # (reference: wvlcty.F:62-84)
    div = -(pmn[None] * (shift(flx_u, 0, 1) - flx_u
                         + shift(flx_v, 1, 0) - flx_v))
    wrk = torch.cat([torch.zeros_like(div[:1]), torch.cumsum(div, dim=0)])

    nz = div.shape[0]
    # 4th-order interpolation of the interface values to rho points
    # (reference: wvlcty.F:85-98)
    mid = (0.5625 * (wrk[2:nz] + wrk[1:nz - 1])
           - 0.0625 * (wrk[3:nz + 1] + wrk[0:nz - 2]))
    top = 0.375 * wrk[nz] + 0.75 * wrk[nz - 1] - 0.125 * wrk[nz - 2]
    bot = -0.125 * wrk[2] + 0.75 * wrk[1] + 0.375 * wrk[0]
    wvlc = torch.cat([bot[None], mid, top[None]])

    # projection of the horizontal motion on the S-surface slopes
    # (reference: wvlcty.F:101-124)
    wxi = u * (z_r - shift(z_r, 0, -1)) * (grid.pm + shift(grid.pm, 0, -1))
    weta = v * (z_r - shift(z_r, -1, 0)) * (grid.pn + shift(grid.pn, -1, 0))
    wvlc = wvlc + 0.25 * (wxi + shift(wxi, 0, 1) + weta + shift(weta, 1, 0))

    # gradient lateral conditions at physical edges
    # (reference: wvlcty.F:139-180)
    pe, pn_ = cfg.pad_e, cfg.pad_n
    if not cfg.ew_periodic:
        wvlc = eset(wvlc, (Ellipsis, slice(None), 1), wvlc[..., :, 2],
                    grid.own_w)
        wvlc = eset(wvlc, (Ellipsis, slice(None), -2 - pe),
                    wvlc[..., :, -3 - pe], grid.own_e)
    if not cfg.ns_periodic:
        wvlc = eset(wvlc, (Ellipsis, 1, slice(None)), wvlc[..., 2, :],
                    grid.own_s)
        wvlc = eset(wvlc, (Ellipsis, -2 - pn_, slice(None)),
                    wvlc[..., -3 - pn_, :], grid.own_n)
    if cfg.masking:
        wvlc = wvlc * grid.rmask[None]
    return wvlc
