"""Vertical terrain-following S-coordinate (port of roms_tpu/vcoord.py;
reference: src/set_scoord.F, src/set_depth.F, SM09 transform).

The stretching curves are numpy float64, computed once at setup.
"""

from __future__ import annotations

import numpy as np
import torch


def csf(sc: np.ndarray, theta_s: float, theta_b: float) -> np.ndarray:
    """Stretching curve CSF (reference: src/set_scoord.F:52-66)."""
    sc = np.asarray(sc, dtype=np.float64)
    if theta_s > 0.0:
        csrf = (1.0 - np.cosh(theta_s * sc)) / (np.cosh(theta_s) - 1.0)
    else:
        csrf = -sc ** 2
    if theta_b > 0.0:
        return (np.exp(theta_b * csrf) - 1.0) / (1.0 - np.exp(-theta_b))
    return csrf


def stretching_curves(nz: int, theta_s: float, theta_b: float):
    """Cs_w (nz+1,) at W-points and Cs_r (nz,) at RHO-points, numpy f64
    (reference: src/set_scoord.F:16-26; Cs_w[0]=-1, Cs_w[N]=0)."""
    ds = 1.0 / nz
    k_w = np.arange(0, nz + 1, dtype=np.float64)
    sc_w = ds * (k_w - nz)
    cs_w = csf(sc_w, theta_s, theta_b)
    cs_w[0] = -1.0
    cs_w[nz] = 0.0
    k_r = np.arange(1, nz + 1, dtype=np.float64)
    sc_r = ds * (k_r - nz - 0.5)
    cs_r = csf(sc_r, theta_s, theta_b)
    return cs_w, cs_r


def set_depth(zeta, h, hinv, cs_w, cs_r, hc: float, nz: int):
    """Moving z-coordinates from the free surface
    (reference: src/set_depth.F:65-90).  zeta, h, hinv: padded 2D tensors;
    cs_w (nz+1,), cs_r (nz,) tensors.  Returns z_w, z_r, Hz."""
    ds = 1.0 / nz
    kw = dict(dtype=zeta.dtype, device=zeta.device)
    k_w = torch.arange(0, nz + 1, **kw)[:, None, None]
    k_r = torch.arange(1, nz + 1, **kw)[:, None, None]
    cff_w = hc * ds * (k_w - nz)
    cff_r = hc * ds * (k_r - nz - 0.5)
    d = (zeta + h)[None] * hinv[None]
    z_w = zeta[None] + d * (cff_w + cs_w[:, None, None] * h[None])
    z_w[0] = -h            # exact bottom (reference: set_depth.F:68)
    z_r = zeta[None] + d * (cff_r + cs_r[:, None, None] * h[None])
    hz = z_w[1:] - z_w[:-1]
    return z_w, z_r, hz
