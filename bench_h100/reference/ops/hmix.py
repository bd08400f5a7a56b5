"""Lateral (along-sigma) harmonic mixing of momentum and tracers (port of
roms_tpu/ops/hmix.py).

visc3d: horizontal divergence of the transverse-isotropic stress tensor
(reference: src/visc3d_S.F, Wajsowicz 1993); on the step's path.
t3dmix: Laplacian tracer diffusion along S-surfaces (reference:
src/t3dmix_S.F, TS_DIF2); the step runs it fused into the corrector
tracer kernel, and this is the plain reference of that fused term.
"""

from __future__ import annotations

import torch

from bench_h100.reference.config import ModelConfig
from bench_h100.reference.parallel.halo import shift


def visc3d(u, v, hz, grid, cfg: ModelConfig, visc2_r=None, visc2_p=None):
    """Return (du, dv, drufrc, drvfrc): Hz-weighted momentum tendencies
    [m^2/s^2] and their vertical integrals (reference: visc3d_S.F:50-132).
    u, v are the time-n velocities [m/s] (the reference uses nstp)."""
    if visc2_r is None:
        visc2_r = torch.full_like(grid.h, cfg.visc2)
    if visc2_p is None:
        visc2_p = torch.full_like(grid.h, cfg.visc2)
    pm, pn = grid.pm, grid.pn

    # divergence-type stress at rho points
    cff = 0.5 * hz * visc2_r[None] * (
        (grid.dn_r * pm)[None] * ((pn + shift(pn, 0, 1))[None] * shift(u, 0, 1)
                                  - (shift(pn, 0, -1) + pn)[None] * u)
        - (grid.dm_r * pn)[None] * ((pm + shift(pm, 1, 0))[None] * shift(v, 1, 0)
                                    - (shift(pm, -1, 0) + pm)[None] * v))
    ufx = cff * (grid.dn_r * grid.dn_r)[None]
    vfe = -cff * (grid.dm_r * grid.dm_r)[None]

    # shear-type stress at psi points
    hz_p = (shift(hz, 0, -1) + hz + shift(hz, -1, -1) + shift(hz, -1, 0))
    pm_p = shift(pm, 0, -1) + pm + shift(pm, -1, -1) + shift(pm, -1, 0)
    pn_p = shift(pn, 0, -1) + pn + shift(pn, -1, -1) + shift(pn, -1, 0)
    cff_p = 0.125 * hz_p * visc2_p[None] * (
        (0.25 * pm_p * grid.dn_p)[None]
        * ((shift(pn, -1, 0) + pn)[None] * v
           - (shift(pn, -1, -1) + shift(pn, 0, -1))[None] * shift(v, 0, -1))
        + (0.25 * pn_p * grid.dm_p)[None]
        * ((shift(pm, 0, -1) + pm)[None] * u
           - (shift(pm, -1, -1) + shift(pm, -1, 0))[None] * shift(u, -1, 0)))
    if cfg.masking:
        cff_p = cff_p * grid.pmask[None]
    ufe = cff_p * (grid.dm_p * grid.dm_p)[None]
    vfx = cff_p * (grid.dn_p * grid.dn_p)[None]

    pm_w = shift(pm, 0, -1)
    pn_w = shift(pn, 0, -1)
    du = (0.125 * (pm_w + pm) * (pn_w + pn))[None] * (
        (pn_w + pn)[None] * (ufx - shift(ufx, 0, -1))
        + (pm_w + pm)[None] * (shift(ufe, 1, 0) - ufe))
    pm_s = shift(pm, -1, 0)
    pn_s = shift(pn, -1, 0)
    dv = (0.125 * (pm_s + pm) * (pn_s + pn))[None] * (
        (pn_s + pn)[None] * (shift(vfx, 0, 1) - vfx)
        + (pm_s + pm)[None] * (vfe - shift(vfe, -1, 0)))
    return du, dv, torch.sum(du, dim=0), torch.sum(dv, dim=0)


def t3dmix(t_new, t_rhs_level, hz, grid, cfg: ModelConfig, diff2=None):
    """Add Laplacian tracer diffusion along sigma surfaces to t_new
    (reference: t3dmix_S.F:45-99); t_rhs_level (nt, nz, jy, ix) supplies
    the differenced field (time nrhs = n+1/2).  All tracers at once: the
    JAX package's per-tracer loop is the same arithmetic per tracer."""
    if diff2 is None:
        diff2 = torch.full((cfg.nt,) + tuple(grid.h.shape), cfg.tnu2,
                           dtype=t_new.dtype, device=t_new.device)
    d2 = diff2[:, None]                               # (nt, 1, jy, ix)
    tk = t_rhs_level
    fx = (0.25 * (d2 + shift(d2, 0, -1)) * grid.pmon_u
          * (hz + shift(hz, 0, -1)) * (tk - shift(tk, 0, -1)))
    fe = (0.25 * (d2 + shift(d2, -1, 0)) * grid.pnom_v
          * (hz + shift(hz, -1, 0)) * (tk - shift(tk, -1, 0)))
    if cfg.masking:
        fx = fx * grid.umask
        fe = fe * grid.vmask
    tend = (cfg.dt * (grid.pm * grid.pn)
            * (shift(fx, 0, 1) - fx + shift(fe, 1, 0) - fe) / hz)
    return t_new + tend
