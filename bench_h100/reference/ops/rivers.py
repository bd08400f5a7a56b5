"""River point sources (port of roms_tpu/ops/rivers.py; reference:
src/river_frc.F).

Rivers enter through faces between a land (masked) source cell and a water
cell.  The per-face arrays riv_uflx/riv_vflx encode both the river index
and the signed fraction of that river's volume through the face as
±frac + 10*index: the index is nint(x/10), the fraction x - 10*index
(reference: pre_step3d4S.F:493-522, step2d_FB.F:531-554,
compute_horiz_tracer_fluxes.h:217-246).  `torch.round` rounds half to
even, as `jnp.rint` does.
"""

from __future__ import annotations

import numpy as np
import torch

from bench_h100.reference.parallel.halo import shift


def _decode(face_flx, riv_vol):
    """(active mask, river volume flux through the face, river index) per
    face; the index is a long tensor, ready for gathers."""
    active = torch.abs(face_flx) > 1.0e-3
    irv = torch.round(face_flx / 10.0).long()
    frac = face_flx - 10.0 * irv.to(face_flx.dtype)
    flux = riv_vol[irv.clamp(0, riv_vol.shape[0] - 1)] * frac
    return active, flux, irv


def depth_u(z_w):
    """0.5*(column depth + west-neighbour column depth) at u faces
    (reference: pre_step3d4S.F:497-498)."""
    d = z_w[-1] - z_w[0]
    return 0.5 * (d + shift(d, 0, -1))


def depth_v(z_w):
    d = z_w[-1] - z_w[0]
    return 0.5 * (d + shift(d, -1, 0))


def overwrite_uv(u, v, forcing, z_w, grid):
    """Force river face velocities over the whole column
    (reference: pre_step3d4S.F:493-522, step3d_uv2.F:689-717)."""
    au, fu, _ = _decode(forcing.riv_uflx, forcing.riv_vol)
    av, fv, _ = _decode(forcing.riv_vflx, forcing.riv_vol)
    uvel = fu / (grid.dn_u * depth_u(z_w))
    vvel = fv / (grid.dm_v * depth_v(z_w))
    u = torch.where(au[None], uvel[None], u)
    v = torch.where(av[None], vvel[None], v)
    return u, v


def overwrite_barotropic(ubar, vbar, du_avg1, dv_avg1, dnew, forcing, grid):
    """Force river barotropic velocities and fast-averaged fluxes
    (reference: step2d_FB.F:531-554)."""
    au, fu, _ = _decode(forcing.riv_uflx, forcing.riv_vol)
    av, fv, _ = _decode(forcing.riv_vflx, forcing.riv_vol)
    ubar = torch.where(
        au, fu * 2.0 / (grid.dn_u * (dnew + shift(dnew, 0, -1))), ubar)
    vbar = torch.where(
        av, fv * 2.0 / (grid.dm_v * (dnew + shift(dnew, -1, 0))), vbar)
    du_avg1 = torch.where(au, fu, du_avg1)
    dv_avg1 = torch.where(av, fv, dv_avg1)
    return ubar, vbar, du_avg1, dv_avg1


def tracer_flux_fix_all(fx, fe, hz, z_w, forcing, grid):
    """Replace the advective tracer fluxes at river faces with the river's
    tracer load, all tracers at once: fx/fe are (nt, nz, jy, ix)
    (reference: compute_horiz_tracer_fluxes.h:217-246)."""
    au, fu, iu = _decode(forcing.riv_uflx, forcing.riv_vol)
    av, fv, iv = _decode(forcing.riv_vflx, forcing.riv_vol)
    uvel = fu / depth_u(z_w)      # no dn_u here, as in the reference
    vvel = fv / depth_v(z_w)
    nriv = forcing.riv_vol.shape[0]
    # the (nriv, nt) table gathered at every face, moved to (nt, jy, ix)
    trc_u = forcing.riv_trc[iu.clamp(0, nriv - 1)].movedim(-1, 0)
    trc_v = forcing.riv_trc[iv.clamp(0, nriv - 1)].movedim(-1, 0)
    hzu = 0.5 * (hz + shift(hz, 0, -1))
    hzv = 0.5 * (hz + shift(hz, -1, 0))
    fx = torch.where(au[None, None],
                     trc_u[:, None] * (hzu * uvel[None])[None], fx)
    fe = torch.where(av[None, None],
                     trc_v[:, None] * (hzv * vvel[None])[None], fe)
    return fx, fe


def build_river_faces(rmask, rfrc, ridx):
    """Distribute each river cell's fraction to its unmasked neighbour
    faces with the ±frac/faces + 10*index encoding; numpy in, numpy out
    (reference: river_frc.F:240-280, calc_river_flux)."""
    jy, ix = rmask.shape
    uflx = np.zeros((jy, ix))
    vflx = np.zeros((jy, ix))
    for j in range(1, jy - 1):
        for i in range(1, ix - 1):
            if rfrc[j, i] > 0:
                faces = (rmask[j, i - 1] + rmask[j, i + 1]
                         + rmask[j - 1, i] + rmask[j + 1, i])
                if faces == 0 or rmask[j, i] > 0:
                    raise ValueError(f"river grid position error at {i},{j}")
                if rmask[j, i - 1] > 0:
                    uflx[j, i] = -rfrc[j, i] / faces + 10 * ridx[j, i]
                if rmask[j, i + 1] > 0:
                    uflx[j, i + 1] = rfrc[j, i] / faces + 10 * ridx[j, i]
                if rmask[j - 1, i] > 0:
                    vflx[j, i] = -rfrc[j, i] / faces + 10 * ridx[j, i]
                if rmask[j + 1, i] > 0:
                    vflx[j + 1, i] = rfrc[j, i] / faces + 10 * ridx[j, i]
    return uflx, vflx
