"""Barotropic (fast) mode: generalized FB AB3-AM4 stepping with fast-time
averaging (port of roms_tpu/ops/barotropic.py; reference:
src/step2d_FB.F, SM2005 Sec 2.3).

The `lax.scan` over sub-steps becomes a Python loop.  The averaging
weights w1/w2 stay host floats, so the loop never waits on the device.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from roms_tpu_torch.config import ModelConfig
from roms_tpu_torch.monitor import span
from roms_tpu_torch.ops import bc, rivers
from roms_tpu_torch.parallel.halo import shift


def _interior_mask(shape, cfg: ModelConfig, stagger: str, grid=None):
    """Points updated by the interior fast-averaging formula; the
    complement takes the boundary-strip formula (reference:
    step2d_FB.F:407-439 vs :474-528).  The edge strips are knocked out
    only on blocks owning the physical edge (grid.own_*: None on a single
    block, which owns every edge; Python bools on a mesh rank)."""
    own = [True if grid is None or getattr(grid, f"own_{e}") is None
           else bool(getattr(grid, f"own_{e}")) for e in "wesn"]
    ow, oe, os_, on = own
    jy, ix = shape
    pe, pn = cfg.pad_e, cfg.pad_n
    wlim = 3 if stagger == "u" else 2     # west of Fortran istrU=2
    slim = 3 if stagger == "v" else 2
    m = np.ones(shape, bool)
    if not cfg.ew_periodic:
        if ow:
            m[:, :wlim] = False
        if oe:
            m[:, ix - 2 - pe:] = False    # east of Fortran iend=nx
    if not cfg.ns_periodic:
        if os_:
            m[:slim, :] = False
        if on:
            m[jy - 2 - pn:, :] = False
    return torch.as_tensor(m, device=None if grid is None else grid.h.device)


# AB3-AM4 coefficient regimes (reference: step2d_FB.F:77-100)
FB_FIRST = dict(fwd=1.0, fwd1=0.0, fwd2=0.0,
                bkw_new=0.0, bkw=1.0, bkw1=0.0, bkw2=0.0)
FB_SECOND = dict(fwd=1.0, fwd1=0.0, fwd2=0.0,
                 bkw_new=1.0833333333333, bkw=-0.1666666666666,
                 bkw1=0.0833333333333, bkw2=0.0)
FB_GENERAL = dict(fwd=1.781105, fwd1=-1.06221, fwd2=0.281105,
                  bkw_new=0.614, bkw=0.285, bkw1=0.088, bkw2=0.013)

# DU_avg_bak update ratio delta/gamma = 0.21/2.05 (reference: step2d_FB.F:206-216)
BAK_RATIO = 0.1024390243902439


class FastState(NamedTuple):
    """Three past time levels of each prognostic plus the fast-time
    accumulators."""
    z_stp: torch.Tensor
    z_bak: torch.Tensor
    z_old: torch.Tensor
    u_stp: torch.Tensor
    u_bak: torch.Tensor
    u_old: torch.Tensor
    v_stp: torch.Tensor
    v_bak: torch.Tensor
    v_old: torch.Tensor
    zt_avg1: torch.Tensor
    du_avg1: torch.Tensor
    dv_avg1: torch.Tensor
    du_avg2: torch.Tensor
    dv_avg2: torch.Tensor


def _pg_terms(zwrk, rho_s, rho_a, h, grid, cfg: ModelConfig):
    """rzeta/rzeta2/rzetaSA combinations (reference: step2d_FB.F:167-177)."""
    if cfg.var_rho_2d:
        rzeta = (1.0 + rho_s) * zwrk
        rzeta_sa = zwrk * (rho_s - rho_a)
    else:
        rzeta = zwrk
        rzeta_sa = None
    rzeta2 = rzeta * zwrk
    return rzeta, rzeta2, rzeta_sa


def _pg_rubar(rzeta, rzeta2, rzeta_sa, zwrk, rho_a, h, grid, cfg: ModelConfig):
    """Barotropic pressure-gradient rubar/rvbar (reference: step2d_FB.F:245-268)."""
    cff = 0.5 * cfg.g
    h_w = shift(h, 0, -1)
    h_s = shift(h, -1, 0)
    ru = cff * grid.dn_u * ((h_w + h) * (shift(rzeta, 0, -1) - rzeta)
                            + shift(rzeta2, 0, -1) - rzeta2)
    rv = cff * grid.dm_v * ((h_s + h) * (shift(rzeta, -1, 0) - rzeta)
                            + shift(rzeta2, -1, 0) - rzeta2)
    if cfg.var_rho_2d:
        ru = ru + cff * grid.dn_u * (
            (h_w - h) * (shift(rzeta_sa, 0, -1) + rzeta_sa
                         + 0.333333333333 * (shift(rho_a, 0, -1) - rho_a)
                         * (shift(zwrk, 0, -1) - zwrk)))
        rv = rv + cff * grid.dm_v * (
            (h_s - h) * (shift(rzeta_sa, -1, 0) + rzeta_sa
                         + 0.333333333333 * (shift(rho_a, -1, 0) - rho_a)
                         * (shift(zwrk, -1, 0) - zwrk)))
    return ru, rv


def substep(fs: FastState, coeffs, w1: float, w2: float, rufrc, rvfrc,
            rho_s, rho_a, forcing, grid, cfg: ModelConfig, halo_fill,
            first: bool, du_avg_bak=None, dv_avg_bak=None):
    """One barotropic sub-step (reference: step2d_FB.F:102-574).

    With `first` also converts the 3D forcing (rufrc -= rubar), applies
    the PGF_FB_CORRECTION and returns (fs, (rufrc, rvfrc, du_avg_bak,
    dv_avg_bak))."""
    h = grid.h
    dtfast = cfg.dtfast
    fwd, fwd1, fwd2 = coeffs["fwd"], coeffs["fwd1"], coeffs["fwd2"]
    bkw_new, bkw, bkw1, bkw2 = (coeffs["bkw_new"], coeffs["bkw"],
                                coeffs["bkw1"], coeffs["bkw2"])

    # depth and fluxes of the extrapolated state (reference: :108-127)
    drhs = h + fwd * fs.z_stp + fwd1 * fs.z_bak + fwd2 * fs.z_old
    urhs = fwd * fs.u_stp + fwd1 * fs.u_bak + fwd2 * fs.u_old
    vrhs = fwd * fs.v_stp + fwd1 * fs.v_bak + fwd2 * fs.v_old
    duon = 0.5 * (drhs + shift(drhs, 0, -1)) * grid.dn_u * urhs
    dvom = 0.5 * (drhs + shift(drhs, -1, 0)) * grid.dm_v * vrhs

    # free surface update (reference: :150-178)
    zeta_new = (fs.z_stp + dtfast * grid.pm * grid.pn
                * (duon - shift(duon, 0, 1) + dvom - shift(dvom, 1, 0))
                + dtfast * forcing.swflx)
    if cfg.pipe_source:
        # pipe volume input to the free surface (reference: :155-159)
        zeta_new = zeta_new + torch.where(
            forcing.pipe_idx > 0,
            dtfast * grid.pm * grid.pn * forcing.pipe_flx, 0.0)
    if cfg.masking:
        zeta_new = zeta_new * grid.rmask
    with span("roms.fast.bc2d"):
        zeta_new = bc.zetabc(zeta_new, fs.z_stp, grid, cfg, forcing.bry)
    dnew = zeta_new + h
    zwrk = (bkw_new * zeta_new + bkw * fs.z_stp
            + bkw1 * fs.z_bak + bkw2 * fs.z_old)
    rzeta, rzeta2, rzeta_sa = _pg_terms(zwrk, rho_s, rho_a, h, grid, cfg)

    # fast-time averaging (reference: :199-234)
    if first:
        zt_avg1 = w1 * zeta_new
        du_avg2 = w2 * duon
        dv_avg2 = w2 * dvom
    else:
        zt_avg1 = fs.zt_avg1 + w1 * zeta_new
        du_avg2 = fs.du_avg2 + w2 * duon
        dv_avg2 = fs.dv_avg2 + w2 * dvom

    # barotropic pressure gradient (reference: :245-268)
    rubar, rvbar = _pg_rubar(rzeta, rzeta2, rzeta_sa, zwrk, rho_a, h, grid,
                             cfg)

    if first:
        # 3D r.h.s. integrals become forcing terms (reference: :313-331),
        # then PGF_FB_CORRECTION (reference: :333-384)
        rufrc = rufrc - rubar
        rvfrc = rvfrc - rvbar
        zwrk_c = zeta_new - fs.z_stp
        if cfg.var_rho_2d:
            rzeta_c = (1.0 + rho_s) * zwrk_c
            rzeta_sa_c = zwrk_c * (rho_s - rho_a)
        else:
            rzeta_c = zwrk_c
            rzeta_sa_c = None
        rzeta2_c = rzeta_c * (zeta_new + fs.z_stp)
        ru_c, rv_c = _pg_rubar(rzeta_c, rzeta2_c, rzeta_sa_c, zwrk_c,
                               rho_a, h, grid, cfg)
        rubar = rubar + ru_c
        rvbar = rvbar + rv_c

    # advance 2D momentum (reference: :396-439)
    dstp = fs.z_stp + h
    cff = 0.5 * dtfast
    cff1 = 0.5 * w1
    dstp_w = shift(dstp, 0, -1)
    dstp_s = shift(dstp, -1, 0)
    dnew_w = shift(dnew, 0, -1)
    dnew_s = shift(dnew, -1, 0)
    du_new = ((dstp + dstp_w) * fs.u_stp
              + cff * (grid.pm + shift(grid.pm, 0, -1))
              * (grid.pn + shift(grid.pn, 0, -1)) * (rubar + rufrc))
    dv_new = ((dstp + dstp_s) * fs.v_stp
              + cff * (grid.pm + shift(grid.pm, -1, 0))
              * (grid.pn + shift(grid.pn, -1, 0)) * (rvbar + rvfrc))
    if cfg.masking:
        du_new = du_new * grid.umask
        dv_new = dv_new * grid.vmask
    ubar_new = du_new / (dnew + dnew_w)
    vbar_new = dv_new / (dnew + dnew_s)

    with span("roms.fast.bc2d"):
        ubar_new = bc.u2dbc(ubar_new, fs.u_stp, fs.v_stp, zeta_new,
                            fs.z_stp, grid, cfg, forcing.bry)
        vbar_new = bc.v2dbc(vbar_new, fs.v_stp, fs.u_stp, zeta_new,
                            fs.z_stp, grid, cfg, forcing.bry)

    # fast-time flux averaging: interior formula from DUnew, boundary
    # strips from the BC'd ubar (reference: :420-437 vs :474-528)
    incr_u = cff1 * grid.dn_u * du_new
    incr_v = cff1 * grid.dm_v * dv_new
    if not cfg.fully_periodic:
        mu = _interior_mask(du_new.shape, cfg, "u", grid)
        mv = _interior_mask(dv_new.shape, cfg, "v", grid)
        edge_u = cff1 * (dnew + dnew_w) * ubar_new * grid.dn_u
        edge_v = cff1 * (dnew + dnew_s) * vbar_new * grid.dm_v
        incr_u = torch.where(mu, incr_u, edge_u)
        incr_v = torch.where(mv, incr_v, edge_v)

    if first:
        # EXTRAP_BAR_FLUXES history shift (reference: :205-223)
        du_avg_bak_new = fs.du_avg1 - BAK_RATIO * fs.du_avg2
        dv_avg_bak_new = fs.dv_avg1 - BAK_RATIO * fs.dv_avg2
        du_avg1 = incr_u
        dv_avg1 = incr_v
    else:
        du_avg_bak_new = du_avg_bak
        dv_avg_bak_new = dv_avg_bak
        du_avg1 = fs.du_avg1 + incr_u
        dv_avg1 = fs.dv_avg1 + incr_v

    # river barotropic overwrite (reference: :531-554)
    if cfg.river_source:
        ubar_new, vbar_new, du_avg1, dv_avg1 = rivers.overwrite_barotropic(
            ubar_new, vbar_new, du_avg1, dv_avg1, dnew, forcing, grid)

    # one halo refresh for the three 2D fields
    with span("roms.fast.halo"):
        zuv = halo_fill(torch.stack([zeta_new, ubar_new, vbar_new]))
    zeta_new, ubar_new, vbar_new = zuv[0], zuv[1], zuv[2]

    fs_new = FastState(
        z_stp=zeta_new, z_bak=fs.z_stp, z_old=fs.z_bak,
        u_stp=ubar_new, u_bak=fs.u_stp, u_old=fs.u_bak,
        v_stp=vbar_new, v_bak=fs.v_stp, v_old=fs.v_bak,
        zt_avg1=zt_avg1, du_avg1=du_avg1, dv_avg1=dv_avg1,
        du_avg2=du_avg2, dv_avg2=dv_avg2)
    if first:
        return fs_new, (rufrc, rvfrc, du_avg_bak_new, dv_avg_bak_new)
    return fs_new


def fast_loop(zeta0, ubar0, vbar0, rufrc, rvfrc, rho_s, rho_a, forcing,
              du_avg1_in, dv_avg1_in, du_avg2_in, dv_avg2_in,
              w1, w2, grid, cfg: ModelConfig, halo_fill):
    """Run all nfast barotropic sub-steps (reference: main.F:456-464).
    w1, w2: (nfast,) host float weights.  Under `monitor.tracing` the call
    is the span roms.fast_loop, and each sub-step roms.fast.substep, with
    its 2D boundary conditions (two roms.fast.bc2d: zetabc, then u2dbc and
    v2dbc) and its halo refresh (roms.fast.halo) inside."""
    with span("roms.fast_loop"):
        w1 = [float(x) for x in w1]
        w2 = [float(x) for x in w2]
        nfast = len(w1)
        fs = FastState(
            z_stp=zeta0, z_bak=zeta0, z_old=zeta0,
            u_stp=ubar0, u_bak=ubar0, u_old=ubar0,
            v_stp=vbar0, v_bak=vbar0, v_old=vbar0,
            zt_avg1=torch.zeros_like(zeta0),
            du_avg1=du_avg1_in, dv_avg1=dv_avg1_in,
            du_avg2=du_avg2_in, dv_avg2=dv_avg2_in)

        # sub-step 1: FE/backward + forcing conversion + PGF correction
        with span("roms.fast.substep"):
            fs, (rufrc, rvfrc, du_avg_bak, dv_avg_bak) = substep(
                fs, FB_FIRST, w1[0], w2[0], rufrc, rvfrc, rho_s, rho_a,
                forcing, grid, cfg, halo_fill, first=True)
        # sub-step 2: AB2-AM3; sub-steps 3..nfast: AB3-AM4
        for k in range(1, nfast):
            with span("roms.fast.substep"):
                fs = substep(fs, FB_SECOND if k == 1 else FB_GENERAL, w1[k],
                             w2[k], rufrc, rvfrc, rho_s, rho_a, forcing, grid,
                             cfg, halo_fill, first=False)

        zeta_avg = halo_fill(fs.zt_avg1)
        return dict(zeta=zeta_avg, ubar=fs.u_stp, vbar=fs.v_stp,
                    du_avg1=fs.du_avg1, dv_avg1=fs.dv_avg1,
                    du_avg2=fs.du_avg2, dv_avg2=fs.dv_avg2,
                    du_avg_bak=du_avg_bak, dv_avg_bak=dv_avg_bak,
                    rufrc=rufrc, rvfrc=rvfrc)
