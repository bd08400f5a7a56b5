"""One baroclinic time step: LF-AM3 predictor/corrector with the
forward-backward barotropic sub-cycle (port of roms_tpu/stepper.py;
reference: src/main.F:333-520, pre_step3d4S.F, step3d_uv1.F,
step3d_uv2.F, step3d_t_ISO.F).

All four implicit momentum solves go through `cuda_solve.momentum_implicit`
and, under LMD_KPP, both vertical-mixing updates through
`cuda_kpp.vmix_update` for every configuration that `cuda_kpp.usable`
admits (not a mesh block's padded grid, whose updates take the plain
version, as the JAX package's gate does).  Both tracer stages go through
`cuda_tracer.tracer_stage` for every configuration that
`cuda_tracer.usable` admits; the others (river sources, the options of
the batched branch, a padded grid) take the reference's batched tracer
branch, whose river flux fix sits inside the stencil.  Those gates decide
the paths: never the device, the dtype or a build.  Each wrapper launches its CUDA kernel on the card and
runs its plain version on the CPU.  Point loads (pipes, mCDR releases)
enter both tracer paths; the BGC column physics (`bgc_update`) follows
the corrector's boundary conditions, inside the span `roms.bgc`, and
`bgc_stats` counts its calls and the host seconds of each.

The rotated (isoneutral) biharmonic, the upscale capture and the tracer
budget live on the batched branch only, as `cuda_tracer.usable` says.
The momentum budget and the non-hydrostatic projection (`nhmg.nh_solve`,
with the JAX package's zero trial w, its nh.w discarded) ride on both
tracer paths.  The optional outputs come back on the state: `upscale`
(outward boundary tracer fluxes per open edge), `t_budget` and
`uv_budget` (Hz-weighted per-step terms), each None when its flag is off.
"""

from __future__ import annotations

import time
from collections import deque

import torch

from roms_tpu_torch import nhmg, vcoord
from roms_tpu_torch.bgc import bec
from roms_tpu_torch.bgc.api import BGCContext, get_model
from roms_tpu_torch.cdr import apply_cdr_all
from roms_tpu_torch.config import ModelConfig
from roms_tpu_torch.grid import Grid
from roms_tpu_torch.monitor import span
from roms_tpu_torch.ops import advection as adv
from roms_tpu_torch.ops import (barotropic, bc, cuda_kpp, cuda_solve,
                                cuda_tracer, eos, hmix, isoneutral,
                                kinematics, rivers, vmix)
from roms_tpu_torch.ops import prsgrd as prsgrd_mod
from roms_tpu_torch.ops.kinematics import hz_u, hz_v
from roms_tpu_torch.parallel.halo import HaloExchange, make_halo_fill, shift
from roms_tpu_torch.state import Forcing, OceanState

AM3_CRV = 1.0 / 6.0  # (reference: pre_step3d4S.F:83)

# calls of `bgc_update`, traced or not, and the host seconds of the most
# recent ones (time.perf_counter around the call, no synchronize)
bgc_stats = {"calls": 0, "host_s": deque(maxlen=4096)}


def _unsupported(cfg: ModelConfig):
    """Names of the enabled step features the port does not carry: none,
    since every flag of the JAX package's step is ported."""
    return []


def _tracer_divergence(fx, fe, pmn):
    return pmn[None] * (shift(fx, 0, 1) - fx + shift(fe, 1, 0) - fe)


def _pipe_load(forcing: Forcing, pmn, cfg: ModelConfig):
    """Hz-weighted tracer content the pipes add in one step, dt * pmn *
    pipe_flx * pipe_prf(k) * pipe_trc, (nt, nz, jy, ix)
    (reference: step3d_t_ISO.F:927-934)."""
    src3d = kinematics.pipe_profile_3d(forcing, cfg.nz)
    npip = forcing.pipe_trc.shape[0]
    idx = forcing.pipe_idx.long().clamp(0, npip - 1)
    trc_p = forcing.pipe_trc[idx].movedim(-1, 0)         # (nt, jy, ix)
    return cfg.dt * pmn[None] * src3d[None] * trc_p[:, None]


def _kpp_sources(state: OceanState, forcing: Forcing, ghat, wi,
                 cfg: ModelConfig):
    """Hz-weighted content the penetrating solar and nonlocal KPP terms
    add in one step to T and, with ghat and salinity, to S (None
    otherwise) (reference: step3d_t_ISO.F:961-1005)."""
    nzz = cfg.nz
    gsrc = forcing.srflx[None] * state.swrf[1:nzz]
    if ghat is not None:
        gsrc = gsrc - ghat[1:nzz] * (forcing.stflx[cfg.itemp]
                                     - forcing.srflx)[None]
    gw = torch.zeros_like(wi)
    gw[1:nzz] = gsrc
    src_t = cfg.dt * (gw[1:] - gw[:-1])
    src_s = None
    if cfg.salinity and ghat is not None:
        gws = torch.zeros_like(wi)
        gws[1:nzz] = -ghat[1:nzz] * forcing.stflx[cfg.isalt][None]
        src_s = cfg.dt * (gws[1:] - gws[:-1])
    return src_t, src_s


def _uv_rhs(u, v, flx_u, flx_v, hz, we, grid, cfg: ModelConfig, scheme,
            parts: bool = False):
    """Coriolis + horizontal + vertical momentum advection r.h.s.
    (reference: compute_horiz_rhs_uv_terms.h + compute_vert_rhs_uv_terms.h).

    With parts=True also returns the Coriolis part (cori_u, cori_v) for
    the momentum budget (reference: diagnostics.F icori/iadv)."""
    ru = torch.zeros_like(u)
    rv = torch.zeros_like(v)
    rc_u = rc_v = None
    if cfg.uv_cor or (cfg.curvgrid and cfg.uv_adv):
        rc_u, rc_v = adv.coriolis_rhs(u, v, hz, grid, cfg)
        ru = ru + rc_u
        rv = rv + rc_v
    if cfg.uv_adv:
        ra_u, ra_v = adv.horiz_uv_adv_rhs(u, v, flx_u, flx_v, grid, cfg,
                                          scheme)
        ru = ru + ra_u
        rv = rv + ra_v
        ru = ru + adv.vert_uv_rhs_spline(u, hz, we, grid.umask, grid, cfg, "u")
        rv = rv + adv.vert_uv_rhs_spline(v, hz, we, grid.vmask, grid, cfg, "v")
    if parts:
        return (ru, rv, torch.zeros_like(u) if rc_u is None else rc_u,
                torch.zeros_like(v) if rc_v is None else rc_v)
    return ru, rv


def step_impl(state: OceanState, forcing: Forcing, grid: Grid, w1, w2,
              cfg: ModelConfig, first_step: bool, halo) -> OceanState:
    """Step body with a pluggable halo refresh; w1/w2 are the host
    fast-time weights.  Under `monitor.tracing` its phases are spans:
    roms.predictor, roms.corrector_3d, roms.fast_loop (opened by
    `barotropic.fast_loop`), roms.uv2, roms.tracer_corrector and
    roms.finish, with roms.bgc inside it where a BGC engine runs."""
    missing = _unsupported(cfg)
    if missing:
        raise NotImplementedError(
            "not ported in this slice: " + ", ".join(missing))
    pmn = grid.pm * grid.pn
    hz_n = state.hz
    zw_n, zr_n = state.z_w, state.z_r
    akv, akt = state.akv, state.akt
    hbls, hbbl = state.hbls, state.hbbl
    ghat = None

    with span("roms.predictor"):
        # surface flux restoring toward SST/SSS
        # (reference: surf_flux.F:140-163)
        if cfg.qcorrection and forcing.sst is not None:
            stflx = forcing.stflx.clone()
            stflx[cfg.itemp] = -cfg.dsstdt * (state.t[cfg.itemp, -1]
                                              - forcing.sst)
            forcing = forcing.replace(stflx=stflx)
        if cfg.sflx_corr and cfg.salinity and forcing.sss is not None:
            stflx = forcing.stflx.clone()
            stflx[cfg.isalt] = stflx[cfg.isalt] - cfg.dsssdt * (
                state.t[cfg.isalt, -1] - forcing.sss)
            forcing = forcing.replace(stflx=stflx)

        # ================= PREDICTOR (reference: main.F:385-423) =============
        eos_n = eos.rho_eos(state.t, zr_n, zw_n, hz_n, grid.rmask, cfg,
                            need_bvf=cfg.lmd_kpp)
        flx_u, flx_v = kinematics.set_huv(state.u, state.v, hz_n, grid)
        flx_u, flx_v = halo(flx_u), halo(flx_v)
        # (omega.F:66-73)
        dtau_o = 0.5 * cfg.dt if first_step else 0.6 * cfg.dt
        om = kinematics.omega(flx_u, flx_v, zw_n, hz_n, forcing.swflx, grid,
                              dtau_o, cfg, forcing)
        we, wi = halo(om.we), halo(om.wi)

        vmix_update = (cuda_kpp.vmix_update if cuda_kpp.usable(cfg)
                       else cuda_kpp.vmix_update_plain)
        if cfg.lmd_kpp:
            # lmd_vmix + lmd_kpp at time n (reference: main.F:408-410)
            vm = vmix_update(state, state.u, state.v, state.t, eos_n.bvf, zr_n,
                             zw_n, hz_n, forcing, grid, cfg, first_step)
            akv, akt = halo(vm.akv), halo(vm.akt)
            # (reference: lmd_kpp.F exchanges hbls/hbbl after smoothing)
            hbls, hbbl = halo(vm.hbls), halo(vm.hbbl)

        ru_p, rv_p = prsgrd_mod.prsgrd(eos_n.rho, eos_n.rho1, eos_n.qp1,
                                       zr_n, zw_n, hz_n, grid, cfg,
                                       ptide=forcing.ptide)

        # pre_step3d: LF-AM3 predictor to n+1/2 (pre_step3d4S.F:124-545)
        if first_step:
            dtau = 0.5 * cfg.dt
            cf_stp, cf_bak = 1.0, 0.0
        else:
            dtau = cfg.dt * (1.0 - AM3_CRV)
            cf_stp, cf_bak = 0.5 + AM3_CRV, 0.5 - AM3_CRV

        flx_div = 0.5 * dtau * pmn[None] * (
            shift(flx_u, 0, 1) - flx_u + shift(flx_v, 1, 0) - flx_v
            + (we[1:] + wi[1:]) - (we[:-1] + wi[:-1]))
        hz_bak = hz_n + flx_div
        hz_fwd = hz_n - flx_div

        own = (grid.own_w, grid.own_e, grid.own_s, grid.own_n)
        use_kernel = cuda_tracer.usable(cfg)
        if use_kernel:
            t_half = cuda_tracer.tracer_stage(
                state.t, state.t_prev, flx_u, flx_v, hz_n, flx_div, we, wi,
                akt, pmn, grid.rmask, grid.umask, grid.vmask, cfg,
                cfg.ts_pred_scheme, dtau, cf_stp, cf_bak, False, "pred",
                own=own)
        else:
            # the reference's batched branch (roms_tpu/stepper.py:201-215)
            fx, fe = adv.horiz_tracer_flux(state.t, flx_u, flx_v, grid, cfg,
                                           cfg.ts_pred_scheme)
            if cfg.river_source:
                fx, fe = rivers.tracer_flux_fix_all(fx, fe, hz_n, zw_n,
                                                    forcing, grid)
            t_rhs = (hz_bak * (cf_stp * state.t + cf_bak * state.t_prev)
                     - dtau * _tracer_divergence(fx, fe, pmn))
            fc = adv.vert_tracer_flux_spline(state.t, hz_n, we)
            t_rhs = t_rhs - dtau * pmn[None] * (fc[:, 1:] - fc[:, :-1])
            t_half = vmix.tracer_implicit_all(
                t_rhs, hz_fwd, vmix.gather_akt(akt, cfg), wi, pmn, dtau,
                grid.rmask, cfg, apply_mask=False)

        # momentum predictor
        ru, rv = _uv_rhs(state.u, state.v, flx_u, flx_v, hz_n, we, grid, cfg,
                         cfg.uv_pred_scheme)
        ru = ru_p + ru
        rv = rv_p + rv
        rd = vmix.bottom_drag(state.u, state.v, hz_n, cfg)

        dc0_u = dtau * 0.25 * (grid.pm + shift(grid.pm, 0, -1)) * (
            grid.pn + shift(grid.pn, 0, -1))
        dc0_v = dtau * 0.25 * (grid.pm + shift(grid.pm, -1, 0)) * (
            grid.pn + shift(grid.pn, -1, 0))
        hzbak_u = 0.5 * (hz_bak + shift(hz_bak, 0, -1))
        hzbak_v = 0.5 * (hz_bak + shift(hz_bak, -1, 0))
        rhs_u = (hzbak_u * (cf_stp * state.u + cf_bak * state.u_prev)
                 + dc0_u[None] * ru)
        rhs_v = (hzbak_v * (cf_stp * state.v + cf_bak * state.v_prev)
                 + dc0_v[None] * rv)
        u_half = cuda_solve.momentum_implicit(
            rhs_u, 0.5 * (hz_fwd + shift(hz_fwd, 0, -1)),
            0.5 * (akv + shift(akv, 0, -1)),
            0.5 * (wi + shift(wi, 0, -1)), dc0_u, dtau, forcing.sustr, cfg,
            bottom_drag_coeff=0.5 * (rd + shift(rd, 0, -1)))
        v_half = cuda_solve.momentum_implicit(
            rhs_v, 0.5 * (hz_fwd + shift(hz_fwd, -1, 0)),
            0.5 * (akv + shift(akv, -1, 0)),
            0.5 * (wi + shift(wi, -1, 0)), dc0_v, dtau, forcing.svstr, cfg,
            bottom_drag_coeff=0.5 * (rd + shift(rd, -1, 0)))

        # river velocity overwrite, physical BCs, tracer ghost refresh
        # (pre_step3d4S.F:493-550)
        if cfg.river_source:
            u_half, v_half = rivers.overwrite_uv(u_half, v_half, forcing, zw_n,
                                                 grid)
        u_half = bc.u3dbc(u_half, state.u, state.u, state.v, grid, cfg,
                          forcing.bry, pred_stage=True)
        v_half = bc.v3dbc(v_half, state.v, state.u, state.v, grid, cfg,
                          forcing.bry, pred_stage=True)
        t_half = bc.t3dbc(t_half, state.t, state.u, state.v, grid, cfg,
                          forcing.bry, pred_stage=True)
        t_half = halo(t_half)

        # set_HUV1: barotropic mismatch, fluxes at n+1/2 (set_depth.F:252-422)
        h1 = kinematics.set_huv1(u_half, v_half, hz_n,
                                 state.du_avg1, state.dv_avg1,
                                 state.du_avg2, state.dv_avg2,
                                 state.du_avg_bak, state.dv_avg_bak,
                                 grid, cfg, first_step)
        u_half, v_half = halo(h1.u), halo(h1.v)
        flx_u_h, flx_v_h = halo(h1.flx_u), halo(h1.flx_v)

    # ================= CORRECTOR (reference: main.F:425-450) =============
    with span("roms.corrector_3d"):
        om = kinematics.omega(flx_u_h, flx_v_h, zw_n, hz_n, forcing.swflx,
                              grid, cfg.dt, cfg, forcing)
        we, wi = halo(om.we), halo(om.wi)
        eos_h = eos.rho_eos(t_half, zr_n, zw_n, hz_n, grid.rmask, cfg,
                            need_bvf=cfg.lmd_kpp)
        if cfg.lmd_kpp:
            # at n+1/2, from the predictor's boundary layers (main.F:434-436)
            vm = vmix_update(state.replace(hbls=hbls, hbbl=hbbl), u_half,
                             v_half, t_half, eos_h.bvf, zr_n, zw_n, hz_n,
                             forcing, grid, cfg, first_step)
            akv, akt, ghat = halo(vm.akv), halo(vm.akt), vm.ghat
            hbls, hbbl = halo(vm.hbls), halo(vm.hbbl)
        ru_p, rv_p = prsgrd_mod.prsgrd(eos_h.rho, eos_h.rho1, eos_h.qp1,
                                       zr_n, zw_n, hz_n, grid, cfg,
                                       ptide=forcing.ptide)

        # step3d_uv1: corrector r.h.s. + implicit vertical solve
        # (step3d_uv1.F:123-297, IMPLICIT_BOTTOM_DRAG branch)
        if cfg.uv_diagnostics:
            ru, rv, cori_u, cori_v = _uv_rhs(u_half, v_half, flx_u_h, flx_v_h,
                                             hz_n, we, grid, cfg,
                                             cfg.uv_corr_scheme, parts=True)
        else:
            ru, rv = _uv_rhs(u_half, v_half, flx_u_h, flx_v_h, hz_n, we, grid,
                             cfg, cfg.uv_corr_scheme)
        ru = ru_p + ru
        rv = rv_p + rv

        hzu_n = hz_u(hz_n)
        hzv_n = hz_v(hz_n)
        dc0_u_c = cfg.dt * 0.25 * (grid.pm + shift(grid.pm, 0, -1)) * (
            grid.pn + shift(grid.pn, 0, -1))
        dc0_v_c = cfg.dt * 0.25 * (grid.pm + shift(grid.pm, -1, 0)) * (
            grid.pn + shift(grid.pn, -1, 0))
        rd_u = 0.5 * (rd + shift(rd, 0, -1))
        rd_v = 0.5 * (rd + shift(rd, -1, 0))
        vel_u = cuda_solve.momentum_implicit(
            hzu_n * state.u + dc0_u_c[None] * ru, hzu_n,
            0.5 * (akv + shift(akv, 0, -1)),
            0.5 * (wi + shift(wi, 0, -1)), dc0_u_c, cfg.dt, forcing.sustr, cfg,
            bottom_drag_coeff=rd_u)
        vel_v = cuda_solve.momentum_implicit(
            hzv_n * state.v + dc0_v_c[None] * rv, hzv_n,
            0.5 * (akv + shift(akv, -1, 0)),
            0.5 * (wi + shift(wi, -1, 0)), dc0_v_c, cfg.dt, forcing.svstr, cfg,
            bottom_drag_coeff=rd_v)
        hzu_new = vel_u * hzu_n
        hzv_new = vel_v * hzv_n
        uv_budget = None
        if cfg.uv_diagnostics:
            # Hz-weighted per-step terms (reference: diagnostics.F Udiag/Vdiag
            # indices :56-63).  vmix comes straight from the implicit solve:
            # it returns vel from rhs = Hz*u(n) + dc0*ru, so Hz*vel - rhs is
            # the implicit viscosity, implicit-W advection, bottom drag and
            # surface stress together.
            uv_budget = {
                "u": {"pgr": dc0_u_c[None] * ru_p,
                      "cori": dc0_u_c[None] * cori_u,
                      "adv": dc0_u_c[None] * (ru - ru_p - cori_u),
                      "vmix": hzu_new - (hzu_n * state.u
                                         + dc0_u_c[None] * ru)},
                "v": {"pgr": dc0_v_c[None] * rv_p,
                      "cori": dc0_v_c[None] * cori_v,
                      "adv": dc0_v_c[None] * (rv - rv_p - cori_v),
                      "vmix": hzv_new - (hzv_n * state.v
                                         + dc0_v_c[None] * rv)},
            }
        # 3D -> 2D forcing integrals (step3d_uv1.F:194-205, :269-279)
        rufrc = torch.sum(ru, dim=0) + grid.dm_u * grid.dn_u * (
            forcing.sustr - rd_u * vel_u[0])
        rvfrc = torch.sum(rv, dim=0) + grid.dm_v * grid.dn_v * (
            forcing.svstr - rd_v * vel_v[0])

        # visc3d: lateral harmonic viscosity, sponge-enhanced when grid.visc2_*
        # are present (reference: src/visc3d_S.F, src/set_nudgcof.F)
        if cfg.uv_vis2 and (cfg.visc2 != 0.0 or grid.visc2_r is not None):
            du_v, dv_v, dru, drv = hmix.visc3d(state.u, state.v, hz_n, grid,
                                               cfg, visc2_r=grid.visc2_r,
                                               visc2_p=grid.visc2_p)
            hzu_new = hzu_new + cfg.dt * du_v
            hzv_new = hzv_new + cfg.dt * dv_v
            rufrc = rufrc + dru
            rvfrc = rvfrc + drv
            if uv_budget is not None:
                uv_budget["u"]["hmix"] = cfg.dt * du_v
                uv_budget["v"]["hmix"] = cfg.dt * dv_v
        if uv_budget is not None and "hmix" not in uv_budget["u"]:
            uv_budget["u"]["hmix"] = torch.zeros_like(hzu_new)
            uv_budget["v"]["hmix"] = torch.zeros_like(hzv_new)

    # ================= BAROTROPIC SUB-CYCLE (step2d_FB.F) ================
    fast = barotropic.fast_loop(
        state.zeta, state.ubar, state.vbar, rufrc, rvfrc,
        eos_h.rho_s, eos_h.rho_a, forcing,
        state.du_avg1, state.dv_avg1, state.du_avg2, state.dv_avg2,
        w1, w2, grid, cfg, halo)
    zeta_new = fast["zeta"]

    with span("roms.uv2"):
        # new vertical grid from the fast-averaged free surface
        zw_new, zr_new, hz_new = vcoord.set_depth(zeta_new, grid.h, grid.hinv,
                                                  grid.cs_w, grid.cs_r,
                                                  cfg.hc, cfg.nz)
        zw_new, zr_new, hz_new = halo(zw_new), halo(zr_new), halo(hz_new)

        # ================= step3d_uv2 (step3d_uv2.F:82-786) ==================
        hzu_nn = hz_u(hz_new)
        hzv_nn = hz_v(hz_new)
        # part (a): first mismatch correction (step3d_uv2.F:244-268, :374-398)
        cf0_u = torch.sum(hzu_nn, dim=0)
        dcol_u = torch.sum(hzu_new, dim=0)
        mis_u = (dcol_u * grid.dn_u - fast["du_avg1"]) / (cf0_u * grid.dn_u)
        u_new = hzu_new / hzu_nn - mis_u[None]
        cf0_v = torch.sum(hzv_nn, dim=0)
        dcol_v = torch.sum(hzv_new, dim=0)
        mis_v = (dcol_v * grid.dm_v - fast["dv_avg1"]) / (cf0_v * grid.dm_v)
        v_new = hzv_new / hzv_nn - mis_v[None]
        if cfg.masking:
            u_new = u_new * grid.umask[None]
            v_new = v_new * grid.vmask[None]

        u_new = bc.u3dbc(u_new, state.u, u_half, v_half, grid, cfg,
                         forcing.bry, pred_stage=False)
        v_new = bc.v3dbc(v_new, state.v, u_half, v_half, grid, cfg,
                         forcing.bry, pred_stage=False)

        # part (b): vertical integrals, barotropic replacement and the n+1/2
        # flux correction (step3d_uv2.F:521-621)
        dcu = hzu_nn * grid.dn_u[None]
        dcv = hzv_nn * grid.dm_v[None]
        inv_du = 1.0 / torch.sum(dcu, dim=0)
        inv_dv = 1.0 / torch.sum(dcv, dim=0)
        ubar_new = inv_du * fast["du_avg1"]
        vbar_new = inv_dv * fast["dv_avg1"]
        fc_u = inv_du * (torch.sum(dcu * u_new, dim=0) - fast["du_avg1"])
        fc_v = inv_dv * (torch.sum(dcv * v_new, dim=0) - fast["dv_avg1"])
        u_new = u_new - fc_u[None]
        v_new = v_new - fc_v[None]
        if cfg.masking:
            u_new = u_new * grid.umask[None]
            v_new = v_new * grid.vmask[None]
        dlt, eps = cfg.coup_delta, cfg.coup_epsil
        cf_u = dlt * flx_u_h + eps * dcu * (state.u + u_new)
        cf_v = dlt * flx_v_h + eps * dcv * (state.v + v_new)
        mis2_u = inv_du * (torch.sum(cf_u, dim=0) - fast["du_avg2"])
        mis2_v = inv_dv * (torch.sum(cf_v, dim=0) - fast["dv_avg2"])
        flx_u_c = cf_u - dcu * mis2_u[None]
        flx_v_c = cf_v - dcv * mis2_v[None]

        # river overwrite (reference: step3d_uv2.F:689-717)
        if cfg.river_source:
            u_new, v_new = rivers.overwrite_uv(u_new, v_new, forcing, zw_new,
                                               grid)

        # non-hydrostatic pressure projection of the corrected horizontal
        # velocities (reference: the NHMG coupling of step3d_uv2).  As in the
        # JAX package (roms_tpu/stepper.py:435-451), the trial w is zero and
        # nh.w is discarded: w stays diagnostic, so the projection acts as a
        # horizontal-divergence damping (roms_tpu_torch/nhmg.py docstring).
        # On a rank mesh (a HaloExchange) it is one global solve with the
        # step's halo refresh and world sum; the halo faces of u_new and v_new
        # it leaves are refreshed below.
        if cfg.non_hydrostatic:
            w0 = torch.zeros((cfg.nz + 1,) + tuple(u_new.shape[1:]),
                             dtype=u_new.dtype, device=u_new.device)
            nh = nhmg.nh_solve(
                u_new, v_new, w0, hz_new, zr_new, grid.pm, grid.pn, grid, cfg,
                halo=halo if isinstance(halo, HaloExchange) else None)
            u_new, v_new = nh.u, nh.v

        if uv_budget is not None:
            # rate and the 2D/3D coupling + BC correction, against the
            # post-coupling state (reference: diagnostics.F icoup)
            for hz_nn, hz_0, vel0, velf, b in (
                    (hzu_nn, hzu_n, state.u, u_new, uv_budget["u"]),
                    (hzv_nn, hzv_n, state.v, v_new, uv_budget["v"])):
                rate = hz_nn * velf - hz_0 * vel0
                b["rate"] = rate
                b["coup"] = rate - (b["pgr"] + b["cori"] + b["adv"]
                                    + b["hmix"] + b["vmix"])

        u_new, v_new = halo(u_new), halo(v_new)
        flx_u_c, flx_v_c = halo(flx_u_c), halo(flx_v_c)
        ubar_new, vbar_new = halo(ubar_new), halo(vbar_new)

    # ================= TRACER CORRECTOR (main.F:469-473) =================
    with span("roms.tracer_corrector"):
        om = kinematics.omega(flx_u_c, flx_v_c, zw_new, hz_new, forcing.swflx,
                              grid, cfg.dt, cfg, forcing)
        we, wi = halo(om.we), halo(om.wi)

        iso = None
        if cfg.adv_isoneutral:
            # slope and coefficient fields of the rotated biharmonic
            # (reference: prsgrd.F:306-336, step3d_uv2.F:571-683)
            iso = isoneutral.slope_fields(
                eos_h.rho, eos_h.rho1, eos_h.qp1, zr_new, zw_new, hz_new,
                hbls, hbbl, u_new, v_new, grid, cfg)

        mix = tracer_mix(grid, cfg, t_half)
        src_t = src_s = None
        if cfg.lmd_kpp:
            src_t, src_s = _kpp_sources(state, forcing, ghat, wi, cfg)
        pipe = _pipe_load(forcing, pmn, cfg) if cfg.pipe_source else None
        upscale = t_budget = None

        if use_kernel:
            # the stage's base content is hz_n * t_sec_c: the pipe and mCDR
            # loads and the solar + nonlocal KPP terms fold into t_sec_c
            # (additive terms commute; reference: step3d_t_ISO.F:859-902,
            # :927-934, :961-1005).  The point loads are folded here as the
            # reference's batched branch adds them (roms_tpu/stepper.py:
            # 562-574); the JAX package's kernel branch (roms_tpu/stepper.py:
            # 488-534) leaves both out.
            load = pipe
            if forcing.cdr is not None:
                load = apply_cdr_all(torch.zeros_like(state.t) if load is None
                                     else load, forcing.cdr, pmn, cfg.dt,
                                     j0=grid.j0, i0=grid.i0)
            t_sec_c = state.t if load is None else state.t + load / hz_n
            if src_t is not None:
                if load is None:
                    t_sec_c = t_sec_c.clone()
                t_sec_c[cfg.itemp] += src_t / hz_n
                if src_s is not None:
                    t_sec_c[cfg.isalt] += src_s / hz_n
            # t3dmix folded into the corrector kernel
            t_new = cuda_tracer.tracer_stage(
                t_half, t_sec_c, flx_u_c, flx_v_c, hz_n, hz_new, we, wi,
                akt, pmn, grid.rmask, grid.umask, grid.vmask, cfg,
                cfg.ts_corr_scheme, cfg.dt, 0.0, 1.0, True, "corr",
                stflx=forcing.stflx, mix=mix, own=own)
        else:
            # the reference's batched branch (roms_tpu/stepper.py:535-607)
            fx, fe = adv.horiz_tracer_flux(t_half, flx_u_c, flx_v_c, grid, cfg,
                                           cfg.ts_corr_scheme)
            if cfg.river_source:
                fx, fe = rivers.tracer_flux_fix_all(fx, fe, hz_new, zw_new,
                                                    forcing, grid)
            if cfg.upscale_output:
                # outward advective flux at the open-boundary faces, at the
                # full local edge length with the halo (the writer trims)
                # (reference: upscale_output.F:232-313 calc_forcing_rates)
                upscale = {}
                if cfg.obc_west:
                    upscale["west"] = -fx[:, :, :, 2]
                if cfg.obc_east:
                    upscale["east"] = fx[:, :, :, -2 - cfg.pad_e].clone()
                if cfg.obc_south:
                    upscale["south"] = -fe[:, :, 2, :]
                if cfg.obc_north:
                    upscale["north"] = fe[:, :, -2 - cfg.pad_n, :].clone()
            t_base = hz_n * state.t
            term_hadv = -cfg.dt * _tracer_divergence(fx, fe, pmn)
            del fx, fe
            fc = adv.vert_tracer_flux_spline(t_half, hz_new, we)
            term_vadv = -cfg.dt * pmn[None] * (fc[:, 1:] - fc[:, :-1])
            del fc
            t_rhs = t_base + term_hadv + term_vadv
            if not cfg.tracer_diagnostics:
                # only the budget reads them
                del t_base, term_hadv, term_vadv
            if pipe is not None:
                t_rhs = t_rhs + pipe
            if forcing.cdr is not None:
                # mCDR release injection (reference: step3d_t_ISO.F:859-902)
                t_rhs = apply_cdr_all(t_rhs, forcing.cdr, pmn, cfg.dt,
                                      j0=grid.j0, i0=grid.i0)
            # (step3d_t_ISO.F:956-959)
            t_rhs[:, -1] += cfg.dt * forcing.stflx
            if src_t is not None:
                t_rhs[cfg.itemp] += src_t
                if src_s is not None:
                    t_rhs[cfg.isalt] += src_s
            akt_b = vmix.gather_akt(akt, cfg)
            if iso is not None:
                # rotated biharmonic increment of every tracer in one batched
                # pass, and the STABILIZE diffusivity, which depends on the
                # slope fields alone (reference: step3d_t_ISO.F:255-825,
                # implicit part :1050-1064)
                incr, akz = isoneutral.isoneutral_increment(
                    state.t, iso, hz_new, zr_new, grid, cfg, halo)
                t_rhs = t_rhs + incr
                del incr
                if akz is not None:
                    akt_b[:, 1:cfg.nz] += akz
            t_new = vmix.tracer_implicit_all(
                t_rhs, hz_new, akt_b, wi, pmn, cfg.dt, grid.rmask, cfg,
                apply_mask=True)
            if cfg.tracer_diagnostics:
                # term-by-term budget (reference: src/diagnostics.F TXadv/
                # TVadv/TForc explicit); vmix = hz*t_new - t_rhs is the
                # implicit solve's part, t_rhs the content before it
                t_budget = {"hadv": term_hadv, "vadv": term_vadv,
                            "forc": t_rhs - t_base - term_hadv - term_vadv,
                            "vmix": hz_new * t_new - t_rhs,
                            "rate": hz_new * t_new - t_base}
            if mix is not None:
                # t3dmix from t_half (reference: src/t3dmix_S.F)
                t_new = hmix.t3dmix(t_new, t_half, hz_new, grid, cfg,
                                    diff2=mix["diff2"])
    with span("roms.finish"):
        return _finish_tracers(state, forcing, grid, cfg, halo, t_new, u_half,
                               v_half, zeta_new, ubar_new, vbar_new, u_new,
                               v_new, flx_u_c, flx_v_c, we, wi, hz_new, zr_new,
                               zw_new, akv, akt, hbls, hbbl, fast,
                               upscale=upscale, t_budget=t_budget,
                               uv_budget=uv_budget)


def tracer_mix(grid, cfg: ModelConfig, like):
    """The corrector's t3dmix inputs, or None without TS_DIF2: diff2
    (nt, jy, ix) from the sponge-enhanced grid.diff2 where present, else
    cfg.tnu2 everywhere, in the dtype and on the device of `like`."""
    if not (cfg.ts_dif2 and (cfg.tnu2 != 0.0 or grid.diff2 is not None)):
        return None
    diff2 = grid.diff2
    if diff2 is None:
        diff2 = torch.full((cfg.nt,) + tuple(grid.h.shape), cfg.tnu2,
                           dtype=like.dtype, device=like.device)
    return {"diff2": diff2, "pmon_u": grid.pmon_u, "pnom_v": grid.pnom_v}


def _finish_tracers(state, forcing, grid, cfg, halo, t_new, u_half, v_half,
                    zeta_new, ubar_new, vbar_new, u_new, v_new, flx_u_c,
                    flx_v_c, we, wi, hz_new, zr_new, zw_new,
                    akv, akt, hbls, hbbl, fast, upscale=None, t_budget=None,
                    uv_budget=None):
    """Post-corrector tail: tracer BCs -> BGC column physics -> halo
    refresh -> final EOS -> state assembly (reference: main.F:469-490).
    The t3dmix tendency is already in t_new."""
    t_new = bc.t3dbc(t_new, state.t, u_half, v_half, grid, cfg,
                     forcing.bry, pred_stage=False)
    if cfg.bgc_model != "none" and cfg.n_bgc > 0:
        with span("roms.bgc"):
            t0 = time.perf_counter()
            t_new = bgc_update(t_new, state, forcing, grid, cfg, zr_new,
                               zw_new, hz_new)
            bgc_stats["calls"] += 1
            bgc_stats["host_s"].append(time.perf_counter() - t0)
    t_new = halo(t_new)  # (reference: step3d_t_ISO.F:1167-1177)

    # final density for diagnostics/output (reference: main.F:479)
    eos_new = eos.rho_eos(t_new, zr_new, zw_new, hz_new, grid.rmask, cfg)

    return state.replace(
        upscale=upscale, t_budget=t_budget, uv_budget=uv_budget,
        zeta=zeta_new, ubar=ubar_new, vbar=vbar_new,
        u=u_new, v=v_new, u_prev=state.u, v_prev=state.v,
        t=t_new, t_prev=state.t,
        z_w=zw_new, z_r=zr_new, hz=hz_new,
        du_avg1=fast["du_avg1"], dv_avg1=fast["dv_avg1"],
        du_avg2=fast["du_avg2"], dv_avg2=fast["dv_avg2"],
        du_avg_bak=fast["du_avg_bak"], dv_avg_bak=fast["dv_avg_bak"],
        flx_u=flx_u_c, flx_v=flx_v_c, we=we, wi=wi, rho=eos_new.rho,
        akv=akv, akt=akt, hbls=hbls, hbbl=hbbl,
        iic=state.iic + 1, time=state.time + cfg.dt)


def bgc_update(t_new, state, forcing, grid, cfg: ModelConfig, zr_new, zw_new,
               hz_new):
    """The BGC engine's interior tendency and surface flux applied to the
    updated tracers, after their boundary conditions and before the halo
    refresh, where the reference calls MARBL/BEC (reference:
    step3d_t_ISO.F:1158-1175); returns the new tracer array.

    The engine's atmospheric forcing fields ride on `forcing.bgc`
    (reference: bgc_forces.F via set_forces).  The gas-exchange wind
    speed is the bulk `wspd` when the case carries one, else inverted
    from the kinematic stress (reference: bec2_driver.F:186-192 BULK_FRC
    branch vs WS()).  No saved state is carried (`saved=None`)."""
    model = get_model(cfg.bgc_model)
    i0 = cfg.nt - cfg.n_bgc
    ctx = BGCContext(
        temp=t_new[cfg.itemp],
        salt=t_new[cfg.isalt] if cfg.salinity else None,
        z_r=zr_new, z_w=zw_new, hz=hz_new, srflx=forcing.srflx,
        swr_frac=state.swrf, rmask=grid.rmask, dt=cfg.dt, time=state.time)
    forc = dict(forcing.bgc) if forcing.bgc else {}
    if "wspd" not in forc:
        sustr_r = 0.5 * (forcing.sustr + shift(forcing.sustr, 0, 1))
        svstr_r = 0.5 * (forcing.svstr + shift(forcing.svstr, 1, 0))
        forc["wspd"] = bec.wind_speed_from_stress(sustr_r, svstr_r, cfg.rho0)
    trc = t_new[i0:]
    dtr, _ = model.interior_tendency(trc, ctx, None, forc)
    sfl = model.surface_flux(trc, ctx, forc)
    t_bgc = trc + cfg.dt * dtr
    t_bgc[:, -1] += cfg.dt * sfl / hz_new[-1]
    if cfg.masking:
        t_bgc = t_bgc * grid.rmask[None, None]
    return torch.cat([t_new[:i0], t_bgc], dim=0)


def step(state: OceanState, forcing: Forcing, grid: Grid, w1, w2,
         cfg: ModelConfig, first_step: bool) -> OceanState:
    """Single-block step."""
    return step_impl(state, forcing, grid, w1, w2, cfg, first_step,
                     make_halo_fill(cfg))
