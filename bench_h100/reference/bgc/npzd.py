"""Reduced NPZD ecosystem (port of roms_tpu/bgc/npzd.py): the small
built-in engine that exercises the coupling surface (the structural
stand-in for the reference's BEC2, src/bec2_driver.F ecosys_bec2_tile:
light- and nutrient-limited growth, grazing, mortality,
remineralization, sinking detritus, at 4 tracers).

Tracers: NO3 (mmol N/m3), PHYT, ZOO, DET.  Every source/sink term is
local except detritus sinking (an upwind column flux).
"""

from __future__ import annotations

import torch

from bench_h100.reference.bgc.api import BGCContext, BGCModel, register

# parameters (typical NPZD ranges, Fasham/Franks lineage)
VMAX = 1.0 / 86400.0      # max phyto growth [1/s]
K_NO3 = 0.5               # nutrient half-saturation [mmol/m3]
ALPHA_LIGHT = 0.025       # initial slope of the P-I curve
PAR_FRAC = 0.43           # photosynthetically available fraction
RHO0_CP = 1000.0 * 3985.0  # kinematic heat flux back to W/m2
GMAX = 0.6 / 86400.0      # max grazing [1/s]
K_P = 1.0                 # grazing half-saturation
BETA_Z = 0.75             # assimilation efficiency
M_P = 0.05 / 86400.0      # phyto mortality [1/s]
M_Z = 0.1 / 86400.0       # zoo quadratic mortality [1/(mmol/m3 s)]
REMIN = 0.1 / 86400.0     # detritus remineralization [1/s]
W_DET = 5.0 / 86400.0     # detritus sinking speed [m/s]
EPS = 1e-12


def _light(ctx: BGCContext):
    """PAR at rho levels from the penetrative solar profile [W/m2]."""
    sw_wm2 = ctx.srflx[None] * RHO0_CP
    frac_r = 0.5 * (ctx.swr_frac[1:] + ctx.swr_frac[:-1])
    return PAR_FRAC * torch.clamp(sw_wm2, min=0.0) * frac_r


def interior_tendency(trc, ctx: BGCContext, saved, forc=None):
    no3, phy, zoo, det = (torch.clamp(trc[i], min=0.0) for i in range(4))

    par = _light(ctx)
    # light limitation (tanh P-I curve) x nutrient limitation
    lim_i = torch.tanh(ALPHA_LIGHT * par)
    lim_n = no3 / (K_NO3 + no3)
    growth = VMAX * lim_i * lim_n * phy
    graze = GMAX * phy * phy / (K_P * K_P + phy * phy) * zoo
    mort_p = M_P * phy
    mort_z = M_Z * zoo * zoo
    remin = REMIN * det

    d_no3 = -growth + remin
    d_phy = growth - graze - mort_p
    d_zoo = BETA_Z * graze - mort_z
    d_det = (1.0 - BETA_Z) * graze + mort_p + mort_z - remin

    # detritus sinking: upwind (downward) flux divergence over the column;
    # nothing leaves through the bottom cell (k=0), nothing enters at the
    # surface
    f_out = W_DET * det
    f_out[0] = 0.0
    f_in = torch.cat([f_out[1:], torch.zeros_like(f_out[:1])], dim=0)
    d_det = d_det + (f_in - f_out) / torch.clamp(ctx.hz, min=EPS)

    d = torch.stack([d_no3, d_phy, d_zoo, d_det], dim=0)
    return d * ctx.rmask[None, None], saved


def surface_flux(trc, ctx: BGCContext, forc=None):
    # no air-sea exchange for N-based tracers
    return torch.zeros((4,) + tuple(ctx.srflx.shape), dtype=trc.dtype,
                       device=trc.device)


def init_tracers(cfg, z_r, dtype=torch.float64, device=None):
    """Idealized initial profiles: nutrient-rich at depth, small seed
    populations near the surface."""
    z = torch.as_tensor(z_r, dtype=dtype, device=device)
    no3 = 16.0 * (1.0 - torch.exp(z / 300.0)) + 0.5
    surf = torch.exp(z / 50.0)
    return torch.stack([no3, 0.2 * surf, 0.1 * surf, 0.05 * surf], dim=0)


@register("npzd")
def build() -> BGCModel:
    return BGCModel(name="npzd",
                    tracer_names=("NO3", "PHYT", "ZOO", "DET"),
                    interior_tendency=interior_tendency,
                    surface_flux=surface_flux,
                    init_tracers=init_tracers)
