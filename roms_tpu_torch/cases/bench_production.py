"""Production-physics configuration (port of
roms_tpu/cases/bench_production.py; no file inputs).

A production step of the reference pays for the nonlinear split EOS,
KPP, salinity, a ~30-tracer passive load, land masking and open
boundaries (reference: the default production config is 920x480x60 with
full physics, src/param.opt:18-21; the USWC test cases run MARBL's 32
tracers, tests/CDR_parameterized/param.opt).  This analytic case has
that cost profile:

  * shelf-to-deep tanh bathymetry with a curving coastline mask
    (~15% land), CURVGRID metrics;
  * stratified T/S;
  * 32 passive tracers (smooth initial fields);
  * KPP surface boundary layer driven by analytic wind stress + solar;
  * 4-side open boundaries (Flather / Orlanski / Orlanski) with external
    data = the initial edge state;
  * lateral viscosity visc2 and diffusivity tnu2.

The analytic fields are numpy float64, as in the JAX package, so both
packages start from the same inputs.
"""

from __future__ import annotations

import numpy as np
import torch

from roms_tpu_torch import vcoord
from roms_tpu_torch.cases import resolve_device
from roms_tpu_torch.config import ModelConfig
from roms_tpu_torch.grid import build_grid
from roms_tpu_torch.ops import kinematics, kpp
from roms_tpu_torch.ops.eos import rho_eos
from roms_tpu_torch.state import zero_boundary, zero_forcing, zeros_state

F0 = 8.0e-5
BETA = 2.0e-11
DX = 2500.0        # [m]
HMIN, HMAX = 30.0, 4000.0

# Agreement of two float64 runs of this case over three steps (the port
# against the JAX step in tests/test_torch_production.py, the card against
# the CPU in chip_smoke.py): atol = STEP_TOL * max(1, max|ref|) per state
# field, or CONDITIONED_TOL[name] * max(1, max|ref|) for the fields that
# are small differences of nearly equal terms: the Richardson number
# behind akv/akt divides by the square of a vertical shear, and `we`
# integrates the divergence of nearly cancelling fluxes.  The reference
# itself moves them by more than STEP_TOL, and by less than
# CONDITIONED_TOL, under a 1e-15 relative perturbation of its tracers
# (tests/test_torch_production.py::test_reference_conditioning).
STEP_TOL = 5e-11
CONDITIONED_TOL = {"we": 1e-8, "akv": 1e-8, "akt": 1e-8}
# The step's option sets of chip_smoke.py's phase 14: the non-hydrostatic
# projection with the momentum budget, and isoneutral mixing with the
# tracer budget and the upscale capture.  Under each, more arrays carry
# that conditioning.  Each set holds at 1e-8, by name (dotted for the
# outputs' terms), only arrays that a 1e-15 relative perturbation of the
# tracers moves by more than STEP_TOL, with one of the noise seeds 0-3 at
# least, both in the JAX package's own step for that set
# (tests/jax_option_conditioning.py) and in the port's
# (tests/test_torch_production.py::test_option_conditioning).
OPTIONS = {"nh": dict(non_hydrostatic=True, uv_diagnostics=True),
           "iso": dict(adv_isoneutral=True, sw_triads=True, stabilize=True,
                       tracer_diagnostics=True, upscale_output=True)}
OPTION_CONDITIONED_TOL = {
    "nh": {**CONDITIONED_TOL, "flx_u": 1e-8, "flx_v": 1e-8,
           "uv_budget.u.vmix": 1e-8, "uv_budget.u.rate": 1e-8,
           "uv_budget.v.rate": 1e-8},
    "iso": {**CONDITIONED_TOL, "flx_u": 1e-8, "flx_v": 1e-8,
            "t_budget.hadv": 1e-8, "t_budget.vadv": 1e-8,
            "upscale.west": 1e-8, "upscale.south": 1e-8}}


def config(nx: int = 512, ny: int = 256, nz: int = 60,
           nt: int = 34) -> ModelConfig:
    """The same ModelConfig as roms_tpu.cases.bench_production.config."""
    return ModelConfig(
        nx=nx, ny=ny, nz=nz, nt=nt,
        dt=240.0, ndtfast=40, ntimes=10,
        theta_s=6.0, theta_b=6.0, hc=250.0,
        nonlin_eos=True, salinity=True, lmd_kpp=True,
        curvgrid=True, masking=True,
        ew_periodic=False, ns_periodic=False,
        obc_west=True, obc_east=True, obc_south=True, obc_north=True,
        obc_m2="flather", obc_m3="orlanski", obc_t="orlanski",
        frc_bry=True, ubind=0.1,
        uv_adv=True, uv_cor=True,
        visc2=5.0, tnu2=1.0, rdrg=3.0e-4)


def setup(cfg: ModelConfig, dtype: torch.dtype = torch.float32,
          device: torch.device | str = "cuda"):
    """Build (grid, state, forcing) on the card unless `device` says
    otherwise; raises where there is no CUDA device."""
    device = resolve_device(device)
    h = cfg.halo
    jy, ix = cfg.ny + 2 * h, cfg.nx + 2 * h
    npdt = np.float64

    iy = np.arange(-1, cfg.ny + 3, dtype=npdt)[:, None]
    jx = np.arange(-1, cfg.nx + 3, dtype=npdt)[None, :]
    x = DX * jx
    y = DX * iy
    lx = DX * cfg.nx

    # curving coastline on the east; tanh shelf-to-slope bathymetry
    coast = lx - 0.12 * lx * (1.0 + 0.5 * np.sin(4.0 * np.pi * y / (DX * cfg.ny)))
    d = coast - x                         # distance to coast [m]
    hb = HMIN + 0.5 * (HMAX - HMIN) * (1.0 + np.tanh((d - 40.0e3) / 25.0e3))
    rmask = (d > 0.0).astype(npdt)
    hb = np.maximum(hb, HMIN)

    # mild curvilinear metric variation (CURVGRID cost)
    pm = (1.0 / DX) * (1.0 + 0.1 * np.sin(2.0 * np.pi * y / (DX * cfg.ny)))
    pn = (1.0 / DX) * (1.0 + 0.1 * np.cos(2.0 * np.pi * x / lx))
    f = F0 + BETA * (y - 0.5 * DX * cfg.ny)

    def full(a):
        return np.broadcast_to(a, (jy, ix)).copy()

    grid = build_grid(cfg, hb, full(pm), full(pn), full(f), rmask,
                      xr=full(x), yr=full(y), dtype=dtype, device=device)

    def dev(a):
        return torch.as_tensor(a, dtype=dtype, device=device)

    st = zeros_state(cfg, dtype, device)

    # geostrophic surface depression along the shelf break
    zeta = dev(-0.12 * np.exp(-((d - 60.0e3) / 40.0e3) ** 2) * rmask)
    z_w, z_r, hz = vcoord.set_depth(zeta, grid.h, grid.hinv,
                                    grid.cs_w, grid.cs_r, cfg.hc, cfg.nz)
    z_rn = z_r.cpu().numpy().astype(npdt)

    # stratified T/S + 32 smooth passive tracers
    temp = 4.0 + 14.0 * np.exp(z_rn / 250.0) + 0.5 * np.exp(z_rn / 40.0)
    salt = 34.8 - 0.6 * np.exp(z_rn / 120.0)
    tr = [temp, salt]
    for k in range(cfg.nt - 2):
        tr.append(1.0 + 0.5 * np.sin(2.0 * np.pi * (k + 1) * x / lx)
                  * np.exp(z_rn / (60.0 + 10.0 * k)))
    t = dev(np.stack(tr))

    st = st.replace(zeta=zeta, t=t, t_prev=t, z_w=z_w, z_r=z_r, hz=hz,
                    swrf=kpp.swr_frac(hz, cfg))
    flx_u, flx_v = kinematics.set_huv(st.u, st.v, hz, grid)
    om = kinematics.omega(flx_u, flx_v, z_w, hz, st.zeta * 0.0, grid,
                          0.6 * cfg.dt)
    eos0 = rho_eos(st.t, z_r, z_w, hz, grid.rmask, cfg)
    st = st.replace(flx_u=flx_u, flx_v=flx_v, we=om.we, wi=om.wi,
                    rho=eos0.rho)

    # boundary data = initial edge state (consistent OBC)
    bry = zero_boundary(cfg, dtype, device).replace(
        zeta_west=zeta[:, h].clone(), zeta_east=zeta[:, -h - 1].clone(),
        zeta_south=zeta[h, :].clone(), zeta_north=zeta[-h - 1, :].clone(),
        t_west=t[:, :, :, h].clone(), t_east=t[:, :, :, -h - 1].clone(),
        t_south=t[:, :, h, :].clone(), t_north=t[:, :, -h - 1, :].clone())

    # analytic wind stress + solar (kinematic units) to drive KPP
    tau = 0.07 / cfg.rho0
    sustr = dev(full(tau * np.sin(np.pi * y / (DX * cfg.ny)) ** 2))
    srflx = torch.full((jy, ix), 180.0 / (cfg.rho0 * 3985.0), dtype=dtype,
                       device=device)
    stflx = torch.zeros((cfg.nt, jy, ix), dtype=dtype, device=device)
    stflx[0] = -40.0 / (cfg.rho0 * 3985.0)
    forcing = zero_forcing(cfg, dtype, device).replace(
        bry=bry, sustr=sustr, srflx=srflx, stflx=stflx)
    return grid, st, forcing
