"""Inputs of the `production` configuration: the cost profile of the
reference's production physics (the port's
roms_tpu_torch/cases/bench_production.py), its analytic formulas in torch
float64 on the run's device.

`raw_inputs` makes the grid (tanh shelf-to-slope bathymetry, a curving
coastline, CURVGRID metrics, a beta plane), the initial free surface,
T, S and 32 passive tracers, and the wind stress from the seed; `derive`
builds the grid, state and forcing from them with one side's modules
(`inputs.side`), as the case does: set_depth, swr_frac, set_HUV, omega,
rho_eos, open-boundary data from the initial edges, solar and heat flux.
"""

from __future__ import annotations

import math

import torch

from bench_h100 import inputs
from bench_h100.reference import vcoord

F0 = 8.0e-5
BETA = 2.0e-11
DX = 2500.0        # [m]
HMIN, HMAX = 30.0, 4000.0
# the seeded perturbations: T [degC] and the passive tracers, both
# surface-intensified, and the wind stress's phase shift [rad] at most
T_PERTURB = 0.05
TRACER_PERTURB = 0.01
WIND_SHIFT = 0.1 * math.pi


def raw_inputs(model: dict, seed: int, device) -> dict:
    """float64 tensors on `device`: h, pm, pn, f, rmask, xr, yr, zeta,
    sustr (padded 2D) and t (nt, nz, ...)."""
    nx, ny, nz, nt, h = (model["nx"], model["ny"], model["nz"], model["nt"],
                         model["halo"])
    jy, ix = ny + 2 * h, nx + 2 * h
    f64 = dict(dtype=torch.float64, device=device)
    gen = inputs.generator(seed, device)

    y = DX * torch.arange(-1, ny + 3, **f64)[:, None].expand(jy, ix)
    x = DX * torch.arange(-1, nx + 3, **f64)[None, :].expand(jy, ix)
    lx, ly = DX * nx, DX * ny

    # curving coastline on the east; tanh shelf-to-slope bathymetry
    coast = lx - 0.12 * lx * (1.0 + 0.5 * torch.sin(4.0 * math.pi * y / ly))
    d = coast - x                         # distance to coast [m]
    hb = HMIN + 0.5 * (HMAX - HMIN) * (1.0 + torch.tanh((d - 40.0e3)
                                                        / 25.0e3))
    rmask = (d > 0.0).to(torch.float64)
    hb = torch.clamp(hb, min=HMIN)
    # mild curvilinear metric variation (CURVGRID cost)
    pm = (1.0 / DX) * (1.0 + 0.1 * torch.sin(2.0 * math.pi * y / ly))
    pn = (1.0 / DX) * (1.0 + 0.1 * torch.cos(2.0 * math.pi * x / lx))
    f = F0 + BETA * (y - 0.5 * ly)

    # geostrophic surface depression along the shelf break, and the
    # depths of its rho points for the tracer profiles
    zeta = -0.12 * torch.exp(-((d - 60.0e3) / 40.0e3) ** 2) * rmask
    cs_w, cs_r = (torch.as_tensor(c, **f64) for c in vcoord.stretching_curves(
        nz, model["theta_s"], model["theta_b"]))
    _, z, _ = vcoord.set_depth(zeta, hb, 1.0 / (hb + model["hc"]), cs_w,
                               cs_r, model["hc"], nz)

    ph = inputs.phases(gen, len(inputs.MODES) * (nt - 1) + 1, device)
    n_m = len(inputs.MODES)

    def perturbation(i):
        return inputs.smooth_field(x, y, lx, ly, ph[i * n_m:(i + 1) * n_m])

    t = torch.empty((nt, nz, jy, ix), **f64)
    t[0] = (4.0 + 14.0 * torch.exp(z / 250.0) + 0.5 * torch.exp(z / 40.0)
            + T_PERTURB * perturbation(0) * torch.exp(z / 250.0))
    t[1] = 34.8 - 0.6 * torch.exp(z / 120.0)
    for k in range(nt - 2):
        t[k + 2] = (1.0 + 0.5 * torch.sin(2.0 * math.pi * (k + 1) * x / lx)
                    * torch.exp(z / (60.0 + 10.0 * k))
                    + TRACER_PERTURB * perturbation(k + 1)
                    * torch.exp(z / 100.0))

    # analytic wind stress (kinematic units), its phase shifted by the seed
    tau = 0.07 / model["rho0"]
    sustr = tau * torch.sin(math.pi * y / ly + WIND_SHIFT * ph[-1]
                            / (2.0 * math.pi)) ** 2
    return {"h": hb, "pm": pm, "pn": pn, "f": f, "rmask": rmask,
            "xr": x, "yr": y, "zeta": zeta, "t": t, "sustr": sustr}


def derive(lib, cfg, raw: dict, dtype: torch.dtype, device):
    """(grid, state, forcing) of one side from the raw inputs."""
    h = cfg.halo
    jy, ix = cfg.ny + 2 * h, cfg.nx + 2 * h
    grid = lib.grid.build_grid(
        cfg, *(inputs.host(raw[k]) for k in ("h", "pm", "pn", "f", "rmask")),
        xr=inputs.host(raw["xr"]), yr=inputs.host(raw["yr"]), dtype=dtype,
        device=device)
    zeta = raw["zeta"].to(dtype)
    t = raw["t"].to(dtype)
    z_w, z_r, hz = lib.vcoord.set_depth(zeta, grid.h, grid.hinv, grid.cs_w,
                                        grid.cs_r, cfg.hc, cfg.nz)
    st = lib.state.zeros_state(cfg, dtype, device).replace(
        zeta=zeta, t=t, t_prev=t, z_w=z_w, z_r=z_r, hz=hz,
        swrf=lib.kpp.swr_frac(hz, cfg))
    flx_u, flx_v = lib.kinematics.set_huv(st.u, st.v, hz, grid)
    om = lib.kinematics.omega(flx_u, flx_v, z_w, hz, st.zeta * 0.0, grid,
                              0.6 * cfg.dt)
    eos0 = lib.eos.rho_eos(st.t, z_r, z_w, hz, grid.rmask, cfg)
    st = st.replace(flx_u=flx_u, flx_v=flx_v, we=om.we, wi=om.wi,
                    rho=eos0.rho)

    # boundary data = initial edge state (consistent open boundaries)
    bry = lib.state.zero_boundary(cfg, dtype, device).replace(
        zeta_west=zeta[:, h].clone(), zeta_east=zeta[:, -h - 1].clone(),
        zeta_south=zeta[h, :].clone(), zeta_north=zeta[-h - 1, :].clone(),
        t_west=t[:, :, :, h].clone(), t_east=t[:, :, :, -h - 1].clone(),
        t_south=t[:, :, h, :].clone(), t_north=t[:, :, -h - 1, :].clone())
    # solar and surface heat flux (kinematic units) to drive KPP
    srflx = torch.full((jy, ix), 180.0 / (cfg.rho0 * 3985.0), dtype=dtype,
                       device=device)
    stflx = torch.zeros((cfg.nt, jy, ix), dtype=dtype, device=device)
    stflx[0] = -40.0 / (cfg.rho0 * 3985.0)
    forcing = lib.state.zero_forcing(cfg, dtype, device).replace(
        bry=bry, sustr=raw["sustr"].to(dtype), srflx=srflx, stflx=stflx)
    return grid, st, forcing
