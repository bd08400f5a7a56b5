"""Inputs of the `filament` configuration: the reference's submesoscale
cold-filament test (tests/Filament/ana_grid.h, ana_init.h; the port's
roms_tpu_torch/cases/filament.py), its analytic formulas in torch float64
on the run's device.

`raw_inputs` makes the grid and the initial temperature, free surface and
geostrophic velocity from the seed; `derive` builds the grid, state and
forcing from them with one side's modules (`inputs.side`), following the
case's set-up (reference: main.F:86-321): halo fill, set_depth with the
analytic free surface, the initial fast-averaged fluxes, set_HUV, omega,
rho_eos.
"""

from __future__ import annotations

import torch

from bench_h100 import inputs
from bench_h100.reference import vcoord

# physical parameters (reference: tests/Filament/ana_grid.h, ana_init.h)
SIZE_X = 12.8e3
SIZE_Y = 3.2e3
F0 = 2 * 7.81e-5
HD = 1000.0
B0 = 5.0e-2
B_CFF = 0.025
LAMBDA_INV = 8.0
NB = 1.0e-7
N0 = 3.0e-5
H0 = 60.0
DH0 = 15.0
L_FIL = 2000.0
# the seeded temperature perturbation [degC], about half a percent of the
# surface temperature's 0.22 degC range across the filament, decaying
# below the boundary layer over H0
T_PERTURB = 1.0e-3


def raw_inputs(model: dict, seed: int, device) -> dict:
    """float64 tensors on `device`: h, pm, pn, f, rmask, xr, yr (padded
    2D), zeta, vbar (2D), v (nz, ...) and t (1, nz, ...)."""
    nx, ny, nz, h = model["nx"], model["ny"], model["nz"], model["halo"]
    jy, ix = ny + 2 * h, nx + 2 * h
    f64 = dict(dtype=torch.float64, device=device)
    gen = inputs.generator(seed, device)

    # analytic grid; Fortran index i = -1..nx+2 <-> padded index i+1
    dx, dy = SIZE_X / nx, SIZE_Y / ny
    xr = (dx * (torch.arange(-1, nx + 3, **f64) - 0.5)
          - SIZE_X / 2.0)[None, :].expand(jy, ix).contiguous()
    yr = (dy * (torch.arange(-1, ny + 3, **f64) - 0.5))[:, None].expand(
        jy, ix).contiguous()

    def full(v):
        return torch.full((jy, ix), v, **f64)

    hb = full(HD)

    # rest-state vertical grid (zeta = 0)
    cs_w, cs_r = (torch.as_tensor(c, **f64) for c in vcoord.stretching_curves(
        nz, model["theta_s"], model["theta_b"]))
    hc = model["hc"]
    ds = 1.0 / nz
    k_w = torch.arange(0, nz + 1, **f64)[:, None, None]
    k_r = torch.arange(1, nz + 1, **f64)[:, None, None]
    hinv0 = 1.0 / (hb + hc)
    z_w0 = hb * (hc * ds * (k_w - nz) + cs_w[:, None, None] * hb) * hinv0
    z_w0[0] = -hb
    z_r0 = hb * (hc * ds * (k_r - nz - 0.5) + cs_r[:, None, None] * hb) * hinv0
    hz0 = z_w0[1:] - z_w0[:-1]

    g = model["g"]
    alpha = model["tcoef"] / model["rho0"]
    h_sbl = H0 + DH0 * torch.exp(-((xr / L_FIL) ** 2))

    def logcosh(x):
        ax = x.abs()
        return ax + torch.log1p(torch.exp(-2.0 * ax)) - torch.log(
            torch.tensor(2.0, **f64))

    def buoyancy(z, hs):
        return (B0 + NB * (z + HD)
                + 0.5 * N0 * ((1 + B_CFF) * z - (1 - B_CFF)
                              * (hs + LAMBDA_INV
                                 * logcosh((1.0 / LAMBDA_INV) * (z + hs)))))

    t = buoyancy(z_r0, h_sbl) / (g * alpha)
    t = t + T_PERTURB * inputs.smooth_field(
        xr, yr, SIZE_X, SIZE_Y, inputs.phases(gen, len(inputs.MODES), device)
    ) * torch.exp(z_r0 / H0)

    # bf_int at one interior column of the unperturbed far field
    col = (slice(None), h, h)
    bf_int = torch.sum(hz0[col] * buoyancy(z_r0[col], H0)) / g
    zeta = torch.sum(t * alpha * hz0, dim=0) - bf_int

    # geostrophic v: surface from dzeta/dx, thermal wind downward (the
    # wrapped rolls land only in the ghost ring that the halo fill
    # refreshes)
    def ddx(a):
        return torch.roll(a, -1, dims=-1) - torch.roll(a, 1, dims=-1)

    v = torch.zeros_like(t)
    v[nz - 1] = g * 0.5 * (1.0 / dx) * ddx(zeta) / F0
    for k in range(nz - 2, -1, -1):
        dbdx = 0.25 * (1.0 / dx) * g * alpha * (ddx(t[k]) + ddx(t[k + 1]))
        v[k] = v[k + 1] - dbdx * (z_r0[k + 1] - z_r0[k]) / F0
    # vbar leaves out the top level, as the reference does
    vbar = torch.sum(v[:nz - 1] * hz0[:nz - 1], dim=0) / HD

    return {"h": hb, "pm": full(1.0 / dx), "pn": full(1.0 / dy),
            "f": full(F0), "rmask": full(1.0), "xr": xr, "yr": yr,
            "zeta": zeta, "vbar": vbar, "v": v, "t": t[None]}


def derive(lib, cfg, raw: dict, dtype: torch.dtype, device):
    """(grid, state, forcing) of one side from the raw inputs."""
    grid = lib.grid.build_grid(
        cfg, *(inputs.host(raw[k]) for k in ("h", "pm", "pn", "f", "rmask")),
        xr=inputs.host(raw["xr"]), yr=inputs.host(raw["yr"]), dtype=dtype,
        device=device)
    fill = lib.halo.make_halo_fill(cfg)
    shift = lib.halo.shift
    zeta = fill(raw["zeta"].to(dtype))
    t = fill(raw["t"].to(dtype))
    v = fill(raw["v"].to(dtype))
    vbar = fill(raw["vbar"].to(dtype))

    z_w, z_r, hz = lib.vcoord.set_depth(zeta, grid.h, grid.hinv, grid.cs_w,
                                        grid.cs_r, cfg.hc, cfg.nz)
    z_w, z_r, hz = fill(z_w), fill(z_r), fill(hz)
    # initial fast-averaged fluxes (reference: set_depth.F:42-63, iic==0)
    dv_avg1 = fill(0.5 * (grid.h + shift(grid.h, -1, 0) + zeta
                          + shift(zeta, -1, 0)) * grid.dm_v * vbar)
    st = lib.state.zeros_state(cfg, dtype, device).replace(
        zeta=zeta, vbar=vbar, v=v, v_prev=v, t=t, t_prev=t, z_w=z_w,
        z_r=z_r, hz=hz, du_avg1=torch.zeros_like(zeta), dv_avg1=dv_avg1)

    flx_u, flx_v = lib.kinematics.set_huv(st.u, st.v, hz, grid)
    flx_u, flx_v = fill(flx_u), fill(flx_v)
    om = lib.kinematics.omega(flx_u, flx_v, z_w, hz, st.zeta * 0.0, grid,
                              0.6 * cfg.dt)
    eos0 = lib.eos.rho_eos(st.t, z_r, z_w, hz, grid.rmask, cfg)
    st = st.replace(flx_u=flx_u, flx_v=flx_v, we=fill(om.we),
                    wi=fill(om.wi), rho=eos0.rho)
    return grid, st, lib.state.zero_forcing(cfg, dtype, device)
