"""Slow/fast pressure-flux decomposition for nesting and sponge tuning
(port of roms_tpu/pflx.py; reference: src/calc_pflx_mod.F:14-20,
calc_pressure_flux :81-171).

The baroclinic wave energy flux u'p' comes from the fast (high-frequency)
parts of the hydrostatic pressure and of the baroclinic velocity, where
"slow" is an exponential moving average at the rate alpha = dt/timescale
(reference: calc_pflx_mod.F:49-50): the flux a nested child radiates,
which `sponge_tune` compares with the flux the parent supplies.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from roms_tpu_torch.config import ModelConfig
from roms_tpu_torch.parallel.halo import shift
from roms_tpu_torch.state import _Replace


@dataclass
class PflxState(_Replace):
    p_slow: torch.Tensor   # (nz, jy, ix) filtered hydrostatic pressure
    u_slow: torch.Tensor   # (nz, jy, ix) filtered baroclinic u
    v_slow: torch.Tensor


def init_pflx(cfg: ModelConfig, dtype: torch.dtype = torch.float64,
              device=None) -> PflxState:
    h = cfg.halo
    shape = (cfg.nz, cfg.ny + 2 * h, cfg.nx + 2 * h)
    z3 = torch.zeros(shape, dtype=dtype, device=device)
    return PflxState(p_slow=z3, u_slow=z3, v_slow=z3)


def hydrostatic_pressure(zeta, rho, hz, cfg: ModelConfig):
    """Kinematic hydrostatic pressure p/rho0 at rho points [m^2/s^2]:
    g*zeta + (g/rho0) * the integral of the density anomaly from the
    surface down to the cell centre (reference: the P array prsgrd.F
    builds for its Jacobian and hands to calc_pressure_flux)."""
    g = cfg.g
    w = rho * hz
    above = torch.flip(torch.cumsum(torch.flip(w, (0,)), dim=0), (0,)) \
        - 0.5 * w
    return g * zeta[None] + (g / cfg.rho0) * above


def calc_pflx(pf: PflxState, state, grid, cfg: ModelConfig,
              timescale: float):
    """One filter update; returns (the new PflxState, up, vp), up/vp the
    column-integrated fast pressure fluxes u'p' at u/v points [m^3/s^3]
    (reference: calc_pflx_mod.F:136-168)."""
    alpha = cfg.dt / timescale
    beta = 1.0 - alpha

    p = hydrostatic_pressure(state.zeta, state.rho, state.hz, cfg)
    p_slow = beta * pf.p_slow + alpha * p
    p_fast = p - p_slow

    # barotropic velocities from the column-summed fluxes
    # (reference: :110-132)
    uflx = torch.sum(state.flx_u, dim=0)
    vflx = torch.sum(state.flx_v, dim=0)
    zcol = state.z_w[-1] - state.z_w[0]
    ub = uflx * (grid.pn + shift(grid.pn, 0, -1)) / (zcol
                                                      + shift(zcol, 0, -1))
    vb = vflx * (grid.pm + shift(grid.pm, -1, 0)) / (zcol
                                                      + shift(zcol, -1, 0))

    du = state.u - ub[None]
    dv = state.v - vb[None]
    u_slow = beta * pf.u_slow + alpha * du
    v_slow = beta * pf.v_slow + alpha * dv
    u_fast = du - u_slow
    v_fast = dv - v_slow

    hz = state.hz
    up = torch.sum(u_fast * 0.25 * (p_fast + shift(p_fast, 0, -1))
                   * (hz + shift(hz, 0, -1)), dim=0)
    vp = torch.sum(v_fast * 0.25 * (p_fast + shift(p_fast, -1, 0))
                   * (hz + shift(hz, -1, 0)), dim=0)
    return (PflxState(p_slow=p_slow, u_slow=u_slow, v_slow=v_slow),
            up, vp)
