"""Lagrangian particles in continuous index space (port of
roms_tpu/particles.py; reference: src/particles.F).

Positions live in the reference's fractional-index convention: px in
[-0.5, nx+0.5] over rho cells, pz in [0, nz] over levels.  Velocities are
trilinearly interpolated (reference: particles.F:504-560 rhs_particles,
interp_2D/interp_3D) and positions advance with AB2 (reference:
particles.F:213-267 advance_particles).

The per-particle loop is a set of gathers over a fixed-size particle
array: inactive slots (`active` False) let the population grow and
shrink without reallocating.  Every base index is clipped into the
padded field before it gathers, so the +1 neighbours, particles outside
the domain and NaN positions stay in bounds (a gather out of bounds
raises on the CPU and fires a device assert on the card).  The AB2
startup flag and the clamp counters stay device tensors, so a step reads
nothing back to the host.  Out-of-domain particles wrap on periodic axes
and deactivate on open or closed edges.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from roms_tpu_torch.config import ModelConfig
from roms_tpu_torch.io.netcdf import NCWriter
from roms_tpu_torch.io.output import host, provenance_attrs
from roms_tpu_torch.state import _Replace


@dataclass
class ParticleState(_Replace):
    px: torch.Tensor      # (npart,) fractional xi index
    py: torch.Tensor
    pz: torch.Tensor      # fractional level, [0, nz]
    dpxm: torch.Tensor    # previous AB2 rates
    dpym: torch.Tensor
    dpzm: torch.Tensor
    active: torch.Tensor  # (npart,) bool
    first: torch.Tensor   # 0-d bool: AB2 startup flag
    n_bot: torch.Tensor   # 0-d int32 bottom-clamp counter
    n_sur: torch.Tensor   # (reference: particles.F:253-256)


def seed_particles(px, py, pz, npart_max: int | None = None,
                   dtype: torch.dtype = torch.float64,
                   device=None) -> ParticleState:
    """A ParticleState from position arrays; extra capacity up to
    npart_max is allocated inactive."""
    px = torch.as_tensor(px, dtype=dtype, device=device)
    n = px.shape[0]
    cap = npart_max or n
    pad = cap - n

    def fit(a):
        return torch.cat([torch.as_tensor(a, dtype=dtype, device=device),
                          torch.zeros(pad, dtype=dtype, device=device)])

    z = torch.zeros(cap, dtype=dtype, device=device)
    active = torch.zeros(cap, dtype=torch.bool, device=device)
    active[:n] = True
    return ParticleState(
        px=fit(px), py=fit(py), pz=fit(pz), dpxm=z, dpym=z, dpzm=z,
        active=active,
        first=torch.ones((), dtype=torch.bool, device=device),
        n_bot=torch.zeros((), dtype=torch.int32, device=device),
        n_sur=torch.zeros((), dtype=torch.int32, device=device))


def _interp2(f, jj, ii, y, x):
    """Bilinear gather: f (jy, ix) at padded base indices (jj, ii)."""
    f00 = f[jj, ii]
    f01 = f[jj, ii + 1]
    f10 = f[jj + 1, ii]
    f11 = f[jj + 1, ii + 1]
    return ((1 - y) * ((1 - x) * f00 + x * f01)
            + y * ((1 - x) * f10 + x * f11))


def _interp3(f, kk, jj, ii, z, y, x):
    """Trilinear gather: f (nz.., jy, ix) at base indices (kk, jj, ii)."""
    f0 = (1 - x) * ((1 - y) * f[kk, jj, ii] + y * f[kk, jj + 1, ii]) \
        + x * ((1 - y) * f[kk, jj, ii + 1] + y * f[kk, jj + 1, ii + 1])
    k1 = kk + 1
    f1 = (1 - x) * ((1 - y) * f[k1, jj, ii] + y * f[k1, jj + 1, ii]) \
        + x * ((1 - y) * f[k1, jj, ii + 1] + y * f[k1, jj + 1, ii + 1])
    return (1 - z) * f0 + z * f1


def _floor_index(a):
    """floor(a) as int64 (a NaN gives an arbitrary integer, which the
    callers clip)."""
    return torch.floor(a).long()


def rhs_particles(ps: ParticleState, u, v, we, wi, hz, grid,
                  cfg: ModelConfig):
    """Index-space displacement rates (reference: particles.F:475-573)."""
    nz = cfg.nz
    # Fortran base indices (reference: particles.F:507-521)
    i = _floor_index(ps.px + 0.5)
    j = _floor_index(ps.py + 0.5)
    k = torch.clamp(_floor_index(ps.pz + 0.5), 1, nz - 1)
    iu = _floor_index(ps.px + 1.0)
    jv = _floor_index(ps.py + 1.0)
    kw = torch.clamp(_floor_index(ps.pz), 0, nz - 1)
    x = ps.px - i + 0.5
    y = ps.py - j + 0.5
    z = ps.pz - k + 0.5
    xu = ps.px - iu + 1.0
    yv = ps.py - jv + 1.0
    zw = ps.pz - kw

    # padded layout (Fortran index -> python index + 1), clipped to keep
    # the gathers in bounds for stray particles
    jy, ix = grid.pm.shape
    ip = torch.clamp(i + 1, 0, ix - 2)
    jp = torch.clamp(j + 1, 0, jy - 2)
    iup = torch.clamp(iu + 1, 0, ix - 2)
    jvp = torch.clamp(jv + 1, 0, jy - 2)
    kr = k - 1          # rho-level python index of Fortran level k

    pu = _interp3(u, kr, jp, iup, z, y, xu)
    pv = _interp3(v, kr, jvp, ip, z, yv, x)
    wp = (we + wi) * (grid.pm * grid.pn)[None]  # (reference: :499-501)
    pw = _interp3(wp, kw, jp, ip, zw, y, x)

    pdxi = _interp2(grid.pm, jp, ip, y, x)
    pdyi = _interp2(grid.pn, jp, ip, y, x)
    pdz = _interp3(hz, kr, jp, ip, z, y, x)

    dt = cfg.dt
    prx = dt * pu * pdxi
    pry = dt * pv * pdyi
    prz = dt * pw / pdz
    live = ps.active & (ps.pz < 2 * nz)
    return (torch.where(live, prx, 0.0), torch.where(live, pry, 0.0),
            torch.where(live, prz, 0.0))


def advance_particles(ps: ParticleState, u, v, we, wi, hz, grid,
                      cfg: ModelConfig) -> ParticleState:
    """One AB2 particle step (reference: particles.F:213-267)."""
    prx, pry, prz = rhs_particles(ps, u, v, we, wi, hz, grid, cfg)
    return _ab2_update(ps, prx, pry, prz, cfg)


def _ab2_update(ps: ParticleState, prx, pry, prz,
                cfg: ModelConfig) -> ParticleState:
    dpxm = torch.where(ps.first, prx, ps.dpxm)
    dpym = torch.where(ps.first, pry, ps.dpym)
    dpzm = torch.where(ps.first, prz, ps.dpzm)

    px = ps.px + 1.5 * prx - 0.5 * dpxm
    py = ps.py + 1.5 * pry - 0.5 * dpym
    pz = ps.pz + 1.5 * prz - 0.5 * dpzm

    # vertical clamping (reference: particles.F:252-261)
    hit_bot = pz < 0.0
    hit_sur = pz > cfg.nz
    pz = torch.where(hit_bot, 0.02, pz)
    pz = torch.where(hit_sur, cfg.nz - 0.02, pz)

    # horizontal wrap (periodic) or deactivate (outflow)
    active = ps.active
    if cfg.ew_periodic:
        px = torch.remainder(px + 0.5, float(cfg.nx)) - 0.5
    else:
        active = active & (px > -0.5) & (px < cfg.nx + 0.5)
    if cfg.ns_periodic:
        py = torch.remainder(py + 0.5, float(cfg.ny)) - 0.5
    else:
        active = active & (py > -0.5) & (py < cfg.ny + 0.5)

    return ps.replace(
        px=px, py=py, pz=pz, dpxm=prx, dpym=pry, dpzm=prz,
        active=active, first=torch.zeros_like(ps.first),
        n_bot=ps.n_bot + torch.sum(hit_bot & ps.active, dtype=torch.int32),
        n_sur=ps.n_sur + torch.sum(hit_sur & ps.active, dtype=torch.int32))


class ParticleWriter:
    """Trajectory output (reference: particles.F:389-473 wrt_particles +
    Tools-Roms particle_join: one global file, nothing to join)."""

    def __init__(self, path: str, npart: int, cfg: ModelConfig):
        self.nc = NCWriter(path, provenance_attrs(cfg))
        self.nc.create_dim("time", None)
        self.nc.create_dim("particle", npart)
        self.nc.create_var("ptime", ("time",), "f8")
        for v in ("px", "py", "pz"):
            self.nc.create_var(v, ("time", "particle"), "f8")
        self.nc.create_var("active", ("time", "particle"), "i4")
        self.rec = 0

    def write(self, ps: ParticleState, time: float):
        self.nc.write("ptime", float(time), rec=self.rec)
        for v in ("px", "py", "pz"):
            self.nc.write(v, host(getattr(ps, v)), rec=self.rec)
        self.nc.write("active", host(ps.active).astype("i4"), rec=self.rec)
        self.rec += 1
        self.nc.sync()

    def close(self):
        self.nc.close()


def make_distributed_particle_step(cfg: ModelConfig, mesh):
    """This rank's particle step over block-halo-layout fields
    (`parallel.dist`): fn(ps, u, v, we, wi, hz, grid) -> ParticleState,
    in place of the reference's particle migration between ranks
    (particles.F:661-840, :935-1010).

    The particle array is replicated on every rank.  Each rank computes
    the rates of the particles whose base cell lies in its interior (a
    gather over its halo'd fields, the same values as the global
    gather), the others contribute zeros, and a sum over the ranks gives
    every rank every rate, exactly (one nonzero term each).  No particle
    moves between ranks: ownership follows the position every step.
    `cfg` is the unpadded config."""
    from roms_tpu_torch.parallel.dist import pad_for_mesh

    cfg_p = pad_for_mesh(cfg, mesh)
    py, px = mesh.shape
    my, mx = cfg_p.ny // py, cfg_p.nx // px
    j0, i0 = mesh.iy * my, mesh.ix * mx

    def dstep(ps: ParticleState, u, v, we, wi, hz, grid) -> ParticleState:
        c_i = torch.clamp(_floor_index(ps.px + 0.5), 1, cfg.nx) - 1
        c_j = torch.clamp(_floor_index(ps.py + 0.5), 1, cfg.ny) - 1
        own = ((c_i >= i0) & (c_i < i0 + mx) & (c_j >= j0)
               & (c_j < j0 + my) & ps.active)
        local = ps.replace(px=ps.px - i0, py=ps.py - j0)
        rates = torch.stack(rhs_particles(local, u, v, we, wi, hz, grid,
                                          cfg))
        rates = mesh.all_reduce(torch.where(own, rates, 0.0))
        return _ab2_update(ps, rates[0], rates[1], rates[2], cfg)

    return dstep
