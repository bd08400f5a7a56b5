"""The port's Lagrangian particles on the CPU, in float64:

(a) `rhs_particles` and 5 `advance_particles` steps against
    roms_tpu.particles on smooth velocity fields of seeded random phases
    (the first step agrees to 4e-15, the JAX package's own distance
    between its jitted and eager step; rough fields would amplify that
    by the step's Lipschitz factor every step), on the doubly
    periodic Filament grid and on the walled basin, at rtol = atol = 1e-12
    (NaN where the JAX package gives NaN); the particles include ones
    seeded outside the domain, at pz below 0 and beyond nz and 2*nz, a
    NaN position and inactive capacity slots, so every clipped gather and
    the clamp counters are exercised;
(b) tests/test_particles.py's checks on the port: uniform flow advects at
    u*dt/dx index units a step, periodic wrap, the bottom clamp counter,
    inactive slots stay put;
(c) the `ParticleWriter` file read back equal, variable by variable, to
    the JAX package's writer's file for the same particles.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from roms_tpu import particles as jparticles
from roms_tpu.cases import filament as jfilament
from roms_tpu.cases import obc_basin as jbasin

from roms_tpu_torch import bridge, particles
from roms_tpu_torch.cases import filament as tfilament

from torch_helpers import F64, assert_same_nc, np_tree, port_cfg

torch.set_num_threads(1)

TOL = 1e-12
FIELDS = ("px", "py", "pz", "dpxm", "dpym", "dpzm", "active", "first",
          "n_bot", "n_sur")


def _case(name):
    if name == "filament":
        cfg = jfilament.config(ntimes=1).replace(nx=16, ny=16, nz=8)
        grid, st, _ = jfilament.setup(cfg)
    else:
        cfg = jbasin.config("closed").replace(nx=16, ny=16, nz=8)
        grid, st, _ = jbasin.setup(cfg)
    rng = np.random.default_rng(7)
    hz = np.asarray(st.hz)
    nz, jy, ix = hz.shape
    dx = 1.0 / float(np.asarray(grid.pm)[3, 3])

    def wave(nk, amp):
        """amp * a smooth field of random phases on nk levels."""
        k = np.arange(nk)[:, None, None] / nk
        j = np.arange(jy)[None, :, None] / cfg.ny
        i = np.arange(ix)[None, None, :] / cfg.nx
        ph = rng.uniform(0.0, 2 * np.pi, 3)
        return amp * (np.sin(2 * np.pi * i + ph[0])
                      * np.cos(2 * np.pi * j + ph[1])
                      * (1.0 + 0.3 * np.cos(np.pi * k + ph[2])))
    # index displacements of up to about half a cell a step
    fields = dict(u=wave(nz, 0.5 * dx / cfg.dt),
                  v=wave(nz, 0.5 * dx / cfg.dt),
                  we=wave(nz + 1, 0.3 * dx * dx * hz.mean() / cfg.dt),
                  wi=np.zeros((nz + 1, jy, ix)), hz=hz)
    n = 64
    px = rng.uniform(-0.5, cfg.nx + 0.5, n)
    py = rng.uniform(-0.5, cfg.ny + 0.5, n)
    pz = rng.uniform(0.0, cfg.nz, n)
    # outside the domain on every side, beyond both vertical ends (and the
    # dead zone beyond 2*nz), and a NaN position
    px[:6] = [-3.0, cfg.nx + 5.0, 4.0, 4.0, 7.5, np.nan]
    py[:6] = [4.0, 4.0, -2.5, cfg.ny + 3.0, 7.5, 3.0]
    pz[6:10] = [-1.0, cfg.nz + 2.0, 2 * cfg.nz + 1.0, 0.0]
    return cfg, grid, fields, (px, py, pz)


def _port_state(ps):
    return particles.ParticleState(**{
        k: torch.as_tensor(np.array(getattr(ps, k))) for k in FIELDS})


def _assert_ps_close(got, ref):
    for k in FIELDS:
        np.testing.assert_allclose(getattr(got, k).numpy(),
                                   np.asarray(getattr(ref, k)), rtol=TOL,
                                   atol=TOL, err_msg=k)


@pytest.mark.parametrize("case", ["filament", "basin"])
def test_rhs_and_advance_match_jax(case):
    cfg, jg, f, (px, py, pz) = _case(case)
    jf = {k: jnp.asarray(v) for k, v in f.items()}
    tf = {k: torch.as_tensor(np.array(v)) for k, v in f.items()}
    tg = bridge.grid_from_numpy(np_tree(jg), dtype=F64, device="cpu")
    tcfg = port_cfg(cfg)
    jps = jparticles.seed_particles(px, py, pz, npart_max=80)
    tps = particles.seed_particles(px, py, pz, npart_max=80)
    _assert_ps_close(tps, jps)

    ref = jparticles.rhs_particles(jps, jf["u"], jf["v"], jf["we"],
                                   jf["wi"], jf["hz"], jg, cfg)
    got = particles.rhs_particles(tps, tf["u"], tf["v"], tf["we"], tf["wi"],
                                  tf["hz"], tg, tcfg)
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=TOL,
                                   atol=TOL)
    for _ in range(5):
        jps = jparticles.advance_particles(jps, jf["u"], jf["v"], jf["we"],
                                           jf["wi"], jf["hz"], jg, cfg)
        tps = particles.advance_particles(tps, tf["u"], tf["v"], tf["we"],
                                          tf["wi"], tf["hz"], tg, tcfg)
        _assert_ps_close(tps, jps)
    assert int(tps.n_bot) > 0 and int(tps.n_sur) > 0
    if case == "basin":
        assert not bool(tps.active[:4].any())   # left through the walls


def _uniform(cfg, u0, w0=0.0):
    grid, st, _ = tfilament.setup(cfg, device="cpu")
    return (grid, st, torch.full_like(st.u, u0), torch.zeros_like(st.v),
            torch.full_like(st.we, w0), torch.zeros_like(st.wi))


def _config():
    return tfilament.config(ntimes=1).replace(nx=16, ny=16, nz=8)


def test_uniform_flow_advection():
    cfg = _config()
    grid, st, u, v, we, wi = _uniform(cfg, 0.2)
    dx = 1.0 / float(grid.pm[3, 3])
    ps = particles.seed_particles([4.0, 8.0], [6.0, 6.0], [4.0, 4.0])
    for _ in range(5):
        ps = particles.advance_particles(ps, u, v, we, wi, st.hz, grid, cfg)
    np.testing.assert_allclose(float(ps.px[0]), 4.0 + 5 * 0.2 * cfg.dt / dx,
                               rtol=1e-12)
    np.testing.assert_allclose(float(ps.py[0]), 6.0, atol=1e-12)
    np.testing.assert_allclose(float(ps.pz[0]), 4.0, atol=1e-12)
    assert bool(ps.active[0])


def test_periodic_wrap():
    cfg = _config()
    grid, st, u, v, we, wi = _uniform(cfg, 5.0)
    ps = particles.seed_particles([15.0], [6.0], [4.0])
    for _ in range(20):
        ps = particles.advance_particles(ps, u, v, we, wi, st.hz, grid, cfg)
    assert -0.5 <= float(ps.px[0]) < cfg.nx + 0.5
    assert bool(ps.active[0])


def test_vertical_clamp_counters():
    cfg = _config()
    grid, st, u, v, _, wi = _uniform(cfg, 0.0)
    we = torch.full_like(st.we, -1.0e7)
    ps = particles.seed_particles([6.0], [6.0], [1.0])
    for _ in range(10):
        ps = particles.advance_particles(ps, u, v, we, wi, st.hz, grid, cfg)
    assert float(ps.pz[0]) > 0.0
    assert int(ps.n_bot) > 0
    assert ps.n_bot.dtype == torch.int32 and ps.first.dtype == torch.bool


def test_inactive_capacity_stays():
    cfg = _config()
    grid, st, u, v, we, wi = _uniform(cfg, 0.1)
    ps = particles.seed_particles([4.0], [4.0], [4.0], npart_max=8)
    assert int(ps.active.sum()) == 1
    ps2 = particles.advance_particles(ps, u, v, we, wi, st.hz, grid, cfg)
    np.testing.assert_array_equal(ps2.px[1:].numpy(), np.zeros(7))


def test_writer_matches_jax(tmp_path):
    cfg, jg, f, (px, py, pz) = _case("basin")
    jps = jparticles.seed_particles(px, py, pz, npart_max=80)
    jps = jps.replace(active=jps.active.at[3].set(False))
    tps = _port_state(jps)
    paths = {k: str(tmp_path / f"{k}.nc") for k in ("port", "jax")}
    tw = particles.ParticleWriter(paths["port"], 80, port_cfg(cfg))
    jw = jparticles.ParticleWriter(paths["jax"], 80, cfg)
    for t in (60.0, 120.0):
        tw.write(tps, t)
        jw.write(jps, t)
    tw.close()
    jw.close()
    assert_same_nc(paths["port"], paths["jax"])
