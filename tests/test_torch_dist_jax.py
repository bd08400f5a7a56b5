"""The port's distributed slice against the JAX package's, in float64 on
the CPU: the JAX `run_distributed` once, on obc_basin `radiating` (open
boundaries on all four edges, so edge ownership decides which blocks
apply the boundary conditions) on a 2x2 mesh of virtual CPU devices,
3 steps, against the port's `run_distributed` on 2x2 gloo ranks: every
state field at atol 5e-11 * max(1, max|ref|) (STEP_TOL, the bound of
tests/test_torch_obc_basin.py), the diagnostics rows at rtol 1e-12, but
the vertical Courant number at rtol 1e-8 and atol 1e-8 of its largest
(it reads `we`, which bench_production.CONDITIONED_TOL holds at 1e-8: the
JAX package's own single and mesh runs give it 1.3e-10 apart after two
steps, and 6.9e-20 against 2.8e-19 after the first, where w is round-off
on zero); then
the port's distributed particle step against the JAX package's
`advance_particles` on the JAX run's final fields at rtol = atol = 1e-13.
The JAX step's compile takes most of this file's time.
"""

import numpy as np
import torch

from roms_tpu import particles as jparticles
from roms_tpu.cases import obc_basin as jbasin
from roms_tpu.driver import run_distributed as jrun_distributed
from roms_tpu.parallel.dist import make_mesh

from roms_tpu_torch.cases import bench_production
from roms_tpu_torch.parallel import dist

import torch_dist_ranks as ranks
from torch_helpers import np_tree, port_cfg

torch.set_num_threads(1)

CASE = dict(nx=24, ny=20, nz=6)
SPEC = ("obc:radiating", CASE, {})


def _seeds(cfg, n=300, seed=3):
    rng = np.random.default_rng(seed)
    px = np.concatenate([rng.uniform(-1.0, cfg.nx + 1.0, n - 4),
                         [11.5, 11.49, -0.5, np.nan]])
    py = np.concatenate([rng.uniform(-1.0, cfg.ny + 1.0, n - 4),
                         [9.5, 9.51, 4.0, 4.0]])
    pz = rng.uniform(-0.5, cfg.nz + 0.5, n)
    return px, py, pz


def test_run_distributed_and_particles_match_jax(tmp_path):
    cfg = jbasin.config("radiating").replace(**CASE)
    jg, jst, jfrc = jbasin.setup(cfg)
    mesh = make_mesh(4)
    assert mesh.devices.shape == (2, 2)
    jstate, jrows = jrun_distributed(jg, jst, jfrc, cfg, mesh, nsteps=3)
    assert port_cfg(cfg) == ranks.build(SPEC)[0]
    got = dist.launch(ranks.run_case, 4, "gloo", "cpu", args=(SPEC, 3),
                      timeout=300.0, store_dir=str(tmp_path))
    ref = {k: v for k, v in np_tree(jstate).items() if v is not None}
    for r, (state, rows) in enumerate(got):
        assert set(ref) == {k for k, v in state.items() if v is not None}
        for name, a in ref.items():
            scale = max(1.0, float(np.abs(a).max()))
            np.testing.assert_allclose(
                state[name], a, rtol=0,
                atol=bench_production.STEP_TOL * scale,
                err_msg=f"rank {r} {name}")
        jrows = np.asarray(jrows)
        np.testing.assert_allclose(rows[:, :4], jrows[:, :4], rtol=1e-12,
                                   atol=0, err_msg=f"rank {r} diag rows")
        np.testing.assert_allclose(
            rows[:, 4], jrows[:, 4], rtol=1e-8,
            atol=1e-8 * np.abs(jrows[:, 4]).max(),
            err_msg=f"rank {r} vertical Courant numbers")

    # the particles on the JAX run's final fields
    fields = {k: np.asarray(ref[k]) for k in ("u", "v", "we", "wi", "hz")}
    px, py, pz = _seeds(cfg)
    jps = jparticles.seed_particles(px, py, pz, npart_max=len(px) + 4)
    for _ in range(3):
        jps = jparticles.advance_particles(jps, *fields.values(), jg, cfg)
    want = np_tree(jps)
    tps = {k: v for k, v in np_tree(jparticles.seed_particles(
        px, py, pz, npart_max=len(px) + 4)).items()}
    out = dist.launch(ranks.particles, 4, "gloo", "cpu",
                      args=(SPEC, fields, tps, 3), timeout=300.0,
                      store_dir=str(tmp_path))
    for r, g in enumerate(out):
        for name, a in want.items():
            np.testing.assert_allclose(
                np.asarray(g[name], np.float64), np.asarray(a, np.float64),
                rtol=1e-13, atol=1e-13, err_msg=f"rank {r} particles {name}")
