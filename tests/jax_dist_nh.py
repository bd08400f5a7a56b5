"""Print how far the JAX package's distributed step with the
non-hydrostatic projection lands from its single-device step, in float64
on the CPU:

    JAX_PLATFORMS=cpu python tests/jax_dist_nh.py

bench_production at 48x32x16 with nt=4, `non_hydrostatic` on, 2 steps on
one device and on a 2x2 mesh of virtual CPU devices
(`roms_tpu.parallel.dist`), without the projection too for contrast, and
then with the budgets and the upscale capture (3 steps, no projection):
how far the JAX package's own mesh run is from its single run in each
budget term and strip, the round-off that the port's mesh comparison
(tests/test_torch_dist.py, chip_smoke.py phase 15b) has to allow.
Each line: the array and max |mesh - single| / max(1, max|single|)
over the interior (the budget terms also against max(1, max|Hz t|), the
content they are differences of, and against their own largest value).

The projection's PCG (`roms_tpu/nhmg.py:nh_solve`) takes its dot products
with a plain `jnp.sum` and refreshes no halo between iterations, so under
`shard_map` each block solves its own problem.  The port solves the global
one on a mesh instead (dot products summed over the ranks, a halo refresh
in each iteration: `roms_tpu_torch/nhmg.py`), held to the JAX package's
single-device projection by tests/test_torch_dist_nh.py.  The step
compiles for each of the six runs: a few minutes of CPU.
"""

import os
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
sys.path.insert(0, os.path.dirname(HERE))

import conftest  # noqa: E402,F401  (JAX on the CPU, 8 devices, float64)
import jax.numpy as jnp  # noqa: E402

from roms_tpu.cases import bench_production  # noqa: E402
from roms_tpu.ops.weights import set_weights  # noqa: E402
from roms_tpu.parallel.dist import (from_blocked,  # noqa: E402
                                    make_distributed_step, make_mesh,
                                    to_blocked)
from roms_tpu.stepper import step  # noqa: E402

FIELDS = ("zeta", "ubar", "vbar", "u", "v", "t", "hz", "flx_u", "flx_v")
NSTEPS = 2
H = 2


def _runs(cfg, nsteps=NSTEPS):
    grid, st, frc = bench_production.setup(cfg, dtype=jnp.float64)
    w1, w2, _ = set_weights(cfg.ndtfast)
    w1, w2 = jnp.asarray(w1), jnp.asarray(w2)
    s1 = st
    for i in range(nsteps):
        s1 = step(s1, frc, grid, w1, w2, cfg, first_step=(i == 0))
    mesh = make_mesh(4)
    assert mesh.devices.shape == (2, 2), mesh.devices.shape
    first, rest = make_distributed_step(cfg, mesh)
    sb = to_blocked(st, mesh, H)
    fb = to_blocked(frc, mesh, H)
    gb = to_blocked(grid, mesh, H)
    for i in range(nsteps):
        sb = (first if i == 0 else rest)(sb, fb, gb, w1, w2)
    return s1, from_blocked(sb, mesh, H)


def main():
    worst = {}
    for nh in (False, True):
        cfg = bench_production.config(nx=48, ny=32, nz=16, nt=4).replace(
            non_hydrostatic=nh)
        s1, sd = _runs(cfg)
        print(f"non_hydrostatic={nh}: 2x2 mesh against one device, "
              f"{NSTEPS} steps", flush=True)
        for name in FIELDS:
            a = np.asarray(getattr(s1, name))[..., H:-H, H:-H]
            b = np.asarray(getattr(sd, name))[..., H:-H, H:-H]
            rel = float(np.abs(b - a).max()) / max(1.0, float(
                np.abs(a).max()))
            worst[nh, name] = rel
            print(f"  {name:6s} max |mesh - single| / max(1, max|single|) "
                  f"{rel:.3e}", flush=True)
    over = max(worst[True, n] for n in FIELDS)
    print(f"projection on the mesh: largest {over:.3e} -> "
          + ("differs beyond 1e-8: one problem a block (the port's mesh "
             "projection is the global one)"
             if over > 1e-8 else "agrees within 1e-8"), flush=True)
    _budgets()


def _budgets():
    cfg = bench_production.config(nx=48, ny=32, nz=16, nt=4).replace(
        tracer_diagnostics=True, uv_diagnostics=True, upscale_output=True)
    s1, sd = _runs(cfg, nsteps=3)
    content = max(1.0, float(np.abs(np.asarray(s1.hz)[None]
                                    * np.asarray(s1.t)).max()))
    print("budgets and upscale: 2x2 mesh against one device, 3 steps; "
          "u terms on columns H+1.., v terms on rows H+1.. (the "
          "reference's update range)", flush=True)
    arrays = {f"t_budget.{k}": (v, (Ellipsis, slice(H, -H), slice(H, -H)))
              for k, v in s1.t_budget.items()}
    for c, sl in (("u", (Ellipsis, slice(H, -H), slice(H + 1, -H))),
                  ("v", (Ellipsis, slice(H + 1, -H), slice(H, -H)))):
        arrays.update({f"uv_budget.{c}.{k}": (v, sl)
                       for k, v in s1.uv_budget[c].items()})
    arrays.update({f"upscale.{k}": (v, (Ellipsis, slice(H, -H)))
                   for k, v in s1.upscale.items()})
    for name, (a, sl) in sorted(arrays.items()):
        part, *key = name.split(".")
        b = getattr(sd, part)
        for k in key:
            b = b[k]
        a, b = np.asarray(a)[sl], np.asarray(b)[sl]
        diff, top = float(np.abs(b - a).max()), float(np.abs(a).max())
        print(f"  {name:18s} {diff / max(1.0, top):.3e}"
              f"  against the content {diff / content:.3e}"
              f"  against its own max {diff / max(top, 1e-300):.3e}",
              flush=True)


if __name__ == "__main__":
    main()
