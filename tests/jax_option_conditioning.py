"""Print how far the JAX package's own production step moves under a
1e-15 relative perturbation of its tracers (seeds 0-3 of the noise),
array by array, and how far the port's step is from it, in float64 on
the CPU:

    JAX_PLATFORMS=cpu python tests/jax_option_conditioning.py

bench_production at 48x32x16 with nt=4, 3 steps, without options and with
each option set of chip_smoke.py's phase 14 (the non-hydrostatic
projection with the momentum budget; isoneutral mixing with the tracer
budget and the upscale capture).  Each line: the array (the outputs'
terms under dotted names), the JAX step's spread for each seed and their
largest, and the port's distance from the JAX step, all as
max |difference| / max(1, max|JAX|).  After each set, the arrays whose
largest spread is above STEP_TOL, and those that
`bench_production.OPTION_CONDITIONED_TOL` holds at 1e-8 for the set.  These
are the numbers behind `bench_production.CONDITIONED_TOL` and
`OPTION_CONDITIONED_TOL`.  The JAX step compiles for each configuration:
a few minutes of CPU.
"""

import os
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
sys.path.insert(0, os.path.dirname(HERE))

import conftest  # noqa: E402,F401  (JAX on the CPU, float64)
import jax.numpy as jnp  # noqa: E402

from roms_tpu.cases import bench_production as jbp  # noqa: E402
from roms_tpu_torch.cases import bench_production as tbp  # noqa: E402
from test_torch_production import (OPTIONS, SEEDS, _flat,  # noqa: E402
                                   perturbation)
from torch_helpers import np_tree, run_jax, run_port  # noqa: E402


def main():
    for name, flags in [("none", {})] + sorted(OPTIONS.items()):
        cfg = jbp.config(nx=48, ny=32, nz=16, nt=4).replace(**flags)
        jg, jst, jfrc = jbp.setup(cfg, dtype=jnp.float64)
        a = _flat(np_tree(run_jax(cfg, jg, jst, jfrc)))
        bs = [_flat(np_tree(run_jax(cfg, jg, jst.replace(
            t=jst.t * jnp.asarray(perturbation(jst.t.shape, seed))), jfrc)))
            for seed in SEEDS]
        p = _flat(run_port(cfg, jg, jst, jfrc))
        print(f"options: {name}")
        above = []
        for k in sorted(a):
            scale = max(1.0, float(np.abs(a[k]).max()))
            sp = [np.abs(a[k] - b[k]).max() / scale for b in bs]
            print(f"  {k:22s} JAX spread "
                  + " ".join(f"{x:.3e}" for x in sp)
                  + f" max {max(sp):.3e}  port vs JAX "
                  f"{np.abs(p[k] - a[k]).max() / scale:.3e}", flush=True)
            if max(sp) > tbp.STEP_TOL:
                above.append(k)
        print(f"  above STEP_TOL: {', '.join(above)}")
        held = tbp.OPTION_CONDITIONED_TOL.get(name, tbp.CONDITIONED_TOL)
        print(f"  held at 1e-8: {', '.join(sorted(held))}", flush=True)


if __name__ == "__main__":
    main()
