"""Print the non-hydrostatic PCG's residual after 10, 20, 40 and 80
iterations, res/res0, in the JAX package and in the port, in float64 and
float32, on the CPU:

    JAX_PLATFORMS=cpu python tests/jax_nh_convergence.py

The projection runs on the state after 2 steps of bench_production at
48x32x16 and 96x48x30 (nt=4), with a zero trial w, as the step calls it.
On this grid the residual's norm rises above its start before it falls:
40 iterations (the default nh_iters) leave res/res0 above 1 in both
packages and both precisions, which is what chip_smoke.py's phase 14c
reads at 384x192x60 on the card.

Then, on tests/test_torch_nhmg.py's seamount in float64 with the sigma
terms on and off, after 20 and 40 iterations: the distance between the
JAX package's solve under `jax.jit` and without (only XLA's fusion
differs), and the port's distance from the JAX solve without jit, as
res/res0 relative and p, u, v, w in max|diff| / max(1, max|ref|), which
test_nh_solve_default_iterations_match_jax measures and bounds.
"""

import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
sys.path.insert(0, os.path.dirname(HERE))

import conftest  # noqa: E402,F401  (JAX on the CPU, float64)
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from roms_tpu import nhmg as jnhmg  # noqa: E402
from roms_tpu.cases import bench_production as jbp  # noqa: E402
from roms_tpu_torch import bridge, nhmg  # noqa: E402
from roms_tpu_torch.cases import bench_production as tbp  # noqa: E402
from roms_tpu_torch.driver import run  # noqa: E402
from test_torch_nhmg import GRID, _distance, _seamount, _t, _trial  # noqa: E402,E501
from torch_helpers import jax_cfg, np_tree, port_cfg  # noqa: E402


def main():
    for nx, ny, nz in ((48, 32, 16), (96, 48, 30)):
        cfg = tbp.config(nx=nx, ny=ny, nz=nz, nt=4)
        jcfg = jax_cfg(cfg)
        g, st, frc = tbp.setup(cfg, dtype=torch.float64, device="cpu")
        st, _ = run(g, st, frc, cfg, nsteps=2, collect_diag=False)
        w0 = torch.zeros((nz + 1,) + tuple(st.u.shape[1:]),
                         dtype=torch.float64)
        fields = (st.u, st.v, w0, st.hz, st.z_r, g.pm, g.pn)
        for n in (10, 20, 40, 80):
            line = []
            for jdt, tdt in ((jnp.float64, torch.float64),
                             (jnp.float32, torch.float32)):
                jg = jbp.setup(jcfg, dtype=jdt)[0]
                tg = bridge.grid_from_numpy(np_tree(jg), dtype=tdt,
                                            device="cpu")
                args = [x.to(tdt) for x in fields]
                got = nhmg.nh_solve(*args, tg, cfg, n_iter=n)
                ref = jnhmg.nh_solve(*[jnp.asarray(a.numpy()) for a in args],
                                     jg, jcfg, n_iter=n)
                line.append(f"{str(tdt)[6:]}: JAX "
                            f"{float(ref.res / ref.res0):.3e} port "
                            f"{float(got.res / got.res0):.3e}")
            print(f"{nx}x{ny}x{nz} {n:3d} iterations  " + "  ".join(line),
                  flush=True)



def seamount():
    for sigma in (True, False):
        cfg, hz, z_r, pm, pn = _seamount()
        cfg = cfg.replace(nh_sigma_terms=sigma)
        u, v, w = _trial(hz)
        args = list(map(jnp.asarray, (u, v, w, hz, z_r, pm, pn)))
        for n in (20, 40):
            def fields(r):
                return {k: np.asarray(getattr(r, k))
                        for k in ("p", "u", "v", "w", "res", "res0")}
            ref = fields(jnhmg.nh_solve(*args, GRID, cfg, n_iter=n))
            fused = fields(jax.jit(lambda *a: jnhmg.nh_solve(
                *a, GRID, cfg, n_iter=n))(*args))
            got = fields(nhmg.nh_solve(*_t(u, v, w, hz, z_r, pm, pn), GRID,
                                       port_cfg(cfg), n_iter=n))
            for what, d in (("JAX jit vs not", _distance(fused, ref)),
                            ("port vs JAX", _distance(got, ref))):
                print(f"seamount sigma={sigma} {n:3d} iterations {what:15s} "
                      + "  ".join(f"{k} {x:.3e}" for k, x in d.items()),
                      flush=True)


if __name__ == "__main__":
    main()
    seamount()
