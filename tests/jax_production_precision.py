"""The production-physics case's float32 drift from float64 on the CPU in
both packages: the root precision_study.study (the JAX package) and the
port's roms_tpu_torch.precision_study.study, each case built from one
configuration (cases/bench_production.py cut to NXxNYxNZ with NT tracers),
their rows printed side by side.  The JAX package keeps no record of this
case (PRECISION_DATA.json has Filament and Rivers_ana only), so this is
the reference that the port's rows on the card (PRECISION_DATA_torch.json,
384x192x60 nt=34) are read against.

    JAX_PLATFORMS=cpu python tests/jax_production_precision.py \
        [NSTEPS [NX NY NZ NT]]

Defaults: 50 steps at 96x48x30 nt=4 (about four minutes on four CPU
threads).
"""

import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
sys.path.insert(0, os.path.dirname(HERE))
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402

jax.config.update("jax_enable_x64", True)

import torch  # noqa: E402

import precision_study as jax_study  # noqa: E402
from roms_tpu.cases import bench_production as jbp  # noqa: E402
from roms_tpu_torch import precision_study  # noqa: E402
from roms_tpu_torch.cases import bench_production as tbp  # noqa: E402
from torch_helpers import port_cfg  # noqa: E402


def main():
    nsteps, nx, ny, nz, nt = (int(a) for a in
                              (sys.argv[1:] + ["50", "96", "48", "30",
                                               "4"][len(sys.argv[1:]):]))
    torch.set_num_threads(4)
    jcfg = jbp.config(nx=nx, ny=ny, nz=nz, nt=nt)
    tcfg = port_cfg(jcfg)
    quiet = lambda *a: None  # noqa: E731
    jrows = jax_study.study(
        "jax", lambda dtype: (jcfg, *jbp.setup(jcfg, dtype=dtype)), nsteps)
    trows = precision_study.study(
        "port", lambda dtype: (tcfg, *tbp.setup(tcfg, dtype=dtype,
                                                device="cpu")),
        nsteps, "cpu", say=quiet)
    print(f"production {nx}x{ny}x{nz} nt={nt} on the CPU, float32 drift "
          f"from float64: JAX package / port")
    for j, t in zip(jrows, trows):
        print(f"step {j['step']:4d}: " + "  ".join(
            f"{f} {j[f]:.3e} / {t[f]:.3e}" for f in precision_study.FIELDS))


if __name__ == "__main__":
    main()
