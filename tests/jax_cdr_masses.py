"""Write the JAX package's own tracer masses after the 10 steps of each
mCDR case, in float64 on the CPU, to tests/data/{case}_mass_jax.txt:

    JAX_PLATFORMS=cpu python tests/jax_cdr_masses.py

The cases' mass oracles (tests/data/cdr_*_mass_oracle.txt) were frozen
before the full carbonate solver (roms_tpu/bgc/carbonate.py) took over the
air-sea CO2 flux, and no later change refreshed them; the JAX package's
current code misses them in DIC and DIC_ALT_CO2 alone.  These files hold
what it computes now, so that chip_smoke.py can hold the port to the JAX
package in those two tracers.
"""

import os
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
sys.path.insert(0, os.path.dirname(HERE))

import conftest  # noqa: E402,F401  (JAX on the CPU, float64)
import jax  # noqa: E402

from realcase_utils import DATA, run_case  # noqa: E402
from roms_tpu.cases import cdr_3d, cdr_dp, cdr_parameterized  # noqa: E402

CASES = {"cdr_parameterized": cdr_parameterized, "cdr_dp": cdr_dp,
         "cdr_3d": cdr_3d}


def main(workdir):
    for name, module in CASES.items():
        _, masses = run_case(module, os.path.join(workdir, name), 10)
        np.savetxt(os.path.join(DATA, f"{name}_mass_jax.txt"), masses,
                   fmt="%.16E")
        jax.clear_caches()
        print(name, "written", flush=True)


if __name__ == "__main__":
    import tempfile
    with tempfile.TemporaryDirectory() as w:
        main(w)
