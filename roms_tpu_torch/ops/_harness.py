"""Random inputs for the two kernel modules, made with numpy from a seed.

These are the harnesses of tests/test_pallas_tracer.py:_setup and
tests/test_pallas_solve.py:_setup (default shapes nx=24, ny=18, nz=10,
nt=3), shared by tests/test_torch_kernels.py, which feeds them to both
packages, and chip_smoke.py, which holds each CUDA kernel against its
plain version on the card.  Each returns (cfg, dict of float64 numpy
arrays) on the padded (jy, ix) = (ny + 4, nx + 4) grid.
"""

from __future__ import annotations

import numpy as np

from roms_tpu_torch.config import ModelConfig


def tracer_inputs(nx=24, ny=18, nz=10, nt=3, periodic=False, seed=0):
    """Inputs of one tracer stage; `diff2`, `pmon_u` and `pnom_v` (fixed
    side seeds 9, 7, 8) are the fused t3dmix's."""
    cfg = ModelConfig(nx=nx, ny=ny, nz=nz, nt=nt, salinity=True,
                      ew_periodic=periodic, ns_periodic=periodic)
    jy, ix = ny + 4, nx + 4
    rng = np.random.default_rng(seed)

    def r(*sh):
        return rng.standard_normal(sh)

    d = dict(tk=10.0 + r(nt, nz, jy, ix), t_sec=10.0 + r(nt, nz, jy, ix),
             flx_u=0.1 * r(nz, jy, ix), flx_v=0.1 * r(nz, jy, ix),
             hz_n=5.0 + 0.5 * r(nz, jy, ix))
    d["hz_d"] = 0.01 * r(nz, jy, ix)
    d["hz_new"] = d["hz_n"] + 0.1 * r(nz, jy, ix)
    d["we"] = 0.05 * r(nz + 1, jy, ix)
    d["wi"] = 0.05 * r(nz + 1, jy, ix)
    d["akt"] = 0.001 + 0.0005 * np.abs(r(2, nz + 1, jy, ix))
    d["pmn"] = 1e-3 * (1.0 + 0.1 * rng.standard_normal((jy, ix)))
    rmask = (rng.random((jy, ix)) > 0.15).astype(np.float64)
    d["rmask"] = rmask
    d["umask"] = rmask * np.roll(rmask, 1, axis=1)
    d["vmask"] = rmask * np.roll(rmask, 1, axis=0)
    d["stflx"] = 0.01 * r(nt, jy, ix)
    d["diff2"] = 0.5 + 0.1 * np.abs(
        np.random.default_rng(9).standard_normal((nt, jy, ix)))
    d["pmon_u"] = 1.0 + 0.1 * np.random.default_rng(7).standard_normal(
        (jy, ix))
    d["pnom_v"] = 1.0 + 0.1 * np.random.default_rng(8).standard_normal(
        (jy, ix))
    return cfg, d


def solve_inputs(nx=24, ny=18, nz=10, seed=0):
    """Inputs of one implicit momentum solve; `rd` is the drag."""
    cfg = ModelConfig(nx=nx, ny=ny, nz=nz)
    jy, ix = ny + 4, nx + 4
    rng = np.random.default_rng(seed)

    def r(*sh):
        return rng.standard_normal(sh)

    return cfg, dict(rhs=r(nz, jy, ix), hzf=5.0 + 0.5 * np.abs(r(nz, jy, ix)),
                     akvf=1e-3 + 1e-4 * np.abs(r(nz + 1, jy, ix)),
                     wif=0.01 * r(nz + 1, jy, ix),
                     dc0=1e-4 * (1.0 + 0.1 * np.abs(r(jy, ix))),
                     sstr=1e-4 * r(jy, ix), rd=1e-4 * np.abs(r(jy, ix)))
