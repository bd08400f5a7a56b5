"""Random inputs for the three kernel modules, made with numpy from a
seed.

These are the harnesses of tests/test_pallas_tracer.py:_setup,
tests/test_pallas_solve.py:_setup and tests/test_pallas_kpp.py:_setup
(default shapes nx=24, ny=18, nz=10), shared by tests/test_torch_*.py,
which feed them to both packages, and chip_smoke.py, which holds each
CUDA kernel against its plain version on the card.  Each returns (cfg,
dict of float64 numpy arrays) on the padded (jy, ix) = (ny + 4, nx + 4)
grid.
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


def kpp_inputs(nx=24, ny=18, nz=10, salinity=True, masking=True, seed=0,
               ew_periodic=False, ns_periodic=False):
    """Inputs of one vmix update (interior mixing + KPP), drawn in the
    order of tests/test_pallas_kpp.py:_setup so a seed gives the same
    fields."""
    cfg = ModelConfig(nx=nx, ny=ny, nz=nz, nt=2 if salinity else 1,
                      salinity=salinity, masking=masking, lmd_kpp=True,
                      nonlin_eos=True, ew_periodic=ew_periodic,
                      ns_periodic=ns_periodic)
    jy, ix = ny + 4, nx + 4
    rng = np.random.default_rng(seed)

    def r(*sh):
        return rng.standard_normal(sh)

    hz = 5.0 + 0.5 * np.abs(r(nz, jy, ix))
    z_w = np.concatenate([np.zeros((1, jy, ix)), np.cumsum(hz, axis=0)],
                         axis=0)
    z_w = z_w - z_w[-1]                       # z_w[nz] = 0 (surface)
    d = dict(hz=hz, z_w=z_w, z_r=0.5 * (z_w[1:] + z_w[:-1]))
    d["u"] = 0.1 * r(nz, jy, ix)
    d["v"] = 0.1 * r(nz, jy, ix)
    d["bvf"] = 1e-5 * r(nz + 1, jy, ix)       # mixed-sign stratification
    d["t"] = np.stack([15.0 + r(nz, jy, ix)]
                      + ([35.0 + 0.1 * r(nz, jy, ix)] if salinity else []))
    d["swrf"] = np.clip(0.05 + np.abs(r(nz + 1, jy, ix)), 0.0, 1.0)
    nt = d["t"].shape[0]
    d["stflx"] = 1e-5 * r(nt, jy, ix)
    d["srflx"] = 1e-5 * np.abs(r(jy, ix))
    d["sustr"] = 1e-4 * r(jy, ix)
    d["svstr"] = 1e-4 * r(jy, ix)
    rmask = (rng.random((jy, ix)) > 0.15).astype(np.float64)
    d["f"] = 8e-5 + 1e-6 * rng.standard_normal((jy, ix))
    d["rmask"] = rmask
    d["umask"] = rmask * np.roll(rmask, 1, axis=1)
    d["vmask"] = rmask * np.roll(rmask, 1, axis=0)
    d["hbls"] = 20.0 + np.abs(r(jy, ix))
    d["hbbl"] = 5.0 + np.abs(r(jy, ix))
    return cfg, d
