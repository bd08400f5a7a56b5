"""One launch of the momentum r.h.s. (`csrc/uv_rhs.cu`, `uv_rhs_kernel`),
counted as roms_tpu_torch/ops/cuda_uv_rhs.py counts it: u, v, flx_u,
flx_v and Hz (nz levels each), We (nz + 1) and the 2D fields the
configuration reads (the Coriolis parameter; with CURVGRID the two metric
terms; with masking the u and v masks) read once, ru and rv written once;
and a lower count of 150 operations per level and column (both
components' fluxes, Coriolis terms and spline sweeps; chip_smoke.py's
kernel table).

A step launches it twice, the predictor's call (CENTERED4) and the
corrector's (UPSTREAM3), on the same arrays, so both calls have this
bound."""

from bench_h100 import peaks

KERNELS = ("uv_rhs_kernel",)


def launch_bytes(cfg, elem: int) -> int:
    nz = cfg.nz
    col = (cfg.ny + 2 * cfg.halo) * (cfg.nx + 2 * cfg.halo)
    curv = cfg.curvgrid and cfg.uv_adv
    planes = (5 * nz + (nz + 1) + 1 + 2 * int(curv)
              + 2 * int(cfg.masking and cfg.uv_adv)
              + 2 * nz)                                  # + ru and rv
    return planes * col * elem


def launch_ops(cfg) -> int:
    col = (cfg.ny + 2 * cfg.halo) * (cfg.nx + 2 * cfg.halo)
    return 150 * cfg.nz * col


def bound_s(cfg, elem: int) -> float:
    return peaks.bound_s(launch_ops(cfg), launch_bytes(cfg, elem), elem)[0]
