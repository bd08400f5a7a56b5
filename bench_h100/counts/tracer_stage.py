"""One launch of the fused tracer stage (`csrc/tracer_stage.cu`,
`tracer_stage_kernel`), counted as roms_tpu_torch/ops/cuda_tracer.py
counted it at the benchmark's first commit: each distinct input read
once and the output written once (`_build.compulsory_bytes`), and a lower
count of 40 operations per tracer, level and column (flux, divergence,
spline and Thomas sweeps; chip_smoke.py's kernel table).

A step launches it twice: the predictor reads tk, t_sec, flx_u, flx_v,
Hz(n), flx_div, We, Wi, the used rows of Akt and the four 2D fields
(pmn and the three masks); the corrector reads, besides, the surface
flux of every tracer and, with lateral diffusion (TS_DIF2, tnu2 != 0),
the diffusivity of every tracer and pmon_u, pnom_v.  One call here is the
mean of the two, so the bound of a window of whole steps is exact."""

from bench_h100 import peaks

KERNELS = ("tracer_stage_kernel",)


def launch_bytes(cfg, elem: int, mode: str) -> int:
    nt, nz = cfg.nt, cfg.nz
    col = (cfg.ny + 2 * cfg.halo) * (cfg.nx + 2 * cfg.halo)
    imix = max(cfg.i_t_and_s, 1)
    planes = (2 * nt * nz + 4 * nz + (2 + imix) * (nz + 1) + 4
              + nt * nz)                                   # + the output
    if mode == "corr":
        planes += nt
        if cfg.ts_dif2 and cfg.tnu2 != 0.0:
            planes += nt + 2
    return planes * col * elem


def launch_ops(cfg) -> int:
    col = (cfg.ny + 2 * cfg.halo) * (cfg.nx + 2 * cfg.halo)
    return 40 * cfg.nt * cfg.nz * col


def bound_s(cfg, elem: int) -> float:
    return 0.5 * sum(peaks.bound_s(launch_ops(cfg),
                                   launch_bytes(cfg, elem, mode), elem)[0]
                     for mode in ("pred", "corr"))
