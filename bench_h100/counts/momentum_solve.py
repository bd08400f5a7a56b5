"""One launch of the implicit momentum solve (`csrc/momentum_solve.cu`,
`momentum_solve_kernel`), counted as roms_tpu_torch/ops/cuda_solve.py's
`launch_bytes` counted it at the benchmark's first commit: rhs and
hz_face (nz levels), akv_face and wi_face (nz + 1), dc0, the surface
stress and the bottom drag (the step passes it in all four calls) read
once, the solution written once; 10 operations per level and column
(chip_smoke.py's kernel table)."""

from bench_h100 import peaks

KERNELS = ("momentum_solve_kernel",)


def bound_s(cfg, elem: int) -> float:
    nz = cfg.nz
    col = (cfg.ny + 2 * cfg.halo) * (cfg.nx + 2 * cfg.halo)
    nbytes = (3 * nz + 2 * (nz + 1) + 3) * col * elem
    return peaks.bound_s(10 * nz * col, nbytes, elem)[0]
