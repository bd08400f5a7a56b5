"""One call of the KPP vertical-mixing update (`csrc/kpp_vmix.cu`: the
column kernel `k_column` and the profile kernel `k_profile`), counted as
roms_tpu_torch/ops/cuda_kpp.py's `launch_bytes` counted it at the
benchmark's first commit: u, v, z_r, Hz (nz levels), bvf, z_w, swrf
(nz + 1), the surface T (and S) and their fluxes, srflx, sustr, svstr, f,
hbls, hbbl and the three masks read once; Akv, Kt (and Ks), ghat (nz + 1)
and the new hbls, hbbl written once; 100 operations per level and column
(Ri, smoother, wscale, profiles; chip_smoke.py's kernel table)."""

from bench_h100 import peaks

KERNELS = ("k_column<", "k_profile<")


def bound_s(cfg, elem: int) -> float:
    nz, s = cfg.nz, int(cfg.salinity)
    col = (cfg.ny + 2 * cfg.halo) * (cfg.nx + 2 * cfg.halo)
    planes = (4 * nz + 3 * (nz + 1) + 2 * (1 + s) + 6 + 3 * int(cfg.masking)
              + (3 + s) * (nz + 1) + 2)
    return peaks.bound_s(100 * nz * col, planes * col * elem, elem)[0]
