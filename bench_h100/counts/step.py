"""One baroclinic step (`roms_tpu_torch.stepper.step_impl`), counted from
the configuration's shapes at the benchmark's first commit, as the least
work any implementation of the step must do.

Bytes: each array the step needs read once and each array it makes
written once.  Read: the state at time n (zeta, ubar, vbar and the six
fast-averaged fluxes; u, v and their previous levels; every tracer and
its previous level; z_w, z_r, Hz), the mixing coefficients (Akv, Akt)
and with KPP the boundary layers and the solar fraction; 25 grid fields;
the surface forcing (two stresses, solar, fresh water and every tracer's
flux).  Written: the new state (zeta, ubar, vbar, the six fluxes, u, v,
every tracer, z_w, z_r, Hz, the fluxes flx_u, flx_v, We, Wi, rho) and
with KPP Akv, Akt, hbls, hbbl.

Operations, a lower count: the three kernels' counts (`tracer_stage`,
`momentum_solve`, `kpp_vmix`) per step and 50 per column for each
barotropic sub-step (ndtfast of them); the rest of the 3D operators is
left out, so the bound errs low."""

from bench_h100 import peaks

GRID_PLANES = 25
SUBSTEP_OPS = 50


def step_bytes(cfg, elem: int) -> int:
    nt, nz, w = cfg.nt, cfg.nz, cfg.nz + 1
    n_akt = cfg.i_t_and_s
    kpp = int(cfg.lmd_kpp)
    read3 = 4 * nz + 2 * nt * nz + w + 2 * nz + (1 + n_akt) * w + kpp * w
    write3 = 2 * nz + nt * nz + w + 2 * nz + 2 * nz + 2 * w + nz
    write3 += kpp * (1 + n_akt) * w
    read2 = 9 + 2 * kpp + GRID_PLANES + 4 + nt
    write2 = 9 + 2 * kpp
    col = (cfg.ny + 2 * cfg.halo) * (cfg.nx + 2 * cfg.halo)
    return (read3 + write3 + read2 + write2) * col * elem


def step_ops(cfg) -> int:
    nz = cfg.nz
    col = (cfg.ny + 2 * cfg.halo) * (cfg.nx + 2 * cfg.halo)
    ops = 2 * 40 * cfg.nt * nz + 4 * 10 * nz + SUBSTEP_OPS * cfg.ndtfast
    if cfg.lmd_kpp:
        ops += 2 * 100 * nz
    return ops * col


def bound_s(cfg, elem: int) -> tuple[float, str]:
    return peaks.bound_s(step_ops(cfg), step_bytes(cfg, elem), elem)
