#!/usr/bin/env python3
"""Smoke run of the PyTorch port (roms_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from the sources in this checkout and
drives its main path, the Filament baroclinic step, through
`roms_tpu_torch.driver.run`, in phases; each prints its own lines and the
first failure raises, so the exit code is nonzero:

  0. device: a CUDA device is required; prints its name and
     `nvidia-smi` name/power limit; TF32 off.
  1. build: nvcc builds both kernels for sm_90a into build/.
  2. kernel vs plain: each kernel against its plain PyTorch version on the
     card, on the random-input harnesses of tests/test_pallas_tracer.py and
     tests/test_pallas_solve.py, in float64 (rtol = atol = 1e-12) and
     float32 (rtol 1e-5, atol 1e-5*max|ref|).
  3. oracle: 20 Filament steps at 64x64x32 in float64 against
     tests/data/filament_oracle.txt, both kernels launched.
  4. full width: Filament at 512x256x60 in float32, 2 warm-up + 10 timed
     steps, all finite; each kernel timed against its plain version at
     that shape with CUDA events.

The line before the last is a JSON object {"kernels": [...]}; the last
line is {"ok": true, "device": {...}}.  Imports the port, torch and numpy:
nothing of JAX and nothing of the JAX package directly.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
ORACLE = os.path.join(HERE, "tests", "data", "filament_oracle.txt")

TOL = {torch.float64: (1e-12, 1e-12), torch.float32: (1e-5, 1e-5)}


def say(*a):
    print(*a, flush=True)


# ------------------------------------------------------------------ phase 0
def phase_device():
    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke: no CUDA device (torch.cuda."
                           "is_available() is False)")
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    say(f"[0 device] torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {name} count {torch.cuda.device_count()}")
    say(f"[0 device] nvidia-smi: {smi}")
    return torch.device("cuda", 0), name


# ------------------------------------------------------------------ phase 1
def phase_build():
    from roms_tpu_torch.ops import _build
    path, secs = _build.build()
    _build.library()
    say(f"[1 build] nvcc {secs:.1f} s -> {os.path.relpath(path, HERE)}")


# ------------------------------------------------------------------ phase 2
# ragged: ix = 154 = 128 + 26 leaves a partial 128-thread block along i,
# and jy = 33 is a multiple of no block size
RAGGED = dict(nx=150, ny=29)


def on_card(d, dtype, device):
    return {k: torch.as_tensor(v, dtype=dtype, device=device)
            for k, v in d.items()}


def tracer_case(name, dtype, device):
    """(cfg, positional args, keyword args) of one tracer-stage case on
    the random harness of tests/test_pallas_tracer.py."""
    from roms_tpu_torch.config import AdvScheme
    from roms_tpu_torch.ops import _harness
    scheme = {"corr_upstream3": AdvScheme.UPSTREAM3,
              "corr_centered4": AdvScheme.CENTERED4,
              "corr_akima": AdvScheme.AKIMA}.get(name, AdvScheme.UPSTREAM3)
    shape = RAGGED if name == "corr_ragged" else {}
    cfg, d = _harness.tracer_inputs(periodic=name == "pred_periodic",
                                    **shape)
    x = on_card(d, dtype, device)
    if name.startswith("pred"):
        args = (x["tk"], x["t_sec"], x["flx_u"], x["flx_v"], x["hz_n"],
                x["hz_d"], x["we"], x["wi"], x["akt"], x["pmn"], x["rmask"],
                x["umask"], x["vmask"], cfg, AdvScheme.CENTERED4, 50.0,
                0.5 + 1.0 / 6.0, 0.5 - 1.0 / 6.0, False, "pred")
        return cfg, args, {}
    args = (x["tk"], x["t_sec"], x["flx_u"], x["flx_v"], x["hz_n"],
            x["hz_new"], x["we"], x["wi"], x["akt"], x["pmn"], x["rmask"],
            x["umask"], x["vmask"], cfg, scheme, 60.0, 0.0, 1.0, True,
            "corr")
    kw = {"stflx": x["stflx"]}
    if name == "corr_mix":
        kw["mix"] = {k: x[k] for k in ("diff2", "pmon_u", "pnom_v")}
    return cfg, args, kw


TRACER_CASES = ("corr_upstream3", "corr_centered4", "corr_akima",
                "pred_nonperiodic", "pred_periodic", "corr_ragged",
                "corr_mix")
SOLVE_CASES = (("drag", {}), ("no_drag", {}), ("drag_ragged", RAGGED))


def compare(got, ref, dtype, periodic, what):
    """Max abs error; raises beyond the dtype's tolerance.  Off a fully
    periodic grid the outermost ghost lines are excluded (the rule of
    tests/test_pallas_tracer.py:_close)."""
    sl = (Ellipsis,) if periodic else (Ellipsis, slice(1, -1), slice(1, -1))
    g = got[sl].double()
    r = ref[sl].double()
    rtol, atol = TOL[dtype]
    if dtype == torch.float32:
        atol = atol * float(r.abs().max())
    err = (g - r).abs()
    bad = err > atol + rtol * r.abs()
    if not torch.isfinite(g).all() or bool(bad.any()):
        raise AssertionError(f"{what}: kernel disagrees with its plain "
                             f"version, max abs err {float(err.max()):.3e}")
    return float(err.max())


def phase_kernels(device):
    from roms_tpu_torch.ops import _harness, cuda_solve, cuda_tracer
    for dtype in (torch.float64, torch.float32):
        tag = str(dtype).replace("torch.", "")
        for name in TRACER_CASES:
            cfg, args, kw = tracer_case(name, dtype, device)
            got = cuda_tracer.tracer_stage(*args, **kw)
            ref = cuda_tracer.tracer_stage_plain(*args, **kw)
            torch.cuda.synchronize()
            err = compare(got, ref, dtype, cfg.fully_periodic,
                          f"tracer_stage {name} {tag}")
            say(f"[2 kernels] tracer_stage {name:17s} {tag}: "
                f"max abs err {err:.3e}")
        for name, shape in SOLVE_CASES:
            cfg, d = _harness.solve_inputs(**shape)
            x = on_card(d, dtype, device)
            args = (x["rhs"], x["hzf"], x["akvf"], x["wif"], x["dc0"], 200.0,
                    x["sstr"], cfg)
            kw = dict(bottom_drag_coeff=None if name == "no_drag" else x["rd"])
            got = cuda_solve.momentum_implicit(*args, **kw)
            ref = cuda_solve.momentum_implicit_plain(*args, **kw)
            torch.cuda.synchronize()
            err = compare(got, ref, dtype, True,
                          f"momentum_solve {name} {tag}")
            say(f"[2 kernels] momentum_solve {name:11s}    {tag}: "
                f"max abs err {err:.3e}")


# ------------------------------------------------------------------ phase 3
def reset_counts():
    from roms_tpu_torch.ops import cuda_solve, cuda_tracer
    cuda_tracer.tracer_stage.launches = 0
    cuda_solve.momentum_implicit.launches = 0


def read_counts():
    from roms_tpu_torch.ops import cuda_solve, cuda_tracer
    return (cuda_tracer.tracer_stage.launches,
            cuda_solve.momentum_implicit.launches)


def check_counts(counts, nsteps, what):
    expected = (2 * nsteps, 4 * nsteps)
    if counts != expected:
        raise AssertionError(f"{what}: kernel launches (tracer, solve) = "
                             f"{counts}, expected {expected}")


def phase_oracle(device):
    from roms_tpu_torch.cases import filament
    from roms_tpu_torch.driver import run
    cfg = filament.config(ntimes=20)
    grid, st, frc = filament.setup(cfg, dtype=torch.float64, device=device)
    reset_counts()
    _, rows = run(grid, st, frc, cfg, nsteps=20)
    torch.cuda.synchronize()
    counts = read_counts()
    check_counts(counts, 20, "oracle run")
    oracle = np.loadtxt(ORACLE)
    if rows.shape != oracle.shape:
        raise AssertionError(f"oracle: {rows.shape} rows vs {oracle.shape}")
    # tolerances of tests/test_filament_regression.py
    if not np.allclose(rows[0, 1:4], oracle[0, 1:4], rtol=1e-11, atol=0):
        raise AssertionError("oracle: step-0 diagnostics deviate")
    worst = {}
    for col, rtol in ((1, 1e-9), (2, 1e-8), (3, 1e-9)):
        rel = np.abs(rows[:, col] - oracle[:, col]) / np.abs(oracle[:, col])
        worst[col] = float(rel.max())
        if not np.all(rel <= rtol):
            raise AssertionError(f"oracle: column {col} max rel err "
                                 f"{worst[col]:.3e} > {rtol}")
    if np.any(rows[:, 4] != 0.0):
        raise AssertionError("oracle: MAX_VERT_CFL must stay zero")
    say(f"[3 oracle] Filament 64x64x32 f64, 20 steps: max rel err "
        f"KE {worst[1]:.3e}, barotropic KE {worst[2]:.3e}, "
        f"CFL {worst[3]:.3e}; launches tracer {counts[0]}, solve "
        f"{counts[1]}")


# ------------------------------------------------------------------ phase 4
def time_ms(fn, reps=20):
    """Median milliseconds of fn() over reps launches, CUDA events."""
    fn()
    torch.cuda.synchronize()
    ts = []
    for _ in range(reps):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        e1.synchronize()
        ts.append(e0.elapsed_time(e1))
    return ts


def kernel_vs_plain(kernel, plain, dtype, reps=20):
    """Both versions on the same inputs: (max abs err, kernel ms, plain
    ms), timed in turns plain, kernel, kernel, plain."""
    got, ref = kernel(), plain()
    torch.cuda.synchronize()
    err = compare(got, ref, dtype, True, kernel.__name__)
    del got, ref
    p1 = time_ms(plain, reps)
    k1 = time_ms(kernel, reps)
    k2 = time_ms(kernel, reps)
    p2 = time_ms(plain, reps)
    return err, float(np.median(k1 + k2)), float(np.median(p1 + p2))


def phase_full_width(device):
    from roms_tpu_torch.cases import filament
    from roms_tpu_torch.driver import run
    from roms_tpu_torch.ops import cuda_solve, cuda_tracer, vmix
    from roms_tpu_torch.ops.kinematics import hz_u
    from roms_tpu_torch.parallel.halo import shift

    nx, ny, nz, warm, nsteps = 512, 256, 60, 2, 10      # bench.py:71-74
    cfg = filament.config().replace(nx=nx, ny=ny, nz=nz)
    grid, st, frc = filament.setup(cfg, dtype=torch.float32, device=device)
    torch.cuda.synchronize()

    clock = {}

    def mark(_, iic):
        # the host clock brackets steps warm+1 .. warm+nsteps
        if iic in (warm, warm + nsteps):
            torch.cuda.synchronize()
            clock[iic] = time.perf_counter()

    reset_counts()
    st, _ = run(grid, st, frc, cfg, nsteps=warm + nsteps,
                collect_diag=False, step_hook=mark)
    wall = clock[warm + nsteps] - clock[warm]
    counts = read_counts()
    check_counts(counts, warm + nsteps, "full-width run")
    for name in ("zeta", "ubar", "vbar", "u", "v", "t", "hz", "rho"):
        if not bool(torch.isfinite(getattr(st, name)).all()):
            raise AssertionError(f"full width: state.{name} is not finite")
    ms = 1e3 * wall / nsteps
    rate = nx * ny * nz * nsteps / wall
    say(f"[4 full width] Filament {nx}x{ny}x{nz} f32: {ms:.3f} ms/step, "
        f"{rate:.6e} gridpoint-steps/s over {nsteps} steps after {warm} "
        f"warm-up; launches tracer {counts[0]}, solve {counts[1]}; "
        f"state finite")

    # each kernel against its plain version at the main path's shapes
    pmn = grid.pm * grid.pn
    tr_args = (st.t, st.t_prev, st.flx_u, st.flx_v, st.hz, st.hz, st.we,
               st.wi, st.akt, pmn, grid.rmask, grid.umask, grid.vmask, cfg,
               cfg.ts_corr_scheme, cfg.dt, 0.0, 1.0, True, "corr")
    tr_kw = dict(stflx=frc.stflx)

    def tracer_stage():
        return cuda_tracer.tracer_stage(*tr_args, **tr_kw)

    def tracer_plain():
        return cuda_tracer.tracer_stage_plain(*tr_args, **tr_kw)

    hzu = hz_u(st.hz)
    rd = vmix.bottom_drag(st.u, st.v, st.hz, cfg)
    dc0 = cfg.dt * 0.25 * (grid.pm + shift(grid.pm, 0, -1)) * (
        grid.pn + shift(grid.pn, 0, -1))
    so_args = (hzu * st.u, hzu, 0.5 * (st.akv + shift(st.akv, 0, -1)),
               0.5 * (st.wi + shift(st.wi, 0, -1)), dc0, cfg.dt, frc.sustr,
               cfg)
    so_kw = dict(bottom_drag_coeff=0.5 * (rd + shift(rd, 0, -1)))

    def momentum_solve():
        return cuda_solve.momentum_implicit(*so_args, **so_kw)

    def solve_plain():
        return cuda_solve.momentum_implicit_plain(*so_args, **so_kw)

    rows = []
    for name, kern, plain, src, repl, launches in (
            ("tracer_stage", tracer_stage, tracer_plain,
             "roms_tpu_torch/csrc/tracer_stage.cu",
             "roms_tpu/ops/pallas_tracer.py:321", counts[0]),
            ("momentum_solve", momentum_solve, solve_plain,
             "roms_tpu_torch/csrc/momentum_solve.cu",
             "roms_tpu/ops/pallas_solve.py:66", counts[1])):
        err, k_ms, p_ms = kernel_vs_plain(kern, plain, torch.float32)
        say(f"[4 full width] {name}: kernel {k_ms:.4f} ms, plain "
            f"{p_ms:.4f} ms (median of 40 CUDA-event launches each), "
            f"max abs err {err:.3e}")
        rows.append({"name": name, "route": "cuda", "source": src,
                     "replaces": repl, "launches": launches,
                     "max_abs_err": err, "ms": k_ms, "plain_ms": p_ms})
    return rows


def main():
    from roms_tpu_torch.ops import _build  # noqa: F401  (fails off the repo)
    device, name = phase_device()
    phase_build()
    phase_kernels(device)
    phase_oracle(device)
    kernels = phase_full_width(device)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
