#!/usr/bin/env python3
"""Smoke run of the PyTorch port (roms_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's four CUDA kernels from the sources in this checkout
and drives its main paths through `roms_tpu_torch.driver.run` (the
real-data cases through `Experiment.run`, the command line through
`roms_tpu_torch.__main__.main`, the rank mesh through
`driver.run_distributed` and `Experiment.run_distributed`), in phases;
each prints its own lines and the first failure raises, so the exit code
is nonzero (the whole script takes about 9 minutes on an H100):

  0. device: a CUDA device is required; prints its name and the
     `nvidia-smi` name/power limit line; TF32 off.
  1. build: nvcc builds the four kernels for sm_90a, one process per
     source, all started together; prints each kernel's registers and
     spills (`-Xptxas -v`) and each kernel's launch configuration and
     occupancy (`cudaOccupancyMaxActiveBlocksPerMultiprocessor`) at the
     production and Filament widths (nz=60, float32).
  2. kernel vs plain: each kernel against its plain PyTorch version on the
     card, on the random-input harnesses of tests/test_pallas_tracer.py,
     tests/test_pallas_solve.py and tests/test_pallas_kpp.py (and the
     momentum r.h.s. on `_harness.uv_rhs_inputs`), in float64
     (rtol = atol = 1e-12) and float32 (rtol 1e-5, atol 1e-5*max|ref|);
     the tracer cases cover all three schemes in both stages, 34 tracers
     at nz=60, the kernel's largest nz, and planes that are not whole
     tiles, and partial edge ownership in both stages as a mesh block
     has it (west and north owned, and east and south); the solve and KPP
     cases cover nz=60, each kernel's largest nz and ragged planes, and
     KPP also partial edge ownership and a grid periodic in i only; the
     momentum r.h.s. both schemes on production's and Filament's flags,
     partial ownership, ragged planes, nz=60 and its largest nz, whole
     arrays (ghost lines included).
  3. oracle: 20 Filament steps at 64x64x32 in float64 against
     tests/data/filament_oracle.txt, tracer and solve kernels launched.
  4. production in float64: bench_production at 48x32x16, nt=4, 3 steps
     on the card (all three kernels launched) against the same 3 steps on
     the CPU (plain versions), atol 5e-11*max(1, max|ref|) per state field
     (1e-8 for the ill-conditioned we, akv, akt): the tolerances
     bench_production.STEP_TOL/CONDITIONED_TOL that
     tests/test_torch_production.py holds the port to.
  5. Filament full width: 512x256x60 float32, 2 warm-up + 10 timed steps,
     all finite; the tracer (corrector and predictor stages), solve and
     momentum r.h.s. kernels timed against their plain versions at that
     shape with CUDA events, with each kernel's achieved TB/s, registers
     and occupancy.
  6. production full width: bench_production at 384x192x60, nt=34,
     float32 (bench.py:66), 2 warm-up + 10 timed steps, all finite, 2 KPP,
     2 tracer and 4 solve launches a step; each kernel timed against its
     plain version at that shape (the tracer in both stages), with each
     kernel's achieved TB/s, registers and occupancy; peak device memory.
     Kernel and plain times are calls as the main path makes them, with
     the host's work before the launch; the kernel's device time alone
     (`time_ms` with `ahead`) and its host time a call are printed beside
     them and carried in the JSON line as device_ms and host_ms.
  7. the reference's default size: bench_production at 920x480x60, nt=34,
     float32, 1 warm-up + 2 timed steps, all finite; peak device memory.
  8. point sources in float64: Rivers_ana and Pipes_ana (100x100x10), 20
     steps through driver.run against tests/data/{rivers,pipes}_ana_oracle
     .txt at the tolerances of tests/test_rivers_regression.py and
     tests/test_pipes_regression.py (round-off on the first steps, then the
     0.5 % / 2 % envelope); the river volume within 5 % of Q*t and the
     land dry.
  9. real data in float64: Flux_frc, Rivers_real and Pipes_real
     (199x99x50, nt=2) built from the USWC inputs that `cases/uswc.py`
     writes into a temporary directory under build/, 20 steps through
     `Experiment.run` against tests/data/{case}_oracle.txt and
     {case}_mass_oracle.txt at the tolerances of
     tests/realcase_utils.py:check_against_oracle.
 10. real data in float32 at the same size: 2 warm-up + 10 timed steps
     each, all finite; ms/step, gridpoint-steps/s, peak device memory and
     the host time a step spends in `forcing_fn` (two-slot interpolation
     and the host-to-device copies); each kernel the case's gates select
     timed against its plain version on the run's final state, as in
     phases 5-6 (with the sponge's diff2 in the fused t3dmix).
 11. biogeochemistry and mCDR in float64: bgc_real (MARBL, nt=34; BEC,
     nt=28), cdr_parameterized, cdr_dp and cdr_3d (199x99x50, bulk
     forcing, tides in bgc_real, rivers), 10 steps each through
     `Experiment.run` against tests/data/{case}_oracle.txt and
     {case}_mass_oracle.txt at the tolerances of phase 9; then cdr_3d
     without rivers, so that the tracer kernel runs: 3 steps with the
     kernel against the same steps with its plain version on the card
     (the tolerances of phase 4, hbbl held with we, akv and akt), and the
     ALK and DIC the release adds against a run without it.
 12. bgc_real (MARBL) and cdr_3d in float32 at 199x99x50: 2 warm-up + 8
     timed steps, as phase 10 (ms/step, peak memory, `forcing_fn`'s host
     ms, each kernel against its plain version); the tracer masses after
     the 10 steps against the float64 mass oracle, the surface pH range
     of the float32 state and its distance from a float64 solve of the
     same surface, and in bgc_real the float32 tidal phase error at the
     start time; then `profile_step` on each: kernels a step, busy share,
     the BGC block's kernels and share, and the batched tracer branch's
     ms at nt=34.
 13. the command line and its output on the card: `__main__.main` in this
     process on the USWC grid and initial files at 199x99x50 f32 (zero
     forcing, closed boundaries), 10 steps with history every 5 and
     restart every 10 through the async writer, every record finite;
     the restart's write and read times, and ms/step with a history
     record every step written in the loop, by the async hook and not at
     all (the host ms a record, and the async file against the
     synchronous one, bitwise); `python -m roms_tpu_torch` as its own
     process, 3 steps; Flux_frc (all three kernels, `forcing_fn`) 6 steps
     against 3 + `write_restart`/`read_restart` + 3: bitwise in float64,
     with no state written into after the hook got it, and in float32 the
     largest relative difference a field with the forcing clock's gap
     (the float32 model time), bitwise again on the unbroken run's clock.
 14. the step's options and the nested workflow: (a) production 48x32x16
     nt=4 in float64, 3 steps on the card against the CPU, with the
     non-hydrostatic projection and the momentum budget (tracer, solve and
     KPP kernels), and with isoneutral mixing, the tracer budget and the
     upscale capture (solve and KPP; the tracer kernel 0 times), every
     state field, budget term and boundary strip at phase 4's tolerances,
     the arrays bench_production.OPTION_CONDITIONED_TOL names for the set
     at 1e-8;
     (b) the nested parent/child flow of tests/test_nested_flow.py
     (cases/nested_basin.py) in float64 on the card: its checks, and its
     numbers against the JAX package's flow (tests/data/
     nested_flow_jax.txt) at rtol 1e-9; (c) production 384x192x60 nt=34
     float32 through `full_width` (1 warm-up + 3 timed steps) with each
     option set: the first with a million particles advanced after every
     step (their ms, the active count, the clamp counters, one
     ParticleWriter record), the last step's res/res0, one projection's
     ms and kernels, the same projection in float64, and the line
     preconditioner's ms and kernels; the second with an UpscaleWriter
     after every step, then `profile_step` for the batched tracer branch
     and the isoneutral pass; ms/step beside phase 6's and peak memory.
 15. the rank mesh on this card (`parallel.dist.launch` spawns the ranks;
     NCCL refuses two ranks of one communicator on one GPU, so the 2x2
     mesh runs gloo ranks on cuda:0, their halo strips staged through
     pinned host memory): (a) NCCL, a world of one: production 48x32x16
     nt=4 f64, 3 steps through `driver.run_distributed` on the 1x1 mesh,
     without options and with phase 14's NH set, every field and row
     bitwise equal to `driver.run` on the card, launches as phase 4; (b)
     2x2 gloo ranks: the same case without options, with the budgets and
     the upscale capture, at 49x33 (padded onto the mesh), with mCDR
     point releases and a 3-argument bulk forcing hook (the releases made
     block-local, the hook reading the gathered surface view), and with
     the NH set at 20 PCG iterations at 48x32 and 49x33 (the projection
     one global PCG over the ranks), 3 steps each against the single
     block on the card (the fields tests/test_distributed.py compares and
     every other array at 1e-12 * max(1, max|ref|), 1e-11 with the
     projection, the conditioned arrays and the strips at 1e-8, the
     tracer budget's terms at 1e-8 of their own largest value, as
     tests/test_torch_dist.py), the last diag row bitwise
     `compute_diag`'s of the gathered state, every rank's launches; the
     distributed particle step bitwise `advance_particles`; (c) Flux_frc
     in f64 through `Experiment.run_distributed`, 20 steps against its
     oracle and mass oracle (phase 9's tolerances); (d) production
     384x192x60 nt=34 f32 on 2x2 ranks, 1 warm-up + 3 timed steps,
     finite: ms/step of the slowest rank, each rank's peak memory in the
     steps and in the global set-up before the block cut, and the host
     ms of one 3D and one 2D exchange; then the same with the NH set:
     ms/step, the last step's res/res0 beside 14c-i's, and one projection
     on each rank's block: its ms, its halo exchanges and all-reduces
     with their ms, and the messages it stages through the host (four
     ranks sharing one card: not a scaling number).
 16. float32 against float64 on the card (`roms_tpu_torch.precision_study.
     study`: the two runs side by side from one setup; the drift of zeta,
     u and temp over the interior relative to the float64 field's max,
     and the relative error of the diagnosed mean KE, at step 1 and every
     10th step): (a) Filament (64x64x32) and Rivers_ana (100x100x10), 50
     steps each, every row held to at most 10x the JAX package's row of
     the same case and step in PRECISION_DATA.json (floor 1e-6; zeta,
     temp and KE, and u for Rivers_ana; Filament's u, near zero at the
     start, printed only); (b) production 384x192x60 nt=34, 20 steps with
     the four kernels, and again with their plain versions put in the
     wrappers' place for that run only: each field's drift at step 20
     with the kernels at most 10x the plain run's (floor 1e-6); the plain
     run launches no kernel.
 17. the fast loop's CUDA graph (`ops/barotropic.py`) against the eager
     loop: the benchmark's two configurations (Filament 512x256x60 and
     production 384x192x60 nt=34, float32), 20 steps with the graph and
     the same 20 with `barotropic._fast_loop_eager` in `fast_loop`'s
     place, every array of the two states bitwise equal (else each one
     that differs is named with its largest gap); `graph_stats`, the host
     ms of a fast_loop call, the ms a step and max_memory_allocated on
     both sides.  Phases 9 (the three USWC cases, 3 steps each), 14a (the
     NH set), 14b (the nested flow) and 16 (Filament and production in
     float64) run the same comparison once on their cases; it runs after
     phase 7.

Every phase that drives a path sets the kernels' launch counts
(`_build.kernel_stats`) to 0 just before it and reads them just after,
in phase 15 on every rank (phase 12's profile excepted: it reads the
device's kernels; phase 16's plain run, held to none), and holds them to
what the configuration's flags select, read as the reference's gates
read them (`expected_counts`): the tracer kernel twice a step without
river sources, the batched branch's options or a mesh block's pad, the
solve four times, KPP twice under LMD_KPP without the pad, the momentum
r.h.s. twice without the pad (once with the momentum budget, whose split
takes the plain version, which `full_width` holds to its count too).
Phase 2 holds every case to one launch.  The line before the last
is a JSON object {"kernels": [...]} whose launches and times come from
phase 6; the last line is {"ok": true, "device": {...}}.  Imports the
port, torch and numpy: nothing of JAX and nothing of the JAX package.
"""

from __future__ import annotations

import dataclasses
import gc
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
ORACLE = os.path.join(HERE, "tests", "data", "filament_oracle.txt")

TOL = {torch.float64: (1e-12, 1e-12), torch.float32: (1e-5, 1e-5)}
STATE = ("zeta", "ubar", "vbar", "u", "v", "t", "hz", "rho")
# how close the ALK and DIC content that cdr_3d's release adds in phase 11
# must come to flx*dt*steps: ALK takes no part in the BGC engine's
# interior rates, so only round-off and the open boundaries take from it
# (-9.7e-11 over the 3 steps on the H100); DIC also feels the change in
# the air-sea CO2 flux that the added ALK and DIC bring at the surface
# (-1.0e-5)
CDR_GAIN_RTOL = {"ALK": 1e-8, "DIC": 1e-4}


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
    say(smi)
    return torch.device("cuda", 0), name, smi


# ------------------------------------------------------------------ phase 1
def phase_build():
    from roms_tpu_torch.ops import _build
    path, secs, log = _build.build()
    _build.library()
    say(f"[1 build] nvcc {secs:.1f} s -> {os.path.relpath(path, HERE)}")
    kernel = None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            kernel = line.split("'")[1]
        elif kernel and ("registers" in line or "spill" in line):
            say(f"[1 build]   {kernel[:60]}: {line.strip()}")
    from roms_tpu_torch.config import AdvScheme
    from roms_tpu_torch.ops import cuda_kpp, cuda_solve, cuda_tracer
    # (width, stage, scheme, t3dmix) of the four tracer launches of a
    # step in phases 5 and 6: both at nz=60 in float32
    for width, stage, scheme, mix in (
            ("production", "corr", AdvScheme.UPSTREAM3, True),
            ("production", "pred", AdvScheme.CENTERED4, False),
            ("filament", "corr", AdvScheme.UPSTREAM3, False),
            ("filament", "pred", AdvScheme.CENTERED4, False)):
        say(f"[1 build]   tracer_stage {width} {stage} f32 nz=60: "
            + occupancy_text(cuda_tracer.occupancy(torch.float32, 60, scheme,
                                                   mix)))
    # the solve runs at both widths, KPP only in the production case
    for width in ("production", "filament"):
        say(f"[1 build]   momentum_solve {width} f32 nz=60: "
            + occupancy_text(cuda_solve.occupancy(torch.float32, 60)))
    say("[1 build]   kpp_vmix production f32 nz=60: "
        + kpp_occupancy_text(cuda_kpp.occupancy(torch.float32, 60)))
    # the momentum r.h.s. predicts with CENTERED4, corrects with UPSTREAM3
    from roms_tpu_torch.ops import cuda_uv_rhs
    for scheme in (AdvScheme.CENTERED4, AdvScheme.UPSTREAM3):
        say(f"[1 build]   uv_rhs {scheme.name} f32 nz=60: " + occupancy_text(
            cuda_uv_rhs.occupancy(torch.float32, 60, scheme)))


def occupancy_text(o):
    shape = f" (32x{o['tile_rows']}x2)" if "tile_rows" in o else ""
    return (f"{o['threads']} threads{shape}, {o['smem']} B "
            f"shared, {o['registers']} registers, {o['stack']} B stack; "
            f"{o['blocks_per_sm']} blocks = {o['warps_per_sm']} warps per SM")


def kpp_occupancy_text(o):
    return "; ".join(f"{name}: {occupancy_text(o[name])}"
                     for name in ("column", "profile"))


# ------------------------------------------------------------------ phase 2
# ragged: ix = 154 = 4 * 32 + 26 leaves a partial 32-column tile (tracer,
# KPP) along i, jy = 33 is a multiple of no tile's rows, and the solve's
# 154 * 33 columns fill no whole number of 32-column blocks
RAGGED = dict(nx=150, ny=29)


def on_card(d, dtype, device):
    return {k: torch.as_tensor(v, dtype=dtype, device=device)
            for k, v in d.items()}


def tracer_case(name, dtype, device):
    """(cfg, positional args, keyword args) of one tracer-stage case on
    the random harness of tests/test_pallas_tracer.py."""
    from roms_tpu_torch.config import AdvScheme
    from roms_tpu_torch.ops import _harness, cuda_tracer
    scheme = {"corr_centered4": AdvScheme.CENTERED4,
              "corr_akima": AdvScheme.AKIMA,
              "pred_nonperiodic": AdvScheme.CENTERED4,
              "pred_periodic": AdvScheme.CENTERED4,
              "pred_akima": AdvScheme.AKIMA}.get(name, AdvScheme.UPSTREAM3)
    shape = {"corr_ragged": RAGGED,
             # 34 tracers at nz=60 on a small plane: the production depth
             "corr_nt34_nz60": dict(nx=40, ny=24, nz=60, nt=34),
             # the kernel's deepest column: its largest shared memory
             "corr_nz_max": dict(nx=20, ny=10, nz=cuda_tracer.NZ_MAX, nt=2),
             # ix = 65 and jy = 27 are whole tiles in neither direction
             "corr_mix_ragged": dict(nx=61, ny=23, seed=4)}.get(name, {})
    cfg, d = _harness.tracer_inputs(periodic=name == "pred_periodic",
                                    **shape)
    x = on_card(d, dtype, device)
    if name.startswith("pred"):
        args = (x["tk"], x["t_sec"], x["flx_u"], x["flx_v"], x["hz_n"],
                x["hz_d"], x["we"], x["wi"], x["akt"], x["pmn"], x["rmask"],
                x["umask"], x["vmask"], cfg, scheme, 50.0,
                0.5 + 1.0 / 6.0, 0.5 - 1.0 / 6.0, False, "pred")
        return cfg, args, ({"own": TRACER_OWN[name]} if name in TRACER_OWN
                           else {})
    args = (x["tk"], x["t_sec"], x["flx_u"], x["flx_v"], x["hz_n"],
            x["hz_new"], x["we"], x["wi"], x["akt"], x["pmn"], x["rmask"],
            x["umask"], x["vmask"], cfg, scheme, 60.0, 0.0, 1.0, True,
            "corr")
    kw = {"stflx": x["stflx"]}
    if name in ("corr_mix", "corr_nt34_nz60", "corr_nz_max",
                "corr_mix_ragged"):
        kw["mix"] = {k: x[k] for k in ("diff2", "pmon_u", "pnom_v")}
    if name in TRACER_OWN:
        kw["own"] = TRACER_OWN[name]
    return cfg, args, kw


def kpp_case(name, first_step, dtype, device):
    """(cfg, positional args) of one vmix update on the random harness of
    tests/test_pallas_kpp.py."""
    from types import SimpleNamespace
    from roms_tpu_torch.ops import _harness, cuda_kpp
    kw = {"salinity": {}, "no_salinity": dict(salinity=False),
          "no_mask": dict(masking=False, seed=3),
          "periodic": dict(ew_periodic=True, ns_periodic=True, seed=5),
          "ragged": RAGGED,
          # the production depth on a small plane
          "nz60": dict(nx=40, ny=24, nz=60, seed=6),
          # the kernel's deepest column: its largest shared memory
          "nz_max": dict(nx=20, ny=10, nz=cuda_kpp.NZ_MAX, seed=7),
          # the halo's fill map on the west and north edges only
          "partial_own": dict(seed=8),
          "ew_periodic": dict(ew_periodic=True, seed=9)}[name]
    own = (True, False, False, True) if name == "partial_own" else \
        (None,) * 4
    cfg, d = _harness.kpp_inputs(**kw)
    x = on_card(d, dtype, device)
    grid = SimpleNamespace(f=x["f"], rmask=x["rmask"], umask=x["umask"],
                           vmask=x["vmask"], own_w=own[0], own_e=own[1],
                           own_s=own[2], own_n=own[3])
    state = SimpleNamespace(swrf=x["swrf"], hbls=x["hbls"], hbbl=x["hbbl"])
    forcing = SimpleNamespace(stflx=x["stflx"], srflx=x["srflx"],
                              sustr=x["sustr"], svstr=x["svstr"])
    return cfg, (state, x["u"], x["v"], x["t"], x["bvf"], x["z_r"],
                 x["z_w"], x["hz"], forcing, grid, cfg, first_step)


# a mesh block's edge ownership (own_w, own_e, own_s, own_n): the edge
# fixes on the west and north edges only, and on the east and south only
TRACER_OWN = {"pred_own_wn": (True, False, False, True),
              "corr_own_wn": (True, False, False, True),
              "pred_own_es": (False, True, True, False),
              "corr_own_es": (False, True, True, False)}
TRACER_CASES = ("corr_upstream3", "corr_centered4", "corr_akima",
                "pred_nonperiodic", "pred_periodic", "corr_ragged",
                "corr_mix", "pred_upstream3", "pred_akima", "corr_nt34_nz60",
                "corr_nz_max", "corr_mix_ragged", *TRACER_OWN)
SOLVE_CASES = (("drag", {}), ("no_drag", {}), ("drag_ragged", RAGGED),
               ("drag_nz60", dict(nz=60)),
               ("drag_nz_max", None))     # the kernel's deepest column
# (name, harness options, edge ownership) of the momentum r.h.s.
UV_CASES = (("production", {}, None),
            ("filament", dict(curvgrid=False, ew_periodic=True,
                              ns_periodic=True), None),
            ("own_wn", dict(seed=2), (True, False, False, True)),
            ("own_es", dict(masking=False, seed=3),
             (False, True, True, False)),
            ("ragged", dict(RAGGED, seed=5), None),
            ("nz60", dict(nx=40, ny=24, nz=60, seed=6), None),
            ("nz_max", dict(nx=20, ny=10, nz=None, seed=7), None))
KPP_CASES = (("salinity", True), ("salinity", False), ("no_salinity", True),
             ("no_salinity", False), ("no_mask", False),
             ("periodic", False), ("ragged", False), ("nz60", False),
             ("nz_max", False), ("partial_own", False),
             ("partial_own", True), ("ew_periodic", False))


def compare(got, ref, dtype, periodic, what, floor=None):
    """Max abs error over a tensor or a tuple of tensors; raises beyond
    the dtype's tolerance.  Off a fully periodic grid the outermost ghost
    lines are excluded (the rule of tests/test_pallas_tracer.py:_close).
    floor: the plain version's own round-off (see `roundoff_floor`); the
    absolute tolerance is at least four times it."""
    if isinstance(got, tuple):
        names = getattr(ref, "_fields", range(len(ref)))
        return max(compare(g, r, dtype, periodic, f"{what}.{n}",
                           None if floor is None else floor[n])
                   for g, r, n in zip(got, ref, names))
    sl = (Ellipsis,) if periodic else (Ellipsis, slice(1, -1), slice(1, -1))
    g = got[sl].double()
    r = ref[sl].double()
    rtol, atol = TOL[dtype]
    if dtype == torch.float32:
        atol = atol * float(r.abs().max())
    if floor is not None:
        atol = max(atol, 4.0 * floor)
    err = (g - r).abs()
    bad = err > atol + rtol * r.abs()
    if not torch.isfinite(g).all() or bool(bad.any()):
        raise AssertionError(f"{what}: kernel disagrees with its plain "
                             f"version, max abs err {float(err.max()):.3e}")
    return float(err.max())


def uv_case(kw, own, dtype, device):
    """(cfg, (u, v, flx_u, flx_v, hz, we), grid) of one momentum r.h.s. on
    `_harness.uv_rhs_inputs` (nz=None: the kernel's largest)."""
    from types import SimpleNamespace
    from roms_tpu_torch.ops import _harness, cuda_uv_rhs
    if kw.get("nz", 0) is None:
        kw = dict(kw, nz=cuda_uv_rhs.NZ_MAX)
    cfg, d = _harness.uv_rhs_inputs(**kw)
    x = on_card(d, dtype, device)
    own = own or (None,) * 4
    grid = SimpleNamespace(**{k: x[k] for k in ("fomn", "dndx", "dmde",
                                                "umask", "vmask")},
                           own_w=own[0], own_e=own[1], own_s=own[2],
                           own_n=own[3])
    return cfg, tuple(x[k] for k in ("u", "v", "flx_u", "flx_v", "hz",
                                     "we")), grid


def phase_kernels(device):
    from roms_tpu_torch.config import AdvScheme
    from roms_tpu_torch.ops import (_harness, cuda_kpp, cuda_solve,
                                    cuda_tracer, cuda_uv_rhs)
    reset_counts()
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
            if shape is None:
                shape = dict(nx=20, ny=10, nz=cuda_solve.NZ_MAX)
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
            say(f"[2 kernels] momentum_solve {name:12s}   {tag}: "
                f"max abs err {err:.3e}")
        for name, first in KPP_CASES:
            cfg, args = kpp_case(name, first, dtype, device)
            got = cuda_kpp.vmix_update(*args)
            ref = cuda_kpp.vmix_update_plain(*args)
            torch.cuda.synchronize()
            # the kernel reproduces the ghost lines too: whole arrays
            err = compare(got, ref, dtype, True,
                          f"kpp_vmix {name} first_step={first} {tag}")
            say(f"[2 kernels] kpp_vmix {name:11s} first_step={first!s:5s} "
                f"{tag}: max abs err {err:.3e}")
        for name, kw, own in UV_CASES:
            for scheme in (AdvScheme.CENTERED4, AdvScheme.UPSTREAM3):
                cfg, args, grid = uv_case(kw, own, dtype, device)
                got = cuda_uv_rhs.uv_rhs(*args, grid, cfg, scheme)
                ref = cuda_uv_rhs.uv_rhs_plain(*args, grid, cfg, scheme)
                torch.cuda.synchronize()
                # the kernel reproduces the ghost lines too: whole arrays
                err = compare(got, ref, dtype, True,
                              f"uv_rhs {name} {scheme.name} {tag}")
                say(f"[2 kernels] uv_rhs {name:8s} {scheme.name:9s} {tag}: "
                    f"max abs err {err:.3e}")
    # every case launched its kernel: none took the plain version
    expected = (2 * len(TRACER_CASES), 2 * len(SOLVE_CASES),
                2 * len(KPP_CASES), 4 * len(UV_CASES))
    if read_counts() != expected:
        raise AssertionError(f"2 kernels: launches (tracer, solve, kpp, "
                             f"uv_rhs) = {read_counts()}, expected "
                             f"{expected}")


# ------------------------------------------------------------------ counts
def reset_counts():
    from roms_tpu_torch.ops import _build
    for stats in _build.kernel_stats.values():
        stats["launches"] = stats["plain"] = 0


def read_counts():
    """Launches of (tracer, solve, kpp, uv_rhs) since the last reset."""
    from roms_tpu_torch.ops import _build
    return tuple(_build.kernel_stats[k]["launches"] for k in _build.KERNELS)


def expected_counts(nsteps, cfg):
    """Launches of (tracer, solve, kpp, uv_rhs) over nsteps, from the
    configuration's flags as the reference's gates read them
    (roms_tpu/ops/pallas_tracer.py:usable, pallas_kpp.py:usable), not
    from the port's gates, which they check: the tracer kernel twice a
    step without river sources, the batched branch's options and a mesh
    block's pad; the solve four times; KPP twice under LMD_KPP without
    the pad; the momentum r.h.s. twice without the pad, once with the
    momentum budget (its split takes the plain version)."""
    pad = bool(cfg.pad_e or cfg.pad_n)
    tracer = not (cfg.river_source or cfg.adv_isoneutral
                  or cfg.upscale_output or cfg.tracer_diagnostics or pad)
    return (2 * nsteps * tracer, 4 * nsteps,
            2 * nsteps * (cfg.lmd_kpp and not pad),
            0 if pad else (2 - int(cfg.uv_diagnostics)) * nsteps)


def uv_rhs_plain_calls(nsteps, cfg):
    """The momentum r.h.s.'s plain calls over nsteps on the card: the
    budget's split, or both calls on a mesh block's padded grid."""
    if cfg.pad_e or cfg.pad_n:
        return 2 * nsteps
    return int(cfg.uv_diagnostics) * nsteps


def check_counts(counts, nsteps, cfg, what):
    expected = expected_counts(nsteps, cfg)
    if counts != expected:
        raise AssertionError(f"{what}: kernel launches (tracer, solve, kpp, "
                             f"uv_rhs) = {counts}, expected {expected}")


def check_finite(st, what):
    for name in STATE:
        if not bool(torch.isfinite(getattr(st, name)).all()):
            raise AssertionError(f"{what}: state.{name} is not finite")


# ------------------------------------------------------------------ phase 3
def phase_oracle(device):
    from roms_tpu_torch.cases import filament
    from roms_tpu_torch.driver import run
    cfg = filament.config(ntimes=20)
    grid, st, frc = filament.setup(cfg, dtype=torch.float64, device=device)
    reset_counts()
    _, rows = run(grid, st, frc, cfg, nsteps=20)
    torch.cuda.synchronize()
    counts = read_counts()
    check_counts(counts, 20, cfg, "oracle run")
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
def phase_production_f64(device):
    from roms_tpu_torch import bridge
    from roms_tpu_torch.cases import bench_production
    from roms_tpu_torch.driver import run
    cfg = bench_production.config(nx=48, ny=32, nz=16, nt=4)
    nsteps = 3
    out = {}
    for where in ("cpu", device):
        grid, st, frc = bench_production.setup(cfg, dtype=torch.float64,
                                               device=where)
        reset_counts()
        st, _ = run(grid, st, frc, cfg, nsteps=nsteps, collect_diag=False)
        if where != "cpu":
            torch.cuda.synchronize()
            counts = read_counts()
            check_counts(counts, nsteps, cfg, "production f64 run")
        out[str(where)] = bridge.to_numpy(st)
    main, text = compare_states(out[str(device)], out["cpu"],
                                "production f64: card vs CPU")
    say(f"[4 production f64] 48x32x16 nt=4, {nsteps} steps, card vs CPU: "
        f"max err / max(1, max|ref|) {main:.3e} over the state, {text}"
        f"; launches tracer {counts[0]}, solve {counts[1]}, "
        f"kpp {counts[2]}")


def compare_states(got, ref, what, loose=None):
    """Every state field of `got` (dicts of numpy arrays) against `ref` at
    atol bench_production.STEP_TOL * max(1, max|ref|), CONDITIONED_TOL (or
    `loose`) for the ill-conditioned we, akv and akt (the bounds that
    tests/test_torch_production.py holds the port to); returns (the worst
    error over the other fields, a text of the conditioned ones)."""
    from roms_tpu_torch.cases import bench_production
    loose = loose or bench_production.CONDITIONED_TOL
    worst = {}
    for name, a in ref.items():
        if a is None or isinstance(a, dict):
            continue
        scale = max(1.0, float(np.abs(a).max()))
        err = float(np.abs(got[name] - a).max()) / scale
        worst[name] = err
        if not np.isfinite(got[name]).all() or \
                err > loose.get(name, bench_production.STEP_TOL):
            raise AssertionError(f"{what}: state.{name} differs by "
                                 f"{err:.3e} * max(1, max|ref|)")
    main = max(v for k, v in worst.items() if k not in loose)
    return main, ", ".join(f"{k} {worst[k]:.3e}" for k in loose)


# ------------------------------------------------------------------ timing
def time_ms(fn, reps=20, ahead=False):
    """(event ms, host ms) of fn() for each of reps launches.  CUDA events
    bracket the call as the main path makes it: with the host's work
    before its first launch, while the device waits.  With `ahead`, the
    device first sleeps for over twice the host's time for one call, so
    the host has issued the whole call before the device reaches the
    first event, and the events bracket the device's work alone.  The host
    ms is the host's clock around fn(), which returns once it has issued
    the call."""
    fn()
    torch.cuda.synchronize()
    cycles = 0
    if ahead:
        t0 = time.perf_counter()
        fn()
        # at most 2e9 cycles a second: a sleep of 4e9 * host seconds plus
        # half a millisecond lasts over twice the host's time
        cycles = int(4e9 * (time.perf_counter() - t0)) + 1_000_000
        torch.cuda.synchronize()
    ts, hs = [], []
    for _ in range(reps):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        if cycles:
            torch.cuda._sleep(cycles)
        e0.record()
        t0 = time.perf_counter()
        fn()
        hs.append(1e3 * (time.perf_counter() - t0))
        e1.record()
        e1.synchronize()
        ts.append(e0.elapsed_time(e1))
    return ts, hs


def promoted(x):
    """x with every floating tensor in float64, dataclasses field by
    field."""
    if isinstance(x, torch.Tensor):
        return x.double() if x.is_floating_point() else x
    if dataclasses.is_dataclass(x):
        return dataclasses.replace(x, **{
            f.name: promoted(getattr(x, f.name))
            for f in dataclasses.fields(x)
            if isinstance(getattr(x, f.name), torch.Tensor)
            or dataclasses.is_dataclass(getattr(x, f.name))})
    return x


def roundoff_floor(plain, args):
    """{field: max |plain(args) - plain(args in float64)|}: how far the
    plain float32 version itself sits from the float64 answer on the same
    inputs."""
    ref32 = plain(*args)
    ref64 = plain(*[promoted(a) for a in args])
    return {n: float((getattr(ref32, n).double() - getattr(ref64, n))
                     .abs().max()) for n in ref32._fields}


def kernel_vs_plain(kernel, plain, dtype, what, reps=20, floor=None):
    """Both versions on the same inputs: (max abs err, kernel ms, plain
    ms, kernel device ms, kernel host ms), medians of launches timed in
    turns plain, kernel, kernel, plain (`time_ms`).  Kernel and plain ms
    are calls as the main path makes them, the host's work included; the
    kernel's device ms brackets its device work alone, timed after each
    kernel turn; its host ms is the host's time to issue one call.  The
    kernel reproduces every point, so whole arrays are compared."""
    got, ref = kernel(), plain()
    torch.cuda.synchronize()
    err = compare(got, ref, dtype, True, what, floor)
    del got, ref
    p1, _ = time_ms(plain, reps)
    k1, h1 = time_ms(kernel, reps)
    d1, _ = time_ms(kernel, reps, ahead=True)
    k2, h2 = time_ms(kernel, reps)
    d2, _ = time_ms(kernel, reps, ahead=True)
    p2, _ = time_ms(plain, reps)
    return (err, float(np.median(k1 + k2)), float(np.median(p1 + p2)),
            float(np.median(d1 + d2)), float(np.median(h1 + h2)))


def kernel_timings(grid, st, frc, cfg, what, counts):
    """Each kernel of the step against its plain version on the state of a
    full-width run, at the main path's shapes, with the t3dmix inputs the
    corrector reads (`stepper.tracer_mix`); returns the JSON rows of the
    kernels the configuration's gates select.  counts: launches of
    (tracer, solve, KPP, momentum r.h.s.) in the run.  Each row's bound is
    the larger of the call's compulsory bytes (each distinct input read
    once, each output written once) over the card's memory rate and a
    lower count of its arithmetic over its peak rate
    (`bench_h100.peaks.bound_s`)."""
    from bench_h100 import peaks
    from roms_tpu_torch.ops import (_build, cuda_kpp, cuda_solve,
                                    cuda_tracer, cuda_uv_rhs, eos, vmix)
    from roms_tpu_torch.ops.kinematics import hz_u
    from roms_tpu_torch.parallel.halo import shift
    from roms_tpu_torch.stepper import AM3_CRV, tracer_mix
    dtype = st.t.dtype
    nt, nz, jy, ix = st.t.shape
    col = jy * ix
    elem = st.t.element_size()
    plane = col * elem
    rows = []
    pmn = grid.pm * grid.pn
    mix = tracer_mix(grid, cfg, st.t)
    # the corrector reads Hz(n) and a distinct Hz(n+1), as the main path
    # does (stepper.py, the corrector's tracer_stage call)
    gen = torch.Generator(device=st.hz.device).manual_seed(0)
    hz_new = st.hz * (1.0 + 1e-3 * torch.rand(st.hz.shape, generator=gen,
                                               device=st.hz.device,
                                               dtype=dtype))
    tr_args = (st.t, st.t_prev, st.flx_u, st.flx_v, st.hz, hz_new, st.we,
               st.wi, st.akt, pmn, grid.rmask, grid.umask, grid.vmask, cfg,
               cfg.ts_corr_scheme, cfg.dt, 0.0, 1.0, True, "corr")
    tr_kw = dict(stflx=frc.stflx, mix=mix)

    def tracer_bytes(args, kw):
        """A stage's inputs, Akt's used rows alone, and its output."""
        reads = (*args[:8], args[8][:max(cfg.i_t_and_s, 1)], *args[9:13],
                 kw.get("stflx"), *(kw.get("mix") or {}).values())
        return _build.compulsory_bytes(reads, ()) + nt * nz * plane
    # the predictor's inputs as the main path builds them (stepper.py,
    # pre_step3d after the first step)
    dtau_p = cfg.dt * (1.0 - AM3_CRV)
    flx_div = 0.5 * dtau_p * pmn[None] * (
        shift(st.flx_u, 0, 1) - st.flx_u + shift(st.flx_v, 1, 0) - st.flx_v
        + (st.we[1:] + st.wi[1:]) - (st.we[:-1] + st.wi[:-1]))
    pr_args = (st.t, st.t_prev, st.flx_u, st.flx_v, st.hz, flx_div, st.we,
               st.wi, st.akt, pmn, grid.rmask, grid.umask, grid.vmask, cfg,
               cfg.ts_pred_scheme, dtau_p, 0.5 + AM3_CRV, 0.5 - AM3_CRV,
               False, "pred")
    # lower count of arithmetic per (tracer, level, column): flux,
    # divergence, spline and Thomas sweeps
    tr_ops = 40 * nt * nz * col
    occ = {"momentum_solve": cuda_solve.occupancy(dtype, nz)}
    tr_occ = {"corr": cuda_tracer.occupancy(dtype, nz, cfg.ts_corr_scheme,
                                            mix is not None),
              "pred": cuda_tracer.occupancy(dtype, nz, cfg.ts_pred_scheme,
                                            False)}

    hzu = hz_u(st.hz)
    rd = vmix.bottom_drag(st.u, st.v, st.hz, cfg)
    dc0 = cfg.dt * 0.25 * (grid.pm + shift(grid.pm, 0, -1)) * (
        grid.pn + shift(grid.pn, 0, -1))
    so_args = (hzu * st.u, hzu, 0.5 * (st.akv + shift(st.akv, 0, -1)),
               0.5 * (st.wi + shift(st.wi, 0, -1)), dc0, cfg.dt, frc.sustr,
               cfg)
    so_kw = dict(bottom_drag_coeff=0.5 * (rd + shift(rd, 0, -1)))
    so_ops = 10 * nz * col
    so_bytes = _build.compulsory_bytes(
        (*so_args[:5], so_args[6], so_kw["bottom_drag_coeff"]), ()) \
        + nz * plane

    cases = [("momentum_solve", cuda_solve.momentum_implicit,
              cuda_solve.momentum_implicit_plain, so_args, so_kw, so_ops,
              so_bytes, "roms_tpu_torch/csrc/momentum_solve.cu",
              "roms_tpu/ops/pallas_solve.py:66", counts[1])]
    if cuda_uv_rhs.usable(cfg):
        # the corrector's call (UPSTREAM3) and the predictor's (CENTERED4)
        # on the run's final state; lower count of arithmetic per (level,
        # column): both components' fluxes, Coriolis and spline sweeps
        uv_ops = 150 * nz * col
        uv_bytes = _build.compulsory_bytes(
            (st.u, st.v, st.flx_u, st.flx_v, st.hz, st.we, grid.fomn)
            + ((grid.dndx, grid.dmde) if cfg.curvgrid and cfg.uv_adv else ())
            + ((grid.umask, grid.vmask) if cfg.masking and cfg.uv_adv
               else ()), ()) + 2 * nz * plane
        for tag, scheme in (("", cfg.uv_corr_scheme),
                            ("_pred", cfg.uv_pred_scheme)):
            occ["uv_rhs" + tag] = cuda_uv_rhs.occupancy(dtype, nz, scheme)
            cases.append((
                "uv_rhs" + tag, cuda_uv_rhs.uv_rhs, cuda_uv_rhs.uv_rhs_plain,
                (st.u, st.v, st.flx_u, st.flx_v, st.hz, st.we, grid, cfg,
                 scheme), {}, uv_ops, uv_bytes,
                "roms_tpu_torch/csrc/uv_rhs.cu",
                "none (roms_tpu/stepper.py:_uv_rhs, XLA)", counts[3]))
    if cuda_tracer.usable(cfg):
        # both tracer rows are the one kernel and its one launch count
        cases[:0] = [("tracer_stage", cuda_tracer.tracer_stage,
                      cuda_tracer.tracer_stage_plain, tr_args, tr_kw, tr_ops,
                      tracer_bytes(tr_args, tr_kw),
                      "roms_tpu_torch/csrc/tracer_stage.cu",
                      "roms_tpu/ops/pallas_tracer.py:321", counts[0]),
                     ("tracer_stage_pred", cuda_tracer.tracer_stage,
                      cuda_tracer.tracer_stage_plain, pr_args, {}, tr_ops,
                      tracer_bytes(pr_args, {}),
                      "roms_tpu_torch/csrc/tracer_stage.cu",
                      "roms_tpu/ops/pallas_tracer.py:321", counts[0])]
    if cfg.lmd_kpp:
        bvf = eos.rho_eos(st.t, st.z_r, st.z_w, st.hz, grid.rmask, cfg,
                          need_bvf=True).bvf
        kp_args = (st, st.u, st.v, st.t, bvf, st.z_r, st.z_w, st.hz, frc,
                   grid, cfg, False)
        # lower count per (level, column): Ri, smoother, wscale, profiles
        kp_ops = 100 * nz * col
        occ["kpp_vmix"] = cuda_kpp.occupancy(dtype, nz)
        # the kernel reads the surface level of T and S alone
        kp_bytes = cuda_kpp.launch_bytes(nz, jy, ix, elem, cfg.salinity,
                                         cfg.masking)
        cases.append(("kpp_vmix", cuda_kpp.vmix_update,
                      cuda_kpp.vmix_update_plain, kp_args, {}, kp_ops,
                      kp_bytes, "roms_tpu_torch/csrc/kpp_vmix.cu",
                      "roms_tpu/ops/pallas_kpp.py:445", counts[2]))
    for name, kern, plain, args, kw, ops, nbytes, src, repl, launches in \
            cases:
        def k(kern=kern, args=args, kw=kw):
            return kern(*args, **kw)

        def p(plain=plain, args=args, kw=kw):
            return plain(*args, **kw)

        floor, note = None, ""
        if name == "kpp_vmix" and dtype == torch.float32:
            # the Richardson number divides by the square of a shear that
            # is a small difference of nearly equal velocities, so float32
            # round-off in either version is amplified: the tolerance
            # grows to four times the plain version's own distance from
            # float64 on these inputs
            floor = roundoff_floor(plain, args)
            note = (", plain f32 vs f64 " + ", ".join(
                f"{n} {v:.3e}" for n, v in floor.items()))
        err, k_ms, p_ms, dev_ms, host_ms = kernel_vs_plain(
            k, p, dtype, f"{what} {name}", floor=floor)
        b_s, b_by = peaks.bound_s(ops, nbytes, elem)
        b_ms = 1e3 * b_s
        note += (f"; {nbytes / 1e9:.4f} GB compulsory at "
                 f"{nbytes / k_ms / 1e9:.4f} TB/s a call, "
                 f"{nbytes / dev_ms / 1e9:.4f} TB/s on the device; ")
        if name.startswith("tracer_stage"):
            note += occupancy_text(
                tr_occ["pred" if name.endswith("pred") else "corr"])
        elif name == "kpp_vmix":
            note += kpp_occupancy_text(occ[name])
        else:
            note += occupancy_text(occ[name])
        say(f"[{what}] {name}: kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms "
            f"(calls, medians of 40 CUDA-event launches each), kernel "
            f"device {dev_ms:.4f} ms, host {host_ms:.4f} ms a call, bound "
            f"{b_ms:.4f} ms ({b_by}), max abs err {err:.3e}{note}")
        rows.append({"name": name, "route": "cuda", "source": src,
                     "replaces": repl, "launches": launches,
                     "max_abs_err": err, "ms": k_ms, "plain_ms": p_ms,
                     "bound_ms": b_ms, "bound_by": b_by,
                     "library_ms": None, "device_ms": dev_ms,
                     "host_ms": host_ms})
    return rows


def analytic(case, cfg, device):
    """A start for `full_width`: `case.setup` in float32 as an Experiment
    with no forcing files."""
    from roms_tpu_torch.experiment import Experiment

    def start():
        grid, st, frc = case.setup(cfg, dtype=torch.float32, device=device)
        return Experiment(cfg=cfg, grid=grid, state=st, forcing0=frc,
                          forcing_fn=None, rc=None)
    return start


# ms/step of each full_width run of this call, by its tag
MS_PER_STEP = {}


def full_width(start, warm, nsteps, what, timings, hook=None):
    """Drive the Experiment that `start()` returns through Experiment.run:
    warm-up steps, then timed steps between two synchronizes; checks
    finiteness and the launch counts; prints the host time a step spent
    in `forcing_fn` where the run has one; `hook(state, iic)`, where
    given, runs after every step, inside the timed window for the timed
    steps; returns (the kernels' JSON rows with `timings`, else None; the
    final state; the experiment)."""
    gc.collect()        # an earlier phase's tensors held by reference cycles
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    exp = start()
    cfg = exp.cfg
    torch.cuda.synchronize()
    clock, spent, last = {}, [], [exp.forcing0]

    def mark(st, iic):
        if hook is not None:
            hook(st, iic)
        # the host clock brackets steps warm+1 .. warm+nsteps
        if iic in (warm, warm + nsteps):
            torch.cuda.synchronize()
            clock[iic] = time.perf_counter()

    if exp.forcing_fn is not None:
        from roms_tpu_torch.driver import _call_forcing_fn
        fn = exp.forcing_fn

        def forcing_fn(t, base, state):
            # the device is drained first, so the host clock holds the
            # interpolation, the bulk fluxes and the host-to-device copies
            # alone (each copy from pageable memory waits for the stream
            # anyway)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            last[0] = _call_forcing_fn(fn, t, base, state)
            spent.append(time.perf_counter() - t0)
            return last[0]
        exp.forcing_fn = forcing_fn
    from roms_tpu_torch.ops import _build
    try:
        reset_counts()
        st, _ = exp.run(nsteps=warm + nsteps, collect_diag=False,
                        step_hook=mark)
        torch.cuda.synchronize()
        counts = read_counts()
        uv_plain = _build.kernel_stats["uv_rhs"]["plain"]
    finally:
        if exp.fileset is not None:
            exp.fileset.close()
    check_counts(counts, warm + nsteps, cfg, what)
    if uv_plain != uv_rhs_plain_calls(warm + nsteps, cfg):
        raise AssertionError(f"{what}: uv_rhs plain calls {uv_plain}, "
                             f"expected "
                             f"{uv_rhs_plain_calls(warm + nsteps, cfg)}")
    check_finite(st, what)
    wall = clock[warm + nsteps] - clock[warm]
    peak = torch.cuda.max_memory_allocated() / 2**30
    MS_PER_STEP[what] = 1e3 * wall / nsteps
    frc = ""
    if spent:
        frc_s = sum(spent[warm:warm + nsteps])
        frc = (f"forcing_fn {1e3 * frc_s / nsteps:.3f} ms/step on the host "
               f"({frc_s / wall:.4f} of the step); ")
    say(f"[{what}] {cfg.nx}x{cfg.ny}x{cfg.nz} nt={cfg.nt} f32: "
        f"{1e3 * wall / nsteps:.3f} ms/step, "
        f"{cfg.nx * cfg.ny * cfg.nz * nsteps / wall:.6e} gridpoint-steps/s "
        f"over {nsteps} steps after {warm} warm-up; {frc}launches tracer "
        f"{counts[0]}, solve {counts[1]}, kpp {counts[2]}, uv_rhs "
        f"{counts[3]} (plain calls {uv_plain}); state finite; "
        f"peak device memory {peak:.3f} GiB")
    # the kernels are timed on the forcing of the last step
    rows = kernel_timings(exp.grid, st, last[0], cfg, what,
                          counts) if timings else None
    return rows, st, exp


# ------------------------------------------------------------ phases 5-7
def phase_filament_full_width(device):
    from roms_tpu_torch.cases import filament
    cfg = filament.config().replace(nx=512, ny=256, nz=60)  # bench.py:71-74
    full_width(analytic(filament, cfg, device), 2, 10, "5 filament", True)


def phase_production_full_width(device):
    from roms_tpu_torch.cases import bench_production
    cfg = bench_production.config(nx=384, ny=192, nz=60, nt=34)  # bench.py:66
    return full_width(analytic(bench_production, cfg, device), 2, 10,
                      "6 production", True)[0]


def phase_reference_size(device):
    from roms_tpu_torch.cases import bench_production
    cfg = bench_production.config(nx=920, ny=480, nz=60, nt=34)
    full_width(analytic(bench_production, cfg, device), 1, 2,
               "7 production 920", False)


# ----------------------------------------------------------------- phase 17
def _compared(x, path="state"):
    """(path, value) of every tensor, numpy array and number in a state,
    dict, tuple or list, depth first."""
    if isinstance(x, (torch.Tensor, np.ndarray, int, float)):
        yield path, x
    elif dataclasses.is_dataclass(x):
        for f in dataclasses.fields(x):
            yield from _compared(getattr(x, f.name), f"{path}.{f.name}")
    elif isinstance(x, dict):
        for k, v in x.items():
            yield from _compared(v, f"{path}[{k!r}]")
    elif isinstance(x, (tuple, list)):
        for i, v in enumerate(x):
            yield from _compared(v, f"{path}[{i}]")


def _gap(a, b):
    """The largest |a - b| of two equal-shaped arrays or numbers."""
    if isinstance(a, torch.Tensor):
        return float((a.double() - b.double()).abs().max())
    return float(np.max(np.abs(np.asarray(a, np.float64)
                               - np.asarray(b, np.float64))))


def graph_against_eager(what, make_run, nsteps=None):
    """`make_run(hook)` runs a case from a fresh start (with `hook` as its
    step hook where it takes one) and returns what to compare; it runs
    once with the fast loop's CUDA graph and once with
    `barotropic._fast_loop_eager` in `fast_loop`'s place.  Every tensor,
    array and number of the two results must be bitwise equal; else this
    raises naming each one that differs and its largest gap.  Prints
    `graph_stats` of the graph's run, the host ms of a fast_loop call on
    both sides (median; the graph's first call, its capture, apart), the
    wall ms a step after the first where `nsteps` is given, and on both
    sides max_memory_allocated above what was allocated before the run.
    Returns {side: numbers}."""
    from roms_tpu_torch.ops import barotropic as bt
    loop = bt.fast_loop
    sides, results = {}, {}
    for side, fn in (("graph", loop), ("eager", bt._fast_loop_eager)):
        host, clock = [], {}

        def timed(*a, _fn=fn, **k):
            t0 = time.perf_counter()
            out = _fn(*a, **k)
            host.append(time.perf_counter() - t0)
            return out

        def hook(st, iic):
            if iic in (1, nsteps):
                torch.cuda.synchronize()
                clock[iic] = time.perf_counter()
        bt._graphs.clear()
        for k in bt.graph_stats:
            bt.graph_stats[k] = 0
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()   # the other side's result
        bt.fast_loop = timed
        try:
            results[side] = make_run(hook)
            torch.cuda.synchronize()
        finally:
            bt.fast_loop = loop
        rest = host[1:] if side == "graph" else host
        sides[side] = {
            "stats": dict(bt.graph_stats), "calls": len(host),
            "first_ms": 1e3 * host[0],
            "host_ms": 1e3 * float(np.median(rest)) if rest else None,
            "step_ms": (1e3 * (clock[nsteps] - clock[1]) / (nsteps - 1)
                        if nsteps and len(clock) == 2 else None),
            "peak_gib": (torch.cuda.max_memory_allocated() - held) / 2**30}
    got = list(_compared(results["graph"]))
    ref = list(_compared(results["eager"]))
    if [p for p, _ in got] != [p for p, _ in ref]:
        raise AssertionError(f"[{what}] graph and eager runs returned "
                             "different structures")
    bad = [(p, _gap(a, b)) for (p, a), (_, b) in zip(got, ref)
           if not (torch.equal(a, b) if isinstance(a, torch.Tensor)
                   else np.array_equal(a, b))]
    g, e = sides["graph"], sides["eager"]
    if g["stats"]["captures"] < 1 or g["stats"]["eager"]:
        raise AssertionError(f"[{what}] the graph was not taken: "
                             f"{g['stats']}")
    if bad:
        raise AssertionError(
            f"[{what}] graph against eager: {len(bad)} of {len(got)} "
            "differ: " + ", ".join(f"{p} largest gap {d:.3e}"
                                   for p, d in bad[:8]))

    def ms(x):
        return "-" if x is None else f"{x:.3f}"
    say(f"[{what}] fast-loop graph against eager: {len(got)} arrays bitwise "
        f"equal; graph_stats {g['stats']}; host ms a fast_loop call "
        f"{ms(g['host_ms'])} (capture call {g['first_ms']:.1f}) / "
        f"{ms(e['host_ms'])}; ms a step {ms(g['step_ms'])} / "
        f"{ms(e['step_ms'])}; max_memory_allocated above the start "
        f"{g['peak_gib']:.4f} / {e['peak_gib']:.4f} GiB")
    return sides


def phase_graph(device, nsteps=20):
    """17: the benchmark's two configurations (Filament 512x256x60 and
    production 384x192x60 nt=34, float32) for `nsteps` steps with the fast
    loop's graph and again eager, bitwise."""
    from roms_tpu_torch.cases import bench_production, filament
    for name, case, cfg in (
            ("filament", filament,
             filament.config().replace(nx=512, ny=256, nz=60)),
            ("production", bench_production,
             bench_production.config(nx=384, ny=192, nz=60, nt=34))):
        def make_run(hook, case=case, cfg=cfg):
            exp = analytic(case, cfg, device)()
            return exp.run(nsteps=nsteps, collect_diag=False,
                           step_hook=hook)[0]
        graph_against_eager(f"17 graph {name} {nsteps} steps", make_run,
                            nsteps)


# ------------------------------------------------------------------ phase 8
DATA = os.path.join(HERE, "tests", "data")
# tolerances of tests/test_rivers_regression.py and
# tests/test_pipes_regression.py: (rtol of row 1 columns 3-4, rtol of row 2
# columns 1-4, envelope of every later row); Pipes_ana also holds row 0's
# columns 3-4 at 1e-11, Rivers_ana requires row 0 to be exactly zero
POINT_TOL = {"rivers_ana": (1e-9, 1e-4, 5e-3),
             "pipes_ana": (1e-9, 1e-5, 2e-2)}


def worst_rel(rows, oracle, cols=(1, 2, 3, 4)):
    """{column: max relative deviation from the oracle where it is not 0}."""
    out = {}
    for col in cols:
        sel = oracle[:, col] != 0.0
        out[col] = float((np.abs(rows[sel, col] - oracle[sel, col])
                          / np.abs(oracle[sel, col])).max())
    return out


def phase_point_sources(device):
    from roms_tpu_torch.cases import pipes_ana, rivers_ana
    from roms_tpu_torch.driver import run
    for name, case in (("rivers_ana", rivers_ana), ("pipes_ana", pipes_ana)):
        cfg = case.config(ntimes=20)
        grid, st, frc = case.setup(cfg, dtype=torch.float64, device=device)
        reset_counts()
        st, rows = run(grid, st, frc, cfg, nsteps=20)
        torch.cuda.synchronize()
        counts = read_counts()
        check_counts(counts, 20, cfg, f"8 {name}")
        oracle = np.loadtxt(os.path.join(DATA, f"{name}_oracle.txt"))
        if rows.shape != oracle.shape:
            raise AssertionError(f"{name}: {rows.shape} rows vs "
                                 f"{oracle.shape}")
        r1, r2, env = POINT_TOL[name]
        if name == "rivers_ana":
            ok0 = np.all(rows[0][1:] == 0.0)
        else:
            ok0 = np.allclose(rows[0][3:5], oracle[0][3:5], rtol=1e-11,
                              atol=0)
        if not (ok0 and np.allclose(rows[1][3:5], oracle[1][3:5], rtol=r1,
                                    atol=0)
                and np.allclose(rows[2][1:5], oracle[2][1:5], rtol=r2,
                                atol=0)):
            raise AssertionError(f"{name}: the first steps deviate from "
                                 f"the oracle beyond round-off")
        worst = worst_rel(rows, oracle)
        if max(worst.values()) >= env:
            raise AssertionError(f"{name}: max rel deviation {worst} "
                                 f"outside the {env} envelope")
        note = ""
        if name == "rivers_ana":
            h = cfg.halo
            zeta = st.zeta[h:-h, h:-h]
            da = (grid.rmask / (grid.pm * grid.pn))[h:-h, h:-h]
            vol = float(torch.sum(zeta * da))
            expected = rivers_ana.RIV_VOL * cfg.dt * 20
            land = grid.rmask[h:-h, h:-h] == 0.0
            if abs(vol - expected) / expected >= 0.05:
                raise AssertionError(f"rivers_ana: volume {vol:.6e} m^3 vs "
                                     f"Q*t {expected:.6e}")
            if bool((zeta[land] != 0.0).any()) or \
                    not bool(torch.isfinite(st.t).all()):
                raise AssertionError("rivers_ana: land not dry or t not "
                                     "finite")
            note = (f"; volume {vol:.6e} m^3 vs Q*t {expected:.6e} "
                    f"({vol / expected - 1.0:+.3e}), land dry")
        say(f"[8 point sources] {name} 100x100x10 f64, 20 steps vs "
            f"tests/data/{name}_oracle.txt: max rel dev KE "
            f"{worst[1]:.3e}, barotropic KE {worst[2]:.3e}, CFL "
            f"{worst[3]:.3e}, vertical CFL {worst[4]:.3e} (envelope {env})"
            f"{note}; launches tracer {counts[0]}, solve {counts[1]}, "
            f"kpp {counts[2]}")


# ------------------------------------------------------------ phases 9-10
# tests/realcase_utils.py:check_against_oracle: per-column rtol, and 1e-9
# on the final tracer masses
REAL_RTOL = (1e-9, 1e-8, 1e-9, 1e-8)
REAL_CASES = ("flux_frc", "rivers_real", "pipes_real")


def tracer_masses(st, grid):
    """Interior content sum(t * Hz * rmask / (pm*pn)) per tracer, in
    float64 on the host, as tests/realcase_utils.py:tracer_masses."""
    t = st.t.double().cpu().numpy()[..., 2:-2, 2:-2]
    hz = st.hz.double().cpu().numpy()[..., 2:-2, 2:-2]
    rmask = grid.rmask.double().cpu().numpy()[2:-2, 2:-2]
    da = (1.0 / (grid.pm * grid.pn)).double().cpu().numpy()[2:-2, 2:-2]
    t = np.where((rmask > 0.0)[None, None], t, 0.0)
    hz = np.where((rmask > 0.0)[None], hz, 0.0)
    return (t * hz[None] * (rmask * da)[None, None]).sum(axis=(1, 2, 3))


def real_case(name):
    import importlib
    return importlib.import_module(f"roms_tpu_torch.cases.{name}")


def real_f64(device, workdir, name, module, nsteps, tag, **kw):
    """One real-data case in float64 on the card, `nsteps` steps through
    Experiment.run against tests/data/{name}_oracle.txt and
    {name}_mass_oracle.txt (check_against_oracle's tolerances); returns
    the experiment."""
    exp = real_case(module).build(workdir, ntimes=nsteps,
                                  dtype=torch.float64, device=device, **kw)
    try:
        reset_counts()
        st, rows = exp.run(nsteps=nsteps)
        torch.cuda.synchronize()
        counts = read_counts()
    finally:
        exp.fileset.close()
    check_counts(counts, nsteps, exp.cfg, f"{tag} {name}")
    oracle = np.loadtxt(os.path.join(DATA, f"{name}_oracle.txt"))
    if rows.shape != oracle.shape:
        raise AssertionError(f"{name}: {rows.shape} rows vs {oracle.shape}")
    worst = worst_rel(rows, oracle)
    for col, rtol in zip((1, 2, 3, 4), REAL_RTOL):
        if not (np.allclose(rows[:, col], oracle[:, col], rtol=rtol,
                            atol=1e-300)
                and np.isclose(rows[:, col].sum(), oracle[:, col].sum(),
                               rtol=rtol)):
            raise AssertionError(f"{name}: column {col} max rel dev "
                                 f"{worst[col]:.3e} > {rtol}")
    masses = tracer_masses(st, exp.grid)
    m_rel, m_text = check_masses(name, masses, exp.cfg)
    cfg = exp.cfg
    say(f"[{tag}] {name} {cfg.nx}x{cfg.ny}x{cfg.nz} nt={cfg.nt} f64, "
        f"{nsteps} steps vs tests/data/{name}_oracle.txt: max rel dev KE "
        f"{worst[1]:.3e}, barotropic KE {worst[2]:.3e}, CFL {worst[3]:.3e}, "
        f"vertical CFL {worst[4]:.3e} (rtol {REAL_RTOL}), tracer masses "
        f"{m_rel:.3e} (1e-9){m_text}; launches tracer {counts[0]}, solve "
        f"{counts[1]}, kpp {counts[2]}")
    return exp


# the tracers whose mass oracle the mCDR cases froze before the full
# carbonate solver took over the air-sea CO2 flux: the JAX package's own
# run misses them (by 1.9e-7 in cdr_parameterized); tests/data/
# {case}_mass_jax.txt holds what it computes now (tests/jax_cdr_masses.py)
STALE_MASS = ("DIC", "DIC_ALT_CO2")


def check_masses(name, masses, cfg):
    """The final tracer masses against {name}_mass_oracle.txt at rtol
    1e-9; where {name}_mass_jax.txt exists, every tracer against it and
    the STALE_MASS tracers against it alone.  Returns (the largest
    deviation held, a note on the JAX package's masses)."""
    m_oracle = np.atleast_1d(np.loadtxt(
        os.path.join(DATA, f"{name}_mass_oracle.txt")))
    held = np.ones(masses.shape, bool)
    note = ""
    jax_path = os.path.join(DATA, f"{name}_mass_jax.txt")
    if os.path.exists(jax_path):
        from roms_tpu_torch.bgc.api import get_model
        names = [n.upper() for n in ("temp", "salt")
                 + tuple(get_model(cfg.bgc_model).tracer_names)]
        held[[names.index(n) for n in STALE_MASS]] = False
        m_jax = np.loadtxt(jax_path)
        j_dev = np.abs(masses - m_jax) / np.abs(m_jax)
        if not j_dev.max() <= 1e-9:
            raise AssertionError(f"{name}: tracer masses max rel dev "
                                 f"{j_dev.max():.3e} > 1e-9 from the JAX "
                                 f"package's (tracer {int(j_dev.argmax())})")
        stale = np.abs(masses - m_oracle)[~held] / np.abs(m_oracle[~held])
        note = (f", against the JAX package's own {j_dev.max():.3e} (1e-9; "
                f"{'/'.join(STALE_MASS)} {stale.max():.3e} from the stale "
                f"oracle)")
    m_dev = np.abs(masses - m_oracle) / np.abs(m_oracle)
    if not m_dev[held].max() <= 1e-9:
        raise AssertionError(f"{name}: tracer masses max rel dev "
                             f"{m_dev[held].max():.3e} > 1e-9 (by tracer "
                             + " ".join(f"{x:.1e}" for x in m_dev) + ")")
    return float(m_dev[held].max()), note


def phase_real_f64(device, workdir, nsteps=3):
    for name in REAL_CASES:
        real_f64(device, workdir, name, name, 20, "9 real data")
    for name in REAL_CASES:
        def make_run(hook, name=name):
            exp = real_case(name).build(workdir, ntimes=nsteps,
                                        dtype=torch.float64, device=device)
            try:
                return exp.run(nsteps=nsteps, step_hook=hook)
            finally:
                exp.fileset.close()
        graph_against_eager(f"9 {name} f64 {nsteps} steps", make_run)


def phase_real_f32(device, workdir, warm=2, nsteps=10):
    for name in REAL_CASES:
        def start(name=name):
            return real_case(name).build(workdir, ntimes=warm + nsteps,
                                         dtype=torch.float32, device=device)
        full_width(start, warm, nsteps, f"10 {name}", True)


# ------------------------------------------------------------ phases 11-12
# (oracle name, case module, build keywords); the oracles run 10 steps
BGC_CASES = (("bgc_real", "bgc_real", {"variant": "marbl"}),
             ("bgc_real_bec", "bgc_real", {"variant": "bec"}),
             ("cdr_parameterized", "cdr_parameterized", {}),
             ("cdr_dp", "cdr_dp", {}),
             ("cdr_3d", "cdr_3d", {}))
BGC_F32 = ("bgc_real", "cdr_3d")
BGC_STEPS = 10


def phase_bgc_f64(device, workdir):
    """The five oracle cases, then cdr_3d without rivers on the tracer
    kernel's path; returns the f64 bgc_real experiment (its tides and
    start time are phase 12's reference)."""
    out = {}
    for name, module, kw in BGC_CASES:
        out[name] = real_f64(device, case_dir(workdir, name), name, module,
                             BGC_STEPS, "11 bgc f64", **kw)
    phase_cdr_kernel_path(device, case_dir(workdir, "cdr_3d"))
    return out["bgc_real"]


def case_dir(workdir, name):
    """A directory of its own for each BGC case's inputs: the generator
    keeps one set of files a directory, and the BEC variant's tracer
    names are not MARBL's."""
    path = os.path.join(workdir, name)
    os.makedirs(path, exist_ok=True)
    return path


def phase_cdr_kernel_path(device, workdir, nsteps=3):
    """cdr_3d without rivers, so that `cuda_tracer.usable` admits it: the
    release is folded into the corrector's base content.  The run with
    the kernel against the same run with its plain version, and the ALK
    and DIC it adds against a run without the release."""
    from roms_tpu_torch import bridge
    from roms_tpu_torch.cases import bench_production, cdr_real
    from roms_tpu_torch.ops import cuda_tracer
    cfg = cdr_real.base_config().replace(river_source=False)
    if not cuda_tracer.usable(cfg):
        raise AssertionError("cdr_3d without rivers: the tracer kernel's "
                             "gate refuses it")

    def go(release, plain):
        exp = cdr_real.build(workdir, "3d", ntimes=nsteps,
                             dtype=torch.float64, device=device,
                             base_cfg=cfg)
        fn = exp.forcing_fn
        if not release:
            exp.forcing_fn = lambda t, b, st: fn(t, b, st).replace(cdr=None)
        kernel = cuda_tracer.tracer_stage
        if plain:
            cuda_tracer.tracer_stage = cuda_tracer.tracer_stage_plain
        try:
            reset_counts()
            st, _ = exp.run(nsteps=nsteps, collect_diag=False)
            torch.cuda.synchronize()
            counts = read_counts()
        finally:
            cuda_tracer.tracer_stage = kernel
            exp.fileset.close()
        frc = fn(float(exp.state.time), exp.forcing0, exp.state)
        return st, counts, exp, frc

    st, counts, exp, frc = go(True, False)
    check_counts(counts, nsteps, cfg, "11 cdr_3d without rivers")
    ref, _, _, _ = go(True, True)
    dry, _, _, _ = go(False, False)
    # the bottom boundary layer's depth, found by a search on the same
    # ill-conditioned bulk Richardson number as akv and akt, is held with
    # them: over these 3 steps it moved by 1.017e-10 * max(1, max|ref|)
    # while every prognostic field held 5e-11
    loose = dict(bench_production.CONDITIONED_TOL,
                 hbbl=bench_production.CONDITIONED_TOL["akv"])
    main, text = compare_states(bridge.to_numpy(st), bridge.to_numpy(ref),
                                "cdr_3d without rivers: kernel vs plain",
                                loose=loose)
    h = cfg.halo
    da = (1.0 / (exp.grid.pm * exp.grid.pn))[h:-h, h:-h]
    gains = []
    for nm, i in (("ALK", cdr_real.IALK), ("DIC", cdr_real.IDIC)):
        moved = float((((st.t[i] - dry.t[i]) * st.hz)[:, h:-h, h:-h]
                       * da).sum())
        added = float(frc.cdr.flx_3d[i][:, h:-h, h:-h].sum()) \
            * exp.cfg.dt * nsteps
        rel = moved / added - 1.0
        gains.append(f"{nm} {moved:.6e} vs {added:.6e} ({rel:+.3e})")
        if not abs(rel) < CDR_GAIN_RTOL[nm]:
            raise AssertionError(f"cdr_3d without rivers: the release adds "
                                 f"{moved:.6e} of {nm}, {added:.6e} "
                                 f"expected")
    say(f"[11 cdr kernel path] cdr_3d without rivers f64, {nsteps} steps: "
        f"kernel vs plain max err / max(1, max|ref|) {main:.3e}, {text}; "
        f"content the release adds against a run without it: "
        + "; ".join(gains) + f"; launches tracer {counts[0]}, solve "
        f"{counts[1]}, kpp {counts[2]}")


def phase_bgc_f32(device, workdir, ref64, warm=2):
    from roms_tpu_torch import profile_step
    for name in BGC_F32:
        case = real_case(name)
        inputs = case_dir(workdir, name)

        def start(case=case, inputs=inputs):
            return case.build(inputs, ntimes=BGC_STEPS, dtype=torch.float32,
                              device=device)
        tag = f"12 {name}"
        _, st, exp = full_width(start, warm, BGC_STEPS - warm, tag, True)
        masses = tracer_masses(st, exp.grid)
        m_ref = os.path.join(DATA, f"{name}_mass_jax.txt")
        if not os.path.exists(m_ref):
            m_ref = os.path.join(DATA, f"{name}_mass_oracle.txt")
        m_ref = np.atleast_1d(np.loadtxt(m_ref))
        gap = np.abs(masses - m_ref) / np.abs(m_ref)
        ph32, ph64 = surface_ph(st, exp.cfg, exp.grid)
        say(f"[{tag}] f32 after {BGC_STEPS} steps: tracer masses vs the "
            f"f64 reference (check_masses), max rel gap {gap.max():.3e} "
            f"(tracer {int(gap.argmax())}), median {np.median(gap):.3e}; "
            f"surface "
            f"pH {float(ph32.min()):.6f} to {float(ph32.max()):.6f}, max "
            f"|f32 - f64 solve of the same surface| "
            f"{float((ph32.double() - ph64).abs().max()):.3e}")
        if not (np.isfinite(masses).all()
                and bool(torch.isfinite(ph32).all())):
            raise AssertionError(f"{tag}: masses or pH not finite")
        if exp.tides is not None:
            say(f"[{tag}] " + tidal_phase_error(exp, ref64))
        out = profile_step.profile(None, device, case=case, workdir=inputs,
                                   say=lambda *a, t=tag: say(f"[{t}]", *a))
        batched = sum(out["layers_ms"].get(n, 0.0)
                      for _, n in profile_step.BATCHED)
        say(f"[{tag}] profile: {out.get('kernels_per_step', 0.0):.0f} kernels "
            f"a step, busy share {out.get('busy_share', float('nan')):.4f}; "
            f"the BGC block {out.get('bgc_kernels', 0)} kernels "
            f"({out.get('bgc_share', float('nan')):.4f} of the step's); "
            f"batched tracer branch {batched:.3f} ms of the "
            f"{out['layer_step_ms']:.3f}-ms bracketed step "
            f"({batched / out['layer_step_ms']:.4f}), the BGC block "
            f"{out['layers_ms'].get('bgc_update', 0.0):.3f} ms, forcing_fn "
            f"{out['layers_ms'].get('forcing_fn', 0.0):.3f} ms")


def surface_ph(st, cfg, grid):
    """Surface pH at the interior ocean points from the run's tracers, in
    the run's dtype and in float64, solved as the BGC engine's surface flux
    solves it (closed-form seed, 25 iterations, PO4 and SiO3 included)."""
    from roms_tpu_torch.bgc import bec, carbonate
    from roms_tpu_torch.bgc.api import get_model
    names = [n.upper() for n in get_model(cfg.bgc_model).tracer_names]
    i0 = cfg.nt - cfg.n_bgc
    h = cfg.halo
    ocean = grid.rmask[h:-h, h:-h] > 0

    def ph(dtype):
        def s(i):
            return st.t[i, -1, h:-h, h:-h].to(dtype)[ocean]
        dic, alk = s(i0 + names.index("DIC")), s(i0 + names.index("ALK"))
        temp, salt = s(cfg.itemp), s(cfg.isalt)
        _, ph0, _ = bec._co2_equilibrium(dic, alk, temp, salt)
        return carbonate.co2_system(
            dic, alk, temp, salt, s(i0 + names.index("PO4")),
            s(i0 + names.index("SIO3")), h_init=10.0 ** (-ph0)).ph
    return ph(st.t.dtype), ph(torch.float64)


def tidal_phase_error(exp, ref64):
    """The phase ftide*(t + dt/2) that set_tides evaluates in the model's
    dtype at the start time, against the float64 run's."""
    cfg = exp.cfg
    om = exp.tides.ftide * (exp.state.time + 0.5 * cfg.dt)
    om64 = ref64.tides.ftide * (ref64.state.time + 0.5 * cfg.dt)
    err = (om.double() - om64).abs()
    cos_err = (torch.cos(om.double()) - torch.cos(om64)).abs()
    return (f"tidal phase at the start time t = {float(ref64.state.time):.1f}"
            f" s ({float(exp.state.time):.1f} s in {str(om.dtype)[6:]}): "
            f"max |error| {float(err.max()):.3e} rad over "
            f"{om.numel()} constituents, max |cos error| "
            f"{float(cos_err.max()):.3e}")


# ------------------------------------------------------------------ phase 13
# the command line's runtime input: Flux_frc's time stepping, vertical
# grid and physical constants on its grid and initial files, no forcing
# files (the command line runs on zero forcing, roms_tpu/__main__.py:63)
CLI_IN = """\
title:
    roms_tpu_torch command line on the USWC grid

time_stepping: NTIMES   dt[sec]  NDTFAST  NINFO
               {ntimes}        20       30       1

S-coord: THETA_S,   THETA_B,    hc (m)
          6.0D0        6.0D0     25.0D0

rho0:
      1027.5

lateral_visc:   VISC2
                 0.

tracer_diff2: TNU2(1:NT)
 0. 0.

bottom_drag:     RDRG [m/s],  RDRG2,  Zob [m]
                  0.E-4       1.0E-3   1.E-2

gamma2:
                  1.D0

grid:  filename
     {grid}

initial: NRREC  filename
          0
     {init}

output_root_name:
     {root}
"""
CLI_STEPS, CLI_NHIS, CLI_NRST = 10, 5, 10


def cli_input(workdir, tag, ntimes):
    """(runtime input file, output root) of a command-line run on the
    USWC grid and initial files under `workdir`."""
    from roms_tpu_torch.cases import uswc
    paths = uswc.generate_inputs(os.path.join(workdir, "input_data"))
    infile = os.path.join(workdir, f"{tag}.in")
    root = os.path.join(workdir, tag)
    with open(infile, "w") as f:
        f.write(CLI_IN.format(ntimes=ntimes, grid=paths["grid"],
                              init=paths["initial"], root=root))
    return infile, root


def cli_args(infile, *extra):
    from roms_tpu_torch.cases import uswc
    return [infile, "--nx", str(uswc.NX), "--ny", str(uswc.NY), "--nz",
            str(uswc.NZ), *extra]


def cli_config(infile):
    """The configuration `__main__.main` builds from `infile` (nt=2)."""
    from roms_tpu_torch.cases import uswc
    from roms_tpu_torch.config import ModelConfig
    from roms_tpu_torch.runconfig import read_inp
    return read_inp(infile).apply(ModelConfig(
        nx=uswc.NX, ny=uswc.NY, nz=uswc.NZ, nt=2, salinity=True,
        nonlin_eos=True, ew_periodic=False, ns_periodic=False))


def check_file_finite(path, what):
    """Every variable of a NetCDF file finite; returns its record count."""
    from roms_tpu_torch.io.netcdf import open_dataset
    with open_dataset(path) as ds:
        for name in ds.variables:
            if not np.isfinite(np.asarray(ds[name][...])).all():
                raise AssertionError(f"{what}: {name} is not finite")
        return ds["ocean_time"].shape[0] if "ocean_time" in ds else 1


def phase_cli(workdir):
    """`__main__.main` in this process at 199x99x50 f32: history every
    CLI_NHIS steps, restart every CLI_NRST, async writers; the launch
    counts its configuration's gates select; every record finite."""
    from roms_tpu_torch.__main__ import main as cli
    from roms_tpu_torch.io.netcdf import open_dataset
    infile, root = cli_input(workdir, "cli", CLI_STEPS)
    cfg = cli_config(infile)
    reset_counts()
    t0 = time.perf_counter()
    rc = cli(cli_args(infile, "--nhis", str(CLI_NHIS), "--nrst",
                      str(CLI_NRST)))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    if rc != 0:
        raise AssertionError(f"13 cli: main returned {rc}")
    check_counts(counts, CLI_STEPS, cfg, "13 cli")
    nrec = check_file_finite(root + "_his.nc", "13 cli history")
    if nrec != CLI_STEPS // CLI_NHIS:
        raise AssertionError(f"13 cli: {nrec} history records, expected "
                             f"{CLI_STEPS // CLI_NHIS}")
    check_file_finite(root + "_rst.nc", "13 cli restart")
    with open_dataset(root + "_rst.nc") as ds:
        iic = int(ds["iic"][0])
    if iic != CLI_STEPS:
        raise AssertionError(f"13 cli: restart at step {iic}")
    say(f"[13 cli] python -m roms_tpu_torch in process, {cfg.nx}x{cfg.ny}x"
        f"{cfg.nz} nt={cfg.nt} f32, {CLI_STEPS} steps, history every "
        f"{CLI_NHIS} and restart every {CLI_NRST} (async): {wall:.3f} s "
        f"with reading the inputs; {nrec} history records and the restart "
        f"at step {iic}, every value finite; launches tracer {counts[0]}, "
        f"solve {counts[1]}, kpp {counts[2]}")
    return infile, root


# three runs of each mode in turns, so that the host's drift falls on all
OUTPUT_TURNS = ("off", "sync", "async", "async", "sync", "off", "off",
                "sync", "async")


def phase_output_cost(device, infile, root, warm=2, nsteps=8):
    """The restart read and write times; then the same steps from the
    command line's restart with no output, with a history record every
    step written in the loop, and with the same records written by the
    async hook: ms/step from the end of the warm-up to the return of
    `run` (which drains the async writer), the host ms a record in the
    loop, and the async history file against the synchronous one."""
    from roms_tpu_torch.driver import run
    from roms_tpu_torch.io import (HistoryWriter, read_grid, read_restart,
                                   write_restart)
    from roms_tpu_torch.io.async_io import make_async_hook
    from roms_tpu_torch.io.netcdf import open_dataset
    from roms_tpu_torch.runconfig import read_inp
    from roms_tpu_torch.state import zero_forcing
    cfg = cli_config(infile)
    grid = read_grid(read_inp(infile).paths["grid"], cfg,
                     dtype=torch.float32, device=device)
    t0 = time.perf_counter()
    st0 = read_restart(root + "_rst.nc", cfg, dtype=torch.float32,
                       device=device)
    torch.cuda.synchronize()
    read_ms = 1e3 * (time.perf_counter() - t0)
    t0 = time.perf_counter()
    write_restart(root + "_rst_copy.nc", st0, cfg)
    write_ms = 1e3 * (time.perf_counter() - t0)
    say(f"[13 output] restart of the {cfg.nx}x{cfg.ny}x{cfg.nz} f32 state "
        f"({os.path.getsize(root + '_rst.nc') / 2**20:.1f} MiB, float64): "
        f"write {write_ms:.3f} ms, read onto the card {read_ms:.3f} ms")
    frc = zero_forcing(cfg, torch.float32, device)
    out = {}
    for k, mode in enumerate(OUTPUT_TURNS):
        path = f"{root}_cost_{mode}{k}.nc"
        hw = None if mode == "off" else HistoryWriter(path, grid, cfg)
        loop_ms, worker_ms, mark = [], [], {}

        def record(s, i, hw=hw, worker_ms=worker_ms):
            t = time.perf_counter()
            hw.write(s)
            worker_ms.append(1e3 * (time.perf_counter() - t))

        write = None if hw is None else (
            make_async_hook(record) if mode == "async" else record)

        def hook(s, i, write=write, loop_ms=loop_ms, mark=mark):
            if i == warm:
                torch.cuda.synchronize()
                mark["t0"] = time.perf_counter()
            if write is not None:
                t = time.perf_counter()
                write(s, i)
                if i > warm:
                    loop_ms.append(1e3 * (time.perf_counter() - t))

        if write is not None and hasattr(write, "drain"):
            hook.drain = write.drain
        reset_counts()
        st, _ = run(grid, st0, frc, cfg, nsteps=warm + nsteps,
                    collect_diag=False, step_hook=hook)
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - mark["t0"]) / nsteps
        check_counts(read_counts(), warm + nsteps, cfg, f"13 output {mode}")
        check_finite(st, f"13 output {mode}")
        if hw is not None:
            hw.close()
            if hw.rec != warm + nsteps:
                raise AssertionError(f"13 output {mode}: {hw.rec} records")
        out.setdefault(mode, []).append(ms)
        rec = "" if hw is None else (
            f", {np.median(loop_ms):.3f} ms a record in the loop (median of "
            f"{len(loop_ms)}), {np.median(worker_ms):.3f} ms a record's "
            f"pulls and write")
        say(f"[13 output] history {mode}: {ms:.3f} ms/step over {nsteps} "
            f"steps after {warm} warm-up{rec}")
    with open_dataset(f"{root}_cost_sync1.nc") as a, \
            open_dataset(f"{root}_cost_async2.nc") as b:
        for name in a.variables:
            if not np.array_equal(np.asarray(a[name][...]),
                                  np.asarray(b[name][...])):
                raise AssertionError(f"13 output: async history {name} "
                                     f"differs from the synchronous one")
    off = float(np.median(out["off"]))

    def text(mode):
        med = float(np.median(out[mode]))
        return (" / ".join(f"{v:.3f}" for v in out[mode])
                + f" (median {med:.3f}, {med - off:+.3f} against off)")
    say(f"[13 output] ms/step in turns {', '.join(OUTPUT_TURNS)}: off "
        f"{text('off')}; history every step sync {text('sync')}, async "
        f"{text('async')}; the async history file equals the synchronous "
        f"one bitwise ({warm + nsteps} records)")


def phase_cli_subprocess(workdir, nsteps=3):
    """`python -m roms_tpu_torch` as its own process on the same inputs."""
    infile, root = cli_input(workdir, "cli_sub", nsteps)
    env = dict(os.environ)
    env["PYTHONPATH"] = HERE + os.pathsep + env.get("PYTHONPATH", "")
    t0 = time.perf_counter()
    res = subprocess.run([sys.executable, "-m", "roms_tpu_torch"]
                         + cli_args(infile, "--nhis", "1"), cwd=workdir,
                         env=env, capture_output=True, text=True, timeout=600)
    wall = time.perf_counter() - t0
    if res.returncode != 0 or "run_time" not in res.stdout:
        raise AssertionError(f"13 cli subprocess: exit {res.returncode}\n"
                             f"{res.stdout[-2000:]}\n{res.stderr[-2000:]}")
    nrec = check_file_finite(root + "_his.nc", "13 cli subprocess")
    if nrec != nsteps:
        raise AssertionError(f"13 cli subprocess: {nrec} history records")
    banner = [ln for ln in res.stdout.splitlines() if "run_time" in ln][0]
    say(f"[13 cli subprocess] python -m roms_tpu_torch, {nsteps} steps f32, "
        f"history every step: exit 0 in {wall:.3f} s; {banner.strip()}; "
        f"{nrec} records, every value finite")


def continued(exp, st, nsteps, t0=None):
    """`nsteps` steps from a restarted state, none of them a first step
    (the reference's exact restart), with `forcing_fn` called as
    `driver.run` calls it, at t0 + i*dt, t0 the state's time unless
    given."""
    from roms_tpu_torch.driver import _call_forcing_fn
    from roms_tpu_torch.ops.weights import set_weights
    from roms_tpu_torch.stepper import step
    w1, w2, _ = set_weights(exp.cfg.ndtfast)
    t0 = float(st.time) if t0 is None else t0
    for i in range(nsteps):
        frc = _call_forcing_fn(exp.forcing_fn, t0 + i * exp.cfg.dt,
                               exp.forcing0, st)
        st = step(st, frc, exp.grid, w1, w2, exp.cfg, first_step=False)
    return st


def state_fields(st):
    return {f.name: getattr(st, f.name) for f in dataclasses.fields(st)
            if isinstance(getattr(st, f.name), torch.Tensor)}


def phase_exact_restart(device, workdir, nsteps=3):
    """Flux_frc at 199x99x50 (file forcing, open boundaries, KPP: all
    three kernels): 2*nsteps steps against nsteps + write_restart /
    read_restart + nsteps.  Float64: bitwise in every state field, and
    the state the hook gets unchanged by the next step.  Float32: the
    largest relative difference a field, from the forcing clock of the
    restarted run (its start time is the float32 model time), and the
    same continuation on the unbroken run's clock."""
    from roms_tpu_torch.cases import flux_frc
    from roms_tpu_torch.io import read_restart, write_restart
    for dtype in (torch.float64, torch.float32):
        tag = str(dtype)[6:]
        exp = flux_frc.build(workdir, ntimes=2 * nsteps, dtype=dtype,
                             device=device)
        held, moved = [], []

        def immutable(s, i):
            for old, clones in held:
                moved.extend(n for n, a in state_fields(old).items()
                             if not torch.equal(a, clones[n]))
            held[:] = [(s, {n: a.clone()
                            for n, a in state_fields(s).items()})]

        try:
            reset_counts()
            ref, _ = exp.run(nsteps=2 * nsteps, collect_diag=False,
                             step_hook=immutable if dtype == torch.float64
                             else None)
            torch.cuda.synchronize()
            counts = read_counts()
            check_counts(counts, 2 * nsteps, exp.cfg, f"13 restart {tag}")
            if moved:
                raise AssertionError(f"13 restart: the step wrote into a "
                                     f"returned state: {sorted(set(moved))}")
            held.clear()
            reset_counts()
            half, _ = exp.run(nsteps=nsteps, collect_diag=False)
            path = os.path.join(workdir, f"flux_frc_rst_{tag}.nc")
            write_restart(path, half, exp.cfg)
            back = read_restart(path, exp.cfg, dtype=dtype, device=device)
            got = continued(exp, back, nsteps)
            torch.cuda.synchronize()
            check_counts(read_counts(), 2 * nsteps, exp.cfg,
                         f"13 restart {tag} continued")
            t_start = float(exp.state.time)
            t_back = float(back.time)
            if dtype == torch.float32:
                clocked = continued(exp, back, nsteps,
                                    t0=t_start + nsteps * exp.cfg.dt)
        finally:
            exp.fileset.close()
        diff = {}
        for name, a in state_fields(ref).items():
            b = state_fields(got)[name]
            diff[name] = float((a.double() - b.double()).abs().max()) / \
                max(float(a.double().abs().max()), 1e-300)
        if dtype == torch.float64:
            bad = [n for n, a in state_fields(ref).items()
                   if not torch.equal(a, state_fields(got)[n])]
            if bad:
                raise AssertionError(
                    "13 restart f64: not bitwise after the restart: "
                    + ", ".join(f"{n} {diff[n]:.3e}" for n in bad))
            say(f"[13 restart] Flux_frc {exp.cfg.nx}x{exp.cfg.ny}x"
                f"{exp.cfg.nz} f64: {2 * nsteps} steps equal {nsteps} + "
                f"write_restart/read_restart + {nsteps} bitwise in all "
                f"{len(diff)} state fields; no step wrote into a state it "
                f"had returned; launches tracer {counts[0]}, solve "
                f"{counts[1]}, kpp {counts[2]} a run")
            continue
        same = all(torch.equal(a, state_fields(clocked)[n])
                   for n, a in state_fields(ref).items())
        worst = sorted(diff.items(), key=lambda kv: -kv[1])
        say(f"[13 restart] Flux_frc f32: the restarted steps read forcing "
            f"from t = {t_back:.1f} s (the float32 model time after "
            f"{nsteps} steps) where the unbroken run read it from "
            f"{t_start + nsteps * exp.cfg.dt:.1f} s (gap "
            f"{t_back - t_start - nsteps * exp.cfg.dt:+.1f} s); largest "
            f"relative difference a field: "
            + ", ".join(f"{n} {v:.3e}" for n, v in worst)
            + f"; on the unbroken run's clock the continuation is "
            f"{'bitwise equal' if same else 'NOT bitwise equal'}")
        if not same:
            raise AssertionError("13 restart f32: the continuation on the "
                                 "unbroken run's clock differs")


def phase_output(device, workdir):
    infile, root = phase_cli(workdir)
    phase_output_cost(device, infile, root)
    phase_cli_subprocess(workdir)
    phase_exact_restart(device, workdir)


# ------------------------------------------------------------------ phase 14
# the step's options in two sets, each with the kernels it launches: (i)
# the non-hydrostatic projection and the momentum budget ride on the
# tracer kernel's path; (ii) isoneutral mixing, the tracer budget and the
# upscale capture take the batched tracer branch (`cuda_tracer.usable`);
# each tag names its set in bench_production.OPTIONS
OPTION_SETS = (("i", "nh"), ("ii", "iso"))
OUTPUTS = ("upscale", "t_budget", "uv_budget")
PARTICLES = 1_000_000
# the last step's NH res/res0 of 14c-i, printed beside 15d's
NH_RES = {}


def compare_outputs(got, ref, what, loose):
    """The step's optional outputs (budget terms, upscale strips: dicts of
    numpy arrays, nested for uv_budget) of `got` against `ref`, array by
    array, at atol bench_production.STEP_TOL * max(1, max|ref|), or at
    `loose` (the option set's OPTION_CONDITIONED_TOL) under the array's
    dotted name; returns (the worst error of the arrays held at STEP_TOL,
    that of the conditioned ones, the number of arrays)."""
    from roms_tpu_torch.cases import bench_production
    worst, cond, n = 0.0, 0.0, 0
    todo = [(k, got[k], ref[k]) for k in OUTPUTS if ref[k] is not None]
    while todo:
        name, g, r = todo.pop()
        if isinstance(r, dict):
            if g is None or set(g) != set(r):
                raise AssertionError(f"{what}: {name} holds "
                                     f"{None if g is None else sorted(g)}, "
                                     f"expected {sorted(r)}")
            todo += [(f"{name}.{k}", g[k], v) for k, v in r.items()]
            continue
        err = float(np.abs(g - r).max()) / max(1.0, float(np.abs(r).max()))
        if not np.isfinite(g).all() or \
                err > loose.get(name, bench_production.STEP_TOL):
            raise AssertionError(f"{what}: {name} differs by {err:.3e} * "
                                 f"max(1, max|ref|)")
        if name in loose:
            cond = max(cond, err)
        else:
            worst = max(worst, err)
        n += 1
    return worst, cond, n


def phase_options_f64(device, nsteps=3):
    """14a: each option set on production 48x32x16 in float64, the card
    against the CPU, at phase 4's tolerances, with every budget term and
    upscale strip; the arrays that are ill-conditioned under each set
    (bench_production.OPTION_CONDITIONED_TOL[set]: the volume fluxes and
    what is computed from them, the momentum budget's u.vmix and rate) at
    1e-8."""
    from roms_tpu_torch import bridge
    from roms_tpu_torch.cases import bench_production
    from roms_tpu_torch.driver import run
    for tag, key in OPTION_SETS:
        flags = bench_production.OPTIONS[key]
        loose = bench_production.OPTION_CONDITIONED_TOL[key]
        cfg = bench_production.config(nx=48, ny=32, nz=16, nt=4).replace(
            **flags)
        what = f"14a-{tag} " + "+".join(k for k in flags if k not in (
            "sw_triads", "stabilize"))
        out = {}
        for where in ("cpu", device):
            grid, st, frc = bench_production.setup(cfg, dtype=torch.float64,
                                                   device=where)
            reset_counts()
            st, _ = run(grid, st, frc, cfg, nsteps=nsteps,
                        collect_diag=False)
            if where != "cpu":
                torch.cuda.synchronize()
                counts = read_counts()
                check_counts(counts, nsteps, cfg, what)
            out[str(where)] = bridge.to_numpy(st)
        on = [k for k in OUTPUTS if out["cpu"][k] is not None]
        if not on:
            raise AssertionError(f"{what}: the step returned no output")
        main, text = compare_states(
            out[str(device)], out["cpu"], what,
            loose={k: v for k, v in loose.items() if "." not in k})
        worst, cond, n = compare_outputs(out[str(device)], out["cpu"], what,
                                         loose)
        say(f"[{what}] 48x32x16 nt=4 f64, {nsteps} steps, card vs CPU: "
            f"max err / max(1, max|ref|) {main:.3e} over the state, {text}; "
            f"{n} arrays of {', '.join(on)} {worst:.3e}, their conditioned "
            f"ones {cond:.3e}; launches tracer {counts[0]}, solve "
            f"{counts[1]}, kpp {counts[2]}")
    cfg = bench_production.config(nx=48, ny=32, nz=16, nt=4).replace(
        **bench_production.OPTIONS["nh"])

    def make_run(hook):
        grid, st, frc = bench_production.setup(cfg, dtype=torch.float64,
                                               device=device)
        return run(grid, st, frc, cfg, nsteps=nsteps, collect_diag=False,
                   step_hook=hook)[0]
    graph_against_eager(f"14a-i nh f64 {nsteps} steps", make_run)


def phase_nested(device, workdir):
    """14b: tests/test_nested_flow.py's workflow through the port on the
    card in float64: its checks, and its numbers against the JAX
    package's flow (tests/data/nested_flow_jax.txt) at rtol 1e-9."""
    from roms_tpu_torch.cases import nested_basin as nb
    flow_dir = os.path.join(workdir, "nested")
    os.makedirs(flow_dir)
    reset_counts()
    t0 = time.perf_counter()
    out = nb.run_flow(flow_dir, device=device)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = read_counts()
    # the parent's 8 and 2 steps take the tracer kernel, the child's 8
    # (upscale capture) the batched branch; the basin has no KPP
    expected = (2 * (nb.NSTEPS + 2), 4 * (2 * nb.NSTEPS + 2), 0,
                2 * (2 * nb.NSTEPS + 2))
    if counts != expected:
        raise AssertionError(f"14b nested: kernel launches (tracer, solve, "
                             f"kpp, uv_rhs) = {counts}, expected {expected}")
    nb.check_flow(out)
    ref = np.loadtxt(os.path.join(DATA, "nested_flow_jax.txt"))
    got = np.concatenate([[out["dc"], out["net_flux"], out["inj"],
                           out["pc0"], out["pc1"]], out["ub_west"]])
    rel = float(np.max(np.abs(got - ref) / np.abs(ref)))
    if got.shape != ref.shape or not rel <= 1e-9:
        raise AssertionError(f"14b nested: the flow's numbers differ from "
                             f"the JAX package's by {rel:.3e} relative")
    say(f"[14b nested] parent {nb.NP}x{nb.NP}x{nb.NZ} {nb.NSTEPS} steps, "
        f"child {nb.NC}x{nb.NC}x{nb.NZ} dt=30 s {nb.NSTEPS} steps, parent "
        f"re-forced 2 steps, f64, {secs:.1f} s: ub_west "
        f"{out['ub_west'].min():.6f} to {out['ub_west'].max():.6f} (ubind "
        f"{out['ubind']}); child content change {out['dc']:.10e}, minus "
        f"the captured outward flux {-out['net_flux']:.10e} (rel gap "
        f"{abs(out['dc'] + out['net_flux']) / abs(out['dc']):.3e}); parent "
        f"gain {out['pc1'] - out['pc0']:.6e} for an injected "
        f"{out['expect']:.6e}; UpscaleWriter file equal to the strips; "
        f"numbers vs the JAX flow max rel {rel:.3e}; launches tracer "
        f"{counts[0]}, solve {counts[1]}, kpp {counts[2]}")
    runs = iter(("graph", "eager"))

    def make_run(hook):
        side_dir = os.path.join(workdir, f"nested_{next(runs)}")
        os.makedirs(side_dir)
        return nb.run_flow(side_dir, device=device)
    graph_against_eager("14b nested f64", make_run)


def seed_wet(grid, cfg, n, device, seed=0):
    """n particles at uniform positions in the wet interior cells, from a
    numpy generator (index space: padded cell p holds px = p - 1)."""
    from roms_tpu_torch.particles import seed_particles
    h = cfg.halo
    wet = np.argwhere(grid.rmask[h:-h, h:-h].cpu().numpy() > 0) + h
    rng = np.random.default_rng(seed)
    cells = wet[rng.integers(0, len(wet), n)]
    px = cells[:, 1] - 1 + rng.uniform(-0.5, 0.5, n)
    py = cells[:, 0] - 1 + rng.uniform(-0.5, 0.5, n)
    pz = rng.uniform(0.0, cfg.nz, n)
    return seed_particles(px, py, pz, dtype=torch.float32, device=device)


def device_kernels(fn):
    """(kernels, device ms) of one call of fn() under torch.profiler, or
    None where the profiler sees no device kernels."""
    from roms_tpu_torch.profile_step import _device_kernels
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        fn()
        torch.cuda.synchronize()
    k = _device_kernels(prof)
    n = sum(c for c, _ in k.values())
    return (n, 1e-3 * sum(us for _, us in k.values())) if n else None


def kernels_text(r):
    return "not measured" if r is None else \
        f"{r[0]} kernels, {r[1]:.3f} ms of device time"


def phase_nh_full_width(device, workdir, warm=1, nsteps=3):
    """14c-i: production 384x192x60 nt=34 f32 with the non-hydrostatic
    projection and the momentum budget, a million particles advanced
    after every step."""
    from roms_tpu_torch import nhmg
    from roms_tpu_torch.cases import bench_production
    from roms_tpu_torch.particles import ParticleWriter, advance_particles
    cfg = bench_production.config(nx=384, ny=192, nz=60, nt=34).replace(
        **bench_production.OPTIONS["nh"])
    what = "14c-i NH+uv_diagnostics+particles"
    box = {"events": []}
    base = analytic(bench_production, cfg, device)

    def start():
        exp = base()
        box["grid"] = exp.grid
        box["ps"] = seed_wet(exp.grid, cfg, PARTICLES, device)
        return exp

    def hook(s, iic):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        box["ps"] = advance_particles(box["ps"], s.u, s.v, s.we, s.wi, s.hz,
                                      box["grid"], cfg)
        e1.record()
        box["events"].append((e0, e1))

    solve = nhmg.nh_solve

    def keep(*a, **k):
        box["nh"] = solve(*a, **k)
        return box["nh"]
    nhmg.nh_solve = keep
    try:
        _, st, exp = full_width(start, warm, nsteps, what, False, hook=hook)
    finally:
        nhmg.nh_solve = solve
    torch.cuda.synchronize()
    ps, grid, nh = box["ps"], box["grid"], box["nh"]
    NH_RES["14c"] = float(nh.res / nh.res0)
    adv_ms = [e0.elapsed_time(e1) for e0, e1 in box["events"][warm:]]
    if not (bool(torch.isfinite(nh.res).item())
            and bool(torch.isfinite(ps.px[ps.active]).all())):
        raise AssertionError(f"{what}: NH residual or particles not finite")
    if st.uv_budget is None:
        raise AssertionError(f"{what}: no momentum budget")
    t0 = time.perf_counter()
    pw = ParticleWriter(os.path.join(workdir, "particles.nc"), PARTICLES,
                        cfg)
    pw.write(ps, float(st.time))
    pw.close()
    w_ms = 1e3 * (time.perf_counter() - t0)
    say(f"[{what}] last step's NH res/res0 {float(nh.res / nh.res0):.3e} "
        f"(res0 {float(nh.res0):.6e}, {cfg.nh_iters} PCG iterations); "
        f"{PARTICLES} particles: advance {np.median(adv_ms):.3f} ms a step "
        f"(median of the {nsteps} timed steps, CUDA events), active "
        f"{int(ps.active.sum())}, n_bot {int(ps.n_bot)}, n_sur "
        f"{int(ps.n_sur)}; one ParticleWriter record {w_ms:.1f} ms; "
        f"phase 6 (no options) {MS_PER_STEP.get('6 production', 0.0):.3f} "
        f"ms/step in this call")
    # the projection's cost on the final state: one nh_solve, and one
    # application of its line preconditioner (a Thomas sweep unrolled
    # over the levels)
    w0 = torch.zeros((cfg.nz + 1,) + tuple(st.u.shape[1:]),
                     dtype=st.u.dtype, device=device)

    def nh_call():
        return nhmg.nh_solve(st.u, st.v, w0, st.hz, st.z_r, grid.pm,
                             grid.pn, grid, cfg)
    geo = nhmg._geometry(st.hz, st.z_r, grid.pm, grid.pn, grid.umask,
                         grid.vmask, cfg)

    def precond():
        return nhmg._line_precond(st.u, geo.au, geo.av, geo.aw_int,
                                  geo.aw_top, geo.cell)
    nh_ms, _ = time_ms(nh_call, reps=3)
    pc_ms, pc_host = time_ms(precond, reps=10)
    # the same projection in float64: whether the float32 residual is the
    # PCG's own at nh_iters iterations or float32 round-off
    nh64 = nhmg.nh_solve(*[x.double() for x in (st.u, st.v, w0, st.hz,
                                                 st.z_r, grid.pm, grid.pn)],
                         promoted(grid), cfg)
    nh32 = nh_call()
    say(f"[{what}] one nh_solve {np.median(nh_ms):.3f} ms "
        f"({kernels_text(device_kernels(nh_call))}), res/res0 "
        f"{float(nh32.res / nh32.res0):.3e}, in float64 "
        f"{float(nh64.res / nh64.res0):.3e}; one line preconditioner "
        f"{np.median(pc_ms):.3f} ms, host {np.median(pc_host):.3f} ms "
        f"({kernels_text(device_kernels(precond))}), applied "
        f"{cfg.nh_iters + 1} times a projection")


def phase_iso_full_width(device, workdir, warm=1, nsteps=3):
    """14c-ii: production 384x192x60 nt=34 f32 with isoneutral mixing, the
    tracer budget and the upscale capture written by an UpscaleWriter;
    then `profile_step` of the same configuration for the batched
    branch's layers."""
    from roms_tpu_torch import profile_step
    from roms_tpu_torch.cases import bench_production
    from roms_tpu_torch.io.netcdf import open_dataset
    from roms_tpu_torch.io.upscale import UpscaleWriter
    cfg = bench_production.config(nx=384, ny=192, nz=60, nt=34).replace(
        **bench_production.OPTIONS["iso"])
    what = "14c-ii isoneutral+tracer_diagnostics+upscale"
    path = os.path.join(workdir, "upscale.nc")
    uw = UpscaleWriter(path, None, cfg, [("temp", 0, None),
                                         ("salt", 1, None)])
    times = []

    def hook(s, iic):
        t0 = time.perf_counter()
        uw.accumulate(s)
        times.append(1e3 * (time.perf_counter() - t0))
    _, st, _ = full_width(analytic(bench_production, cfg, device), warm,
                          nsteps, what, False, hook=hook)
    uw.close()
    if st.t_budget is None or st.upscale is None:
        raise AssertionError(f"{what}: no tracer budget or upscale capture")
    with open_dataset(path) as ds:
        recs = ds["temp_add_west"].shape[0]
        vals = [np.asarray(ds[v][...]) for v in ds.variables]
    if recs != warm + nsteps or not all(np.isfinite(v).all() for v in vals):
        raise AssertionError(f"{what}: the upscale file holds {recs} "
                             f"records or values not finite")
    say(f"[{what}] UpscaleWriter {recs} records, "
        f"{np.median(times[warm:]):.3f} ms a step on the host (median); "
        f"phase 6 (no options) {MS_PER_STEP.get('6 production', 0.0):.3f} "
        f"ms/step in this call")
    del st
    out = profile_step.profile(cfg, device, case=bench_production,
                               say=lambda *a: say(f"[{what}]", *a))
    lay = out["layers_ms"]
    batched = sum(lay.get(n, 0.0) for _, n in profile_step.BATCHED)
    iso = lay.get("slope_fields", 0.0) + lay.get("isoneutral_increment", 0.0)
    step = out["layer_step_ms"]
    say(f"[{what}] profile: {out.get('kernels_per_step', 0.0):.0f} kernels "
        f"a step, busy share {out.get('busy_share', float('nan')):.4f}; "
        f"batched tracer branch {batched:.3f} ms ({batched / step:.4f}) and "
        f"the isoneutral pass {iso:.3f} ms ({iso / step:.4f}: slope fields "
        f"{lay.get('slope_fields', 0.0):.3f}, increment "
        f"{lay.get('isoneutral_increment', 0.0):.3f}) of the "
        f"{step:.3f}-ms bracketed step")


def phase_options(device, workdir):
    phase_options_f64(device)
    phase_nested(device, workdir)
    phase_nh_full_width(device, workdir)
    phase_iso_full_width(device, workdir)


# ------------------------------------------------------------------ phase 15
# Phase 15 drives `driver.run_distributed` and `Experiment.run_distributed`
# on rank meshes on this one card: NCCL refuses two ranks of one
# communicator on one GPU, so NCCL runs a world of one (15a) and the 2x2
# mesh runs four gloo ranks on cuda:0, their halo strips staged through
# pinned host memory (15b-15d).  The ranks are spawned processes
# (`parallel.dist.launch`); each reads its own kernels' launch counts and
# returns its numbers, which this process prints and checks.  The
# non-hydrostatic projection runs on the mesh as one global PCG (15a,
# 15b's "nh" cases, 15d).
MESH_CASE = dict(nx=48, ny=32, nz=16, nt=4)
MESH_OPTIONS = dict(tracer_diagnostics=True, uv_diagnostics=True,
                    upscale_output=True)
MESH_MAIN = ("zeta", "ubar", "vbar", "u", "v", "t", "hz")
MESH_TOL = 1e-12
# the tracer budget's terms against their own largest value: the JAX
# package's own mesh run reaches 1.7e-9 there (vmix, tests/jax_dist_nh.py)
MESH_BUDGET_TOL = 1e-8
# 15b's cases: (tag, nx, ny, flags); "cdr_bulk" adds mCDR point releases
# and a 3-argument bulk-forcing hook (`production_forced`)
# phase 14's NH set, bench_production.OPTIONS["nh"] (phase_mesh checks
# that they agree); 15b's projection cases run it at MESH_NH_ITERS PCG
# iterations and hold every array not conditioned at MESH_NH_TOL: the
# mesh's global PCG against the single block's, whose readings are 1e-14
# to 1e-12 * scale on the card
NH_SET = dict(non_hydrostatic=True, uv_diagnostics=True)
MESH_NH_ITERS = 20
MESH_NH_TOL = 1e-11
MESH_NH = dict(NH_SET, nh_iters=MESH_NH_ITERS)
MESH_TAGS = (("plain", 48, 32, {}), ("options", 48, 32, MESH_OPTIONS),
             ("49x33", 49, 33, {}), ("cdr_bulk", 48, 32, {}),
             ("nh", 48, 32, MESH_NH), ("49x33_nh", 49, 33, MESH_NH))
# padded-global (j, i) release cells on 48x32, whose 2x2 blocks hold
# interior rows 2..17 | 18..33 and columns 2..25 | 26..49: inside each
# block, on both sides of the block boundaries and at their corner, two in
# one cell, by the physical edges (the east is land); all wet
MESH_RELEASES = ((5, 7), (9, 40), (30, 12), (27, 44), (17, 25), (18, 26),
                 (17, 26), (18, 25), (18, 26), (2, 2), (33, 2), (2, 40),
                 (33, 40))
# 15d's case: phase 6's
MESH_FULL = dict(nx=384, ny=192, nz=60, nt=34)


def flat_tree(d, pre=""):
    """A state dict of numpy arrays with its nested dicts flattened to
    dotted names (budget terms, strips); None left out."""
    out = {}
    for k, v in d.items():
        if isinstance(v, dict):
            out.update(flat_tree(v, f"{pre}{k}."))
        elif v is not None:
            out[pre + k] = np.asarray(v)
    return out


def mesh_compare(got, ref, what, tol=MESH_TOL):
    """A 2x2 run's gathered state against the single block's on the card:
    the fields tests/test_distributed.py compares and every other array at
    tol * max(1, max|ref|) over the interior; the arrays
    bench_production.CONDITIONED_TOL or OPTION_CONDITIONED_TOL names and
    the boundary strips (face volume fluxes times a tracer) at 1e-8; the
    momentum terms on the reference's update range; the tracer budget's
    terms at MESH_BUDGET_TOL of their own largest value, as
    tests/test_torch_dist.py:_compare.  Returns {name: error}."""
    from roms_tpu_torch.cases import bench_production
    loose = set(bench_production.CONDITIONED_TOL).union(
        *bench_production.OPTION_CONDITIONED_TOL.values())
    h = 2
    errs = {}
    for name, a in ref.items():
        if a.ndim < 2 and not name.startswith("upscale."):
            if not np.array_equal(got[name], a):
                raise AssertionError(f"{what}: {name} differs")
            continue
        sl = ((Ellipsis, slice(h, -h)) if name.startswith("upscale.") else
              (Ellipsis, slice(h, -h), slice(h + 1, -h))
              if name.startswith("uv_budget.u.") else
              (Ellipsis, slice(h + 1, -h), slice(h, -h))
              if name.startswith("uv_budget.v.") else
              (Ellipsis, slice(h, -h), slice(h, -h)))
        a, b = a[sl], got[name][sl]
        if name.startswith("t_budget."):
            scale, bound = float(np.abs(a).max()), MESH_BUDGET_TOL
        else:
            scale = max(1.0, float(np.abs(a).max()))
            bound = 1e-8 if (name in loose or name.startswith("upscale.")) \
                else tol
        err = float(np.abs(b - a).max()) / scale
        errs[name] = err
        if not np.isfinite(b).all() or not err <= bound:
            raise AssertionError(f"{what}: {name} differs by {err:.3e} "
                                 f"(bound {bound:.0e})")
    return errs


def mesh_text(errs):
    main = max(errs[k] for k in MESH_MAIN)
    rest = {k: v for k, v in errs.items() if k not in MESH_MAIN}
    worst = sorted(rest, key=rest.get)[-4:]
    return (f"main fields {main:.3e}; largest others "
            + ", ".join(f"{k} {rest[k]:.3e}" for k in reversed(worst)))


def production_f64(device, nx=48, ny=32, nz=MESH_CASE["nz"],
                   nt=MESH_CASE["nt"], **flags):
    from roms_tpu_torch.cases import bench_production
    cfg = bench_production.config(nx=nx, ny=ny, nz=nz, nt=nt).replace(
        **flags)
    grid, st, frc = bench_production.setup(cfg, dtype=torch.float64,
                                           device=device)
    return cfg, grid, st, frc


def production_forced(device, nz=MESH_CASE["nz"], nt=MESH_CASE["nt"]):
    """production_f64 48x32 with mCDR point releases at MESH_RELEASES
    (global indices, made block-local by the step's offsets) and a
    3-argument set_forces hook computing COARE bulk fluxes from an analytic
    atmosphere and the live state's SST and surface currents (reference:
    set_forces.F -> bulk_frc.F), the path Experiment takes with bulk
    series: (cfg, grid, state, forcing, hook).  tests/test_torch_dist.py
    runs it on the CPU."""
    from roms_tpu_torch.cdr import CdrForcing
    from roms_tpu_torch.ops.bulk import bulk_flux
    cfg, grid, st, frc = production_f64(device, nz=nz, nt=nt)
    rng = np.random.default_rng(17)
    n, ncdr = len(MESH_RELEASES), 3
    jl, il = (torch.tensor(c, device=device) for c in zip(*MESH_RELEASES))
    f64 = dict(dtype=torch.float64, device=device)
    frc = frc.replace(cdr=CdrForcing(
        iloc=il, jloc=jl, icdr=torch.arange(n, device=device) % ncdr,
        prf=torch.as_tensor(rng.uniform(0.0, 2e3, (n, cfg.nt, cfg.nz)),
                            **f64),
        flx=torch.as_tensor(rng.uniform(0.5, 1.5, (ncdr, cfg.nt)), **f64)))
    jy, ix = st.zeta.shape
    y, x = torch.meshgrid(torch.arange(jy, **f64) / jy,
                          torch.arange(ix, **f64) / ix, indexing="ij")

    def hook(t, base, st):
        day = 2 * np.pi * t / 86400.0
        fx = bulk_flux(8.0 * torch.sin(np.pi * y) + 2.0,
                       3.0 * torch.cos(np.pi * x), 14.0 + 4.0 * y,
                       0.008 + 0.002 * x, 0.1 * x * y, 330.0 + 20.0 * x,
                       250.0 * (1.0 + np.sin(day)) + 0 * x,
                       st.t[cfg.itemp, -1], st.u[-1], st.v[-1], grid, cfg)
        stflx = base.stflx.clone()
        stflx[cfg.itemp] = fx.stflx_temp
        return base.replace(sustr=fx.sustr, svstr=fx.svstr, stflx=stflx,
                            srflx=fx.srflx, swflx=fx.swflx)

    return cfg, grid, st, frc, hook


def mesh_case(tag, nx, ny, flags, device):
    """One of 15b's cases: (cfg, grid, state, forcing, hook or None)."""
    if tag == "cdr_bulk":
        return production_forced(device)
    return (*production_f64(device, nx, ny, **flags), None)


def gathered_diag(state_np, grid, cfg):
    """compute_diag of a gathered (numpy) state on the card: the row."""
    from roms_tpu_torch import bridge
    from roms_tpu_torch.diag import compute_diag
    st = bridge.state_from_numpy(state_np, dtype=torch.float64,
                                 device=grid.h.device)
    d = compute_diag(st, grid, cfg)
    return [float(d.avke), float(d.avke2b), float(d.cu_adv), float(d.cu_w)]


# 15a's runs: without options, and with phase 14's NH set (the
# projection with the mesh's halo refresh and world sum)
MESH_15A = (("plain", {}), ("nh", NH_SET))


def rank_15a(mesh):
    """A world of one on NCCL: run_distributed on the 1x1 mesh against
    driver.run on the same card, every field and row bitwise, for each
    flag set of MESH_15A."""
    import torch.distributed as tdist
    from roms_tpu_torch import bridge
    from roms_tpu_torch.driver import run, run_distributed
    one = torch.ones(1, device=mesh.device)
    tdist.all_reduce(one)           # NCCL itself, on a world of one
    out = {"nccl": float(one), "backend": mesh.backend, "shape": mesh.shape}
    for tag, flags in MESH_15A:
        cfg, grid, st, frc = production_f64(mesh.device, **flags)
        reset_counts()
        sd, rows_d = run_distributed(grid, st, frc, cfg, mesh, nsteps=3)
        torch.cuda.synchronize()
        counts = read_counts()
        s1, rows_1 = run(grid, st, frc, cfg, nsteps=3)
        a, b = flat_tree(bridge.to_numpy(s1)), flat_tree(bridge.to_numpy(sd))
        out[tag] = {"counts": counts, "fields": len(a),
                    "differ": [k for k in a if not np.array_equal(a[k],
                                                                  b[k])],
                    "rows_equal": bool(np.array_equal(rows_d, rows_1))}
    return out


def rank_15(mesh, infile):
    """15b-15d on one rank of the 2x2 gloo mesh on cuda:0."""
    from roms_tpu_torch import bridge
    from roms_tpu_torch.driver import run_distributed
    from roms_tpu_torch.parallel.dist import pad_for_mesh
    out = {}
    t0 = time.perf_counter()
    # 15b: production without options (all three kernels), with the
    # budgets and the upscale capture, on a grid the mesh does not divide,
    # and with mCDR releases and a bulk-forcing hook
    for tag, nx, ny, flags in MESH_TAGS:
        cfg, grid, st, frc, hook = mesh_case(tag, nx, ny, flags, mesh.device)
        reset_counts()
        sd, rows = run_distributed(grid, st, frc, cfg, mesh, nsteps=3,
                                   forcing_fn=hook)
        torch.cuda.synchronize()
        counts = read_counts()
        # a padded grid gates the tracer and KPP kernels off, as in the
        # JAX package (cuda_tracer.usable, cuda_kpp.usable)
        check_counts(counts, 3, pad_for_mesh(cfg, mesh),
                     f"15b {tag} rank {mesh.rank}")
        sd = bridge.to_numpy(sd)
        row = gathered_diag(sd, grid, cfg)
        out[tag] = {"counts": counts, "rows": rows,
                    "diag_bitwise": row == rows[-1, 1:].tolist()}
        if mesh.rank == 0:
            out[tag]["state"] = flat_tree(sd)
        if tag == "plain":
            out["particles"] = mesh_particles(mesh, cfg, grid, sd)
    out["15b_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out["15c"] = mesh_flux_frc(mesh, infile)
    out["15c_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out["15d"] = mesh_full_width(mesh)
    out["15d_nh"] = mesh_full_width(mesh, nh=True)
    out["15d_s"] = time.perf_counter() - t0
    return out


def mesh_particles(mesh, cfg, grid, state_np, n=20000, nsteps=3):
    """The distributed particle step on the 2x2 blocks of a gathered state
    against advance_particles on the global fields, bitwise."""
    from roms_tpu_torch.parallel.dist import to_block
    from roms_tpu_torch.particles import (advance_particles,
                                          make_distributed_particle_step,
                                          seed_particles)
    dev = mesh.device
    f = {k: torch.as_tensor(state_np[k], device=dev)
         for k in ("u", "v", "we", "wi", "hz")}
    rng = np.random.default_rng(21)
    ps0 = seed_particles(rng.uniform(-1.0, cfg.nx + 1.0, n),
                         rng.uniform(-1.0, cfg.ny + 1.0, n),
                         rng.uniform(-0.5, cfg.nz + 0.5, n),
                         dtype=torch.float64, device=dev)
    ref = ps0
    for _ in range(nsteps):
        ref = advance_particles(ref, f["u"], f["v"], f["we"], f["wi"],
                                f["hz"], grid, cfg)
    fb = to_block(f, mesh, cfg.halo)
    gb = to_block(grid, mesh, cfg.halo)
    step = make_distributed_particle_step(cfg, mesh)
    ps = ps0
    for _ in range(nsteps):
        ps = step(ps, fb["u"], fb["v"], fb["we"], fb["wi"], fb["hz"], gb)
    torch.cuda.synchronize()
    differ = [k for k in ("px", "py", "pz", "dpxm", "dpym", "dpzm", "active",
                          "n_bot", "n_sur")
              if not torch.equal(getattr(ps, k), getattr(ref, k))]
    return {"differ": differ, "active": int(ps.active.sum()), "n": n}


def mesh_flux_frc(mesh, infile, nsteps=20):
    """15c: Flux_frc in float64 through Experiment.run_distributed (the
    file-driven forcing path on every rank; Flux_frc has no bulk series,
    so its hook asks for no surface view: 15b's cdr_bulk case drives
    that); the rows, the masses of the gathered state."""
    from types import SimpleNamespace
    from roms_tpu_torch.cases import flux_frc, uswc
    from roms_tpu_torch.experiment import assemble
    from roms_tpu_torch.parallel.dist import pad_for_mesh
    exp = assemble(infile, flux_frc.base_config(),
                   tracer_names=("temp", "salt"), nz=uswc.NZ,
                   dtype=torch.float64, device=mesh.device)
    try:
        reset_counts()
        st, rows = exp.run_distributed(mesh, nsteps=nsteps)
        torch.cuda.synchronize()
        counts = read_counts()
    finally:
        exp.fileset.close()
    check_counts(counts, nsteps, pad_for_mesh(exp.cfg, mesh),
                 f"15c rank {mesh.rank}")
    masses = tracer_masses(SimpleNamespace(t=torch.as_tensor(st.t),
                                           hz=torch.as_tensor(st.hz)),
                           exp.grid)
    return {"rows": rows, "masses": masses, "counts": counts,
            "shape": (exp.cfg.nx, exp.cfg.ny, exp.cfg.nz, exp.cfg.nt)}


def mesh_full_width(mesh, nh=False, warm=1, nsteps=3):
    """15d: production 384x192x60 nt=34 f32 on this rank's block: ms/step
    (each rank synchronised, then a barrier), the peak memory of the
    global set-up (every rank builds the whole state, then cuts its
    block) and of the steps on the block alone; without the
    projection, the host ms of one 3D and one 2D exchange; with phase 14's
    NH set (`nh`), the last step's res/res0 and `mesh_projection`."""
    import torch.distributed as tdist
    from roms_tpu_torch import nhmg
    from roms_tpu_torch.cases import bench_production
    from roms_tpu_torch.ops.weights import set_weights
    from roms_tpu_torch.parallel.dist import make_distributed_step, to_block
    from roms_tpu_torch.parallel.halo import HaloExchange
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cfg = bench_production.config(**MESH_FULL).replace(
        **(bench_production.OPTIONS["nh"] if nh else {}))
    what = f"15d{' NH' if nh else ''} rank {mesh.rank}"
    grid, st, frc = bench_production.setup(cfg, dtype=torch.float32,
                                           device=mesh.device)
    h = cfg.halo
    st, frc = to_block(st, mesh, h), to_block(frc, mesh, h)
    grid = to_block(grid, mesh, h)
    gc.collect()
    torch.cuda.empty_cache()
    setup_peak = torch.cuda.max_memory_allocated() / 2**30
    torch.cuda.reset_peak_memory_stats()
    w1, w2, _ = set_weights(cfg.ndtfast)
    step = make_distributed_step(cfg, mesh)
    solve, box = nhmg.nh_solve, {}

    def keep(*a, **k):
        box["nh"] = solve(*a, **k)
        return box["nh"]
    nhmg.nh_solve = keep
    try:
        reset_counts()
        for i in range(warm + nsteps):
            if i == warm:
                torch.cuda.synchronize()
                tdist.barrier()
                t0 = time.perf_counter()
            st = step(st, frc, grid, w1, w2, first_step=(i == 0))
        torch.cuda.synchronize()
        tdist.barrier()
        ms = 1e3 * (time.perf_counter() - t0) / nsteps
        counts = read_counts()
    finally:
        nhmg.nh_solve = solve
    check_counts(counts, warm + nsteps, cfg, what)
    check_finite(st, what)
    out = {"ms": ms, "counts": counts, "setup_peak": setup_peak,
           "peak": torch.cuda.max_memory_allocated() / 2**30,
           "block": tuple(st.zeta.shape)}
    if nh:
        res = float(box["nh"].res / box["nh"].res0)
        if not np.isfinite(res):
            raise AssertionError(f"{what}: NH res/res0 {res}")
        out["res"], out["iters"] = res, cfg.nh_iters
        out["projection"] = mesh_projection(mesh, cfg, st, grid)
        return out
    halo = HaloExchange(mesh, cfg.halo, cfg.ew_periodic, cfg.ns_periodic)
    ex = {}
    for name, a in (("3d", st.u), ("2d", st.zeta)):
        halo(a)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(10):
            halo(a)
        torch.cuda.synchronize()
        ex[name] = 1e3 * (time.perf_counter() - t0) / 10
    out["ex"] = ex
    return out


class CountedHalo:
    """A rank's halo refresh and world sum, each call counted and its host
    ms taken with the stream synchronised before and after."""

    def __init__(self, halo):
        self.halo = halo
        self.n = {"exchange": 0, "all_reduce": 0}
        self.ms = {"exchange": 0.0, "all_reduce": 0.0}

    def _timed(self, kind, fn, a):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(a)
        torch.cuda.synchronize()
        self.ms[kind] += 1e3 * (time.perf_counter() - t0)
        self.n[kind] += 1
        return out

    def __call__(self, a):
        return self._timed("exchange", self.halo, a)

    def world_sum(self, t):
        return self._timed("all_reduce", self.halo.world_sum, t)


def mesh_projection(mesh, cfg, st, grid_b, reps=3):
    """15d with NH: one projection of this rank's block of the final state
    with the step's halo refresh and world sum: its host ms (median of
    reps, the ranks started together, the stream synchronised); then one
    more, counted: the halo exchanges and all-reduces it makes, the host
    ms in each kind, and the messages staged through pinned host memory
    (gloo on the card: each copy waits for the stream); and the host ms
    of one all-reduce of two numbers alone (mean of 20, the ranks started
    together), beside which the counted ones show the waits for the other
    ranks."""
    import torch.distributed as tdist
    from roms_tpu_torch import nhmg
    from roms_tpu_torch.parallel.dist import _with_ownership, pad_for_mesh
    from roms_tpu_torch.parallel.halo import HaloExchange
    halo = HaloExchange(mesh, cfg.halo, cfg.ew_periodic, cfg.ns_periodic)
    grid = _with_ownership(grid_b, pad_for_mesh(cfg, mesh), mesh)
    w0 = torch.zeros((cfg.nz + 1,) + tuple(st.u.shape[1:]),
                     dtype=st.u.dtype, device=st.u.device)

    def solve(h):
        return nhmg.nh_solve(st.u, st.v, w0, st.hz, st.z_r, grid.pm,
                             grid.pn, grid, cfg, halo=h)
    ms = []
    for _ in range(reps):
        torch.cuda.synchronize()
        tdist.barrier()
        t0 = time.perf_counter()
        solve(halo)
        torch.cuda.synchronize()
        ms.append(1e3 * (time.perf_counter() - t0))
    counted, staged = CountedHalo(halo), [0]

    def send_buffer(t, send=mesh._send_buffer):
        buf = send(t)
        staged[0] += buf.device != t.device
        return buf
    mesh._send_buffer = send_buffer
    try:
        solve(counted)
    finally:
        del mesh._send_buffer
    two = torch.zeros(2, dtype=st.u.dtype, device=st.u.device)
    halo.world_sum(two)
    torch.cuda.synchronize()
    tdist.barrier()
    t0 = time.perf_counter()
    for _ in range(20):
        halo.world_sum(two)
    torch.cuda.synchronize()
    alone = 1e3 * (time.perf_counter() - t0) / 20
    return {"ms": float(np.median(ms)), "n": counted.n, "in_ms": counted.ms,
            "staged": staged[0], "all_reduce_alone_ms": alone}


def phase_mesh(device, workdir, smi):
    from roms_tpu_torch.cases import bench_production, flux_frc, uswc
    from roms_tpu_torch.driver import run
    from roms_tpu_torch.ops import _build
    from roms_tpu_torch.parallel.dist import launch
    if NH_SET != bench_production.OPTIONS["nh"]:
        raise AssertionError(f"NH_SET {NH_SET} is not phase 14's NH set")
    _build.build()          # once, before any rank needs the library
    t0 = time.perf_counter()
    (a,) = launch(rank_15a, 1, "nccl", "cuda", timeout=300.0)
    for tag, flags in MESH_15A:
        r = a[tag]
        expected = expected_counts(
            3, bench_production.config(**MESH_CASE).replace(**flags))
        if r["differ"] or not r["rows_equal"] or r["counts"] != expected \
                or a["nccl"] != 1.0 or a["backend"] != "nccl":
            raise AssertionError(
                f"15a {tag}: NCCL 1x1 against driver.run: fields differ "
                f"{r['differ']}, rows equal {r['rows_equal']}, launches "
                f"{r['counts']} (expected {expected})")
        extra = " with the NH projection and the momentum budget" \
            if tag == "nh" else ""
        say(f"[15a mesh] NCCL world of one ({a['shape']} mesh), production "
            f"48x32x16 nt=4 f64{extra}, 3 steps: all {r['fields']} state "
            f"fields and every diag row bitwise equal to driver.run on the "
            f"card; launches tracer "
            f"{r['counts'][0]}, solve {r['counts'][1]}, kpp {r['counts'][2]}")
    say(f"[15a mesh] {time.perf_counter() - t0:.1f} s")

    # the single-block references on this card
    from roms_tpu_torch import bridge
    refs = {}
    for tag, nx, ny, flags in MESH_TAGS:
        cfg, grid, st, frc, hook = mesh_case(tag, nx, ny, flags, device)
        s1, rows = run(grid, st, frc, cfg, nsteps=3, forcing_fn=hook)
        refs[tag] = (flat_tree(bridge.to_numpy(s1)), rows)
    # Flux_frc's inputs for 15c, written once before the ranks read them
    inp = os.path.join(workdir, "mesh_input")
    uswc.generate_inputs(inp)
    infile = os.path.join(workdir, "mesh_flux_frc.in")
    with open(infile, "w") as f:
        f.write(flux_frc.BENCHMARK_IN.format(inp=inp, ntimes=20))

    t0 = time.perf_counter()
    outs = launch(rank_15, 4, "gloo", "cuda:0", args=(infile,),
                  timeout=900.0)
    wall = time.perf_counter() - t0
    for tag, (ref, rows1) in refs.items():
        nh = tag.endswith("nh")
        errs = mesh_compare(outs[0][tag]["state"], ref, f"15b {tag}",
                            tol=MESH_NH_TOL if nh else MESH_TOL)
        for r, o in enumerate(outs):
            if not o[tag]["diag_bitwise"]:
                raise AssertionError(f"15b {tag} rank {r}: the last diag "
                                     "row is not compute_diag's of the "
                                     "gathered state")
            if not np.array_equal(o[tag]["rows"], outs[0][tag]["rows"]):
                raise AssertionError(f"15b {tag}: ranks disagree on rows")
        rows = outs[0][tag]["rows"]
        e_rows = float(np.max(np.abs(rows[:, 1:4] - rows1[:, 1:4])
                              / np.abs(rows1[:, 1:4]).clip(1e-300)))
        extra = {"options": "budgets+upscale ",
                 "cdr_bulk": "mCDR releases+bulk hook "}.get(
                     tag, f"NH ({MESH_NH_ITERS} PCG iterations)+momentum "
                     f"budget " if nh else "")
        say(f"[15b mesh] 2x2 gloo ranks on one card, production "
            f"{'49x33' if tag.startswith('49x33') else '48x32'}x16 nt=4 f64 "
            f"{extra}3 steps "
            f"against the single block on the card: {mesh_text(errs)}"
            f"{f' (bound {MESH_NH_TOL:.0e})' if nh else ''}; "
            f"last diag row bitwise compute_diag's of the gathered state on "
            f"every rank, rows {e_rows:.3e} from the single block's; "
            f"launches a rank (tracer, solve, kpp) "
            + " ".join(str(o[tag]["counts"]) for o in outs))
    for r, o in enumerate(outs):
        p = o["particles"]
        if p["differ"]:
            raise AssertionError(f"15b particles rank {r}: {p['differ']} "
                                 "differ from advance_particles")
    say(f"[15b mesh] distributed particle step, {outs[0]['particles']['n']}"
        f" particles, 3 steps: bitwise advance_particles on every rank "
        f"({outs[0]['particles']['active']} active); 15b "
        f"{max(o['15b_s'] for o in outs):.1f} s")

    c = outs[0]["15c"]
    oracle = np.loadtxt(os.path.join(DATA, "flux_frc_oracle.txt"))
    rows = c["rows"]
    if rows.shape != oracle.shape:
        raise AssertionError(f"15c: {rows.shape} rows vs {oracle.shape}")
    worst = worst_rel(rows, oracle)
    for col, rtol in zip((1, 2, 3, 4), REAL_RTOL):
        if not (np.allclose(rows[:, col], oracle[:, col], rtol=rtol,
                            atol=1e-300)
                and np.isclose(rows[:, col].sum(), oracle[:, col].sum(),
                               rtol=rtol)):
            raise AssertionError(f"15c flux_frc: column {col} max rel dev "
                                 f"{worst[col]:.3e} > {rtol}")
    m_rel, _ = check_masses("flux_frc", c["masses"], None)
    nx, ny, nz, nt = c["shape"]
    say(f"[15c mesh] Flux_frc {nx}x{ny}x{nz} nt={nt} f64 on 2x2 gloo ranks "
        f"through Experiment.run_distributed, 20 steps vs "
        f"tests/data/flux_frc_oracle.txt: max rel dev KE {worst[1]:.3e}, "
        f"barotropic KE {worst[2]:.3e}, CFL {worst[3]:.3e}, vertical CFL "
        f"{worst[4]:.3e} (rtol {REAL_RTOL}), tracer masses {m_rel:.3e} "
        f"(1e-9); launches a rank " + " ".join(str(o["15c"]["counts"])
                                               for o in outs)
        + f"; 15c {max(o['15c_s'] for o in outs):.1f} s")

    mesh_nh_text(outs, smi)
    d = [o["15d"] for o in outs]
    say(f"[15d mesh] production {MESH_FULL['nx']}x{MESH_FULL['ny']}x"
        f"{MESH_FULL['nz']} nt={MESH_FULL['nt']} f32 on 2x2 ranks "
        f"(blocks {d[0]['block']}), 1 warm-up + 3 timed steps, finite: "
        f"{max(x['ms'] for x in d):.3f} ms/step (slowest rank; ranks "
        + " ".join(f"{x['ms']:.3f}" for x in d)
        + "), " + mesh_peaks(d) + ", one exchange 3D (u) "
        + " ".join(f"{x['ex']['3d']:.3f}" for x in d) + " ms, 2D (zeta) "
        + " ".join(f"{x['ex']['2d']:.3f}" for x in d)
        + f" ms host time; launches a rank {d[0]['counts']}; four ranks "
        f"sharing one card with the halos staged through the host: not a "
        f"scaling number; {smi}; 15d "
        f"{max(o['15d_s'] for o in outs):.1f} s, the launch {wall:.1f} s")


def mesh_peaks(d):
    """15d's peak memory a rank: the steps' and the global set-up's."""
    return ("peak memory a rank in the steps "
            + " ".join(f"{x['peak']:.3f}" for x in d)
            + " GiB (the global set-up before the block cut "
            + " ".join(f"{x['setup_peak']:.3f}" for x in d) + " GiB)")


def mesh_nh_text(outs, smi):
    """15d with NH: its numbers from every rank, printed."""
    d = [o["15d_nh"] for o in outs]
    pr = [x["projection"] for x in d]
    n = pr[0]["n"]
    if any(p["n"] != n for p in pr):
        raise AssertionError(f"15d NH: ranks made different collectives "
                             f"{[p['n'] for p in pr]}")
    single = NH_RES.get("14c")
    say(f"[15d mesh NH] production {MESH_FULL['nx']}x{MESH_FULL['ny']}x"
        f"{MESH_FULL['nz']} nt={MESH_FULL['nt']} f32 with the NH projection "
        f"and the momentum budget on 2x2 gloo ranks sharing one card, 1 "
        f"warm-up + 3 timed steps, finite: "
        f"{max(x['ms'] for x in d):.3f} ms/step (slowest rank; ranks "
        + " ".join(f"{x['ms']:.3f}" for x in d)
        + f"; 15d without NH below); one projection "
        f"{max(p['ms'] for p in pr):.3f} ms (slowest rank; ranks "
        + " ".join(f"{p['ms']:.3f}" for p in pr)
        + f") with {n['exchange']} halo exchanges ("
        + " ".join(f"{p['in_ms']['exchange']:.3f}" for p in pr)
        + f" ms a rank) and {n['all_reduce']} all-reduces ("
        + " ".join(f"{p['in_ms']['all_reduce']:.3f}" for p in pr)
        + " ms a rank; one alone "
        + " ".join(f"{p['all_reduce_alone_ms']:.3f}" for p in pr)
        + f" ms), {pr[0]['staged']} messages staged through pinned "
        f"host memory a rank (each waits for the stream); last step's "
        f"res/res0 {d[0]['res']:.6e} ({d[0]['block']} blocks, "
        f"{d[0]['iters']} PCG iterations; the single block in 14c-i "
        + ("not run" if single is None else f"{single:.6e}")
        + "); " + mesh_peaks(d) + f"; launches a rank {d[0]['counts']}; {smi}")


# ----------------------------------------------------------------- phase 16
# A float32 field's drift from float64 on the card is held to at most
# PREC_FACTOR times a reference drift, both floored at PREC_FLOOR (below
# it a field's drift is round-off of its last digits).  (a): the JAX
# package's drift on the CPU for the same case and step
# (PRECISION_DATA.json), over its first PREC_STEPS steps: round-off
# accumulation there, before Rivers_ana turns chaotic after step 60
# (PRECISION.md, regime 1); Filament's u is printed, not held (near zero
# at the start, PRECISION.md footnote 1).  (b): production, where the JAX
# package has no record, against the same float32 run with the three
# kernels' plain versions, at step PREC_PROD_STEPS.
PREC_FACTOR, PREC_FLOOR = 10.0, 1e-6
PREC_STEPS, PREC_PROD_STEPS = 50, 20
PREC_HELD = {"filament": ("zeta", "temp", "ke_rel"),
             "rivers_ana": ("zeta", "u", "temp", "ke_rel")}


def precision_gate(got, ref, fields, what):
    """Each field of row `got` at most PREC_FACTOR times row `ref`'s, both
    floored at PREC_FLOOR; returns the largest ratio."""
    worst = 0.0
    for f in fields:
        if not np.isfinite(got[f]):
            raise AssertionError(f"{what} step {got['step']}: {f} drift "
                                 f"{got[f]}")
        ratio = max(got[f], PREC_FLOOR) / max(ref[f], PREC_FLOOR)
        if ratio > PREC_FACTOR:
            raise AssertionError(
                f"{what} step {got['step']}: {f} drift {got[f]:.3e}, "
                f"{ratio:.2f}x the reference's {ref[f]:.3e} (at most "
                f"{PREC_FACTOR}x, floor {PREC_FLOOR})")
        worst = max(worst, ratio)
    return worst


def precision_rows(name, nsteps, device):
    """The port's study of a case on the card, with the launch counts of
    its float64 and float32 runs (2 * nsteps steps) held to the gates."""
    from roms_tpu_torch import precision_study as ps
    reset_counts()
    rows = ps.study(name, ps.maker(name, device), nsteps, device,
                    say=lambda line: say(f"[16 precision] {line}"))
    torch.cuda.synchronize()
    counts = read_counts()
    check_counts(counts, 2 * nsteps, ps.CASES[name][0](),
                 f"16 {name} float64 + float32")
    return rows, counts


def phase_precision(device, smi):
    """Float32 against float64 on the card: (a) Filament and Rivers_ana
    against the JAX package's record, (b) production's kernels against
    their plain versions."""
    from roms_tpu_torch import precision_study as ps
    from roms_tpu_torch.ops import (cuda_kpp, cuda_solve, cuda_tracer,
                                    cuda_uv_rhs)
    t0 = time.perf_counter()
    with open(os.path.join(HERE, "PRECISION_DATA.json")) as f:
        record = json.load(f)
    for name, held in PREC_HELD.items():
        rows, counts = precision_rows(name, PREC_STEPS, device)
        ref = {r["step"]: r for r in record[name]}
        worst = max(precision_gate(r, ref[r["step"]], held, f"16a {name}")
                    for r in rows)
        last = rows[-1]
        say(f"[16a precision] {name} f32 against f64 on the card, "
            f"{PREC_STEPS} steps: step {last['step']} "
            + ", ".join(f"{f} {last[f]:.3e} (JAX CPU "
                        f"{ref[last['step']][f]:.3e})" for f in ps.FIELDS)
            + f"; {', '.join(held)} held at most {PREC_FACTOR}x the JAX "
            f"package's rows (floor {PREC_FLOOR}) at every logged step, "
            f"largest ratio {worst:.3f}; launches (tracer, solve, kpp) "
            f"{counts}; {smi}")

    cfg = ps.CASES["production"][0]()
    rows, counts = precision_rows("production", PREC_PROD_STEPS, device)
    # the control: the stepper reads the four wrappers from their
    # modules at each call, so the same study runs their plain versions
    reset_counts()
    saved = (cuda_tracer.tracer_stage, cuda_solve.momentum_implicit,
             cuda_kpp.vmix_update, cuda_uv_rhs.uv_rhs)
    cuda_tracer.tracer_stage = cuda_tracer.tracer_stage_plain
    cuda_solve.momentum_implicit = cuda_solve.momentum_implicit_plain
    cuda_kpp.vmix_update = cuda_kpp.vmix_update_plain
    cuda_uv_rhs.uv_rhs = cuda_uv_rhs.uv_rhs_plain
    try:
        plain = ps.study("production", ps.maker("production", device),
                         PREC_PROD_STEPS, device,
                         say=lambda line: say(f"[16b plain] {line}"))
        torch.cuda.synchronize()
    finally:
        (cuda_tracer.tracer_stage, cuda_solve.momentum_implicit,
         cuda_kpp.vmix_update, cuda_uv_rhs.uv_rhs) = saved
    control = read_counts()
    if control != (0, 0, 0, 0):
        raise AssertionError(f"16b production with the plain versions: "
                             f"kernel launches {control}, expected 0")
    got, ref = rows[-1], plain[-1]
    worst = precision_gate(got, ref, ps.FIELDS, "16b production kernels "
                           "against plain")
    say(f"[16b precision] production {cfg.nx}x{cfg.ny}x{cfg.nz} "
        f"nt={cfg.nt} f32 against f64 on the card, step {got['step']}, "
        "kernels / plain versions: "
        + ", ".join(f"{f} {got[f]:.3e} / {ref[f]:.3e}" for f in ps.FIELDS)
        + f"; each at most {PREC_FACTOR}x (floor {PREC_FLOOR}), largest "
        f"ratio {worst:.3f}; launches (tracer, solve, kpp) {counts}, the "
        f"plain run {control}; {smi}")
    from roms_tpu_torch.driver import run
    for name, nsteps in (("filament", 3), ("production", 2)):
        def make_run(hook, name=name, nsteps=nsteps):
            cfg, grid, st, frc = ps.maker(name, device)(torch.float64)
            return run(grid, st, frc, cfg, nsteps=nsteps,
                       collect_diag=False, step_hook=hook)[0]
        graph_against_eager(f"16 {name} f64 {nsteps} steps", make_run)
    say(f"[16 precision] {time.perf_counter() - t0:.1f} s")


def main():
    from roms_tpu_torch.ops import _build  # noqa: F401  (fails off the repo)
    t0 = time.perf_counter()
    device, name, smi = phase_device()
    phase_build()
    phase_kernels(device)
    phase_oracle(device)
    phase_production_f64(device)
    phase_filament_full_width(device)
    kernels = phase_production_full_width(device)
    phase_reference_size(device)
    phase_graph(device)
    phase_point_sources(device)
    # the USWC inputs (106 MB) go to the ignored build/ of this checkout
    build = os.path.join(HERE, "build")
    os.makedirs(build, exist_ok=True)
    with tempfile.TemporaryDirectory(prefix="uswc_", dir=build) as workdir:
        phase_real_f64(device, workdir)
        phase_real_f32(device, workdir)
        ref64 = phase_bgc_f64(device, workdir)
        phase_bgc_f32(device, workdir, ref64)
        phase_output(device, workdir)
        phase_options(device, workdir)
        phase_mesh(device, workdir, smi)
    phase_precision(device, smi)
    # the card again, where the end of a long log still shows it
    say(f"[done] {time.perf_counter() - t0:.1f} s on {smi}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
