"""The float32-against-float64 trajectory study on one CUDA device
(counterpart of the root precision_study.py, whose results on the CPU are
PRECISION.md and PRECISION_DATA.json).

    python3 -m roms_tpu_torch.precision_study [nsteps] [--cases CASE ...]
        [--cpu] [--out PATH]

Builds each case in float64 and in float32 from the same setup, steps the
two side by side for `nsteps` (default 200), and at step 1 and every 10th
step logs the largest interior difference of zeta, u and temp (t[0])
relative to the float64 field's largest magnitude, and the relative error
of the diagnosed volume-mean kinetic energy (`compute_diag(...).avke`).
The float64 trajectory is the truth (the reference is float64 throughout,
set_global_definitions.h:128-134).  Cases:

  filament    64x64x32 (cases/filament.py): the periodic split-explicit
              core; the tracer and solve kernels;
  rivers_ana  100x100x10 (cases/rivers_ana.py): a land mask, KPP, the
              nonlinear EOS, river sources; the KPP and solve kernels and
              the batched tracer branch;
  production  384x192x60 nt=34 (cases/bench_production.py at bench.py:66's
              shape): open boundaries, KPP, 34 tracers; all three
              kernels.

The default cases are filament and rivers_ana, as in the root script.  It
runs on the card unless `--cpu` is given; without a card and without
`--cpu` it raises.  It writes the rows, the device and, on the card, the
card's name and power limit as nvidia-smi prints them, to `--out`
(default PRECISION_DATA_torch.json).
"""

from __future__ import annotations

import argparse
import functools
import json
import subprocess
import time

import numpy as np
import torch

from roms_tpu_torch.cases import (bench_production, filament, resolve_device,
                                  rivers_ana)
from roms_tpu_torch.diag import compute_diag
from roms_tpu_torch.ops.weights import set_weights
from roms_tpu_torch.stepper import step

# case name -> (config(), setup(cfg, dtype=, device=))
CASES = {
    "filament": (filament.config, filament.setup),
    "rivers_ana": (rivers_ana.config, rivers_ana.setup),
    "production": (functools.partial(bench_production.config,
                                     nx=384, ny=192, nz=60, nt=34),
                   bench_production.setup),
}
DEFAULT_CASES = ("filament", "rivers_ana")
FIELDS = ("zeta", "u", "temp", "ke_rel")


def drift(a64, a32):
    """Largest |a64 - a32| over the interior (two halo lines off each
    horizontal edge), relative to the largest |a64| there (to 1 where
    a64 is 0 there)."""
    a = np.asarray(a64, np.float64)[..., 2:-2, 2:-2]
    b = np.asarray(a32, np.float64)[..., 2:-2, 2:-2]
    scale = np.abs(a).max() or 1.0
    return float(np.abs(a - b).max() / scale)


def maker(name: str, device):
    """make(dtype) -> (cfg, grid, state, forcing) of a case of CASES, built
    on `device`."""
    config, setup = CASES[name]

    def make(dtype):
        cfg = config()
        return (cfg, *setup(cfg, dtype=dtype, device=device))
    return make


def _host(x):
    return x.detach().cpu().numpy()


def study(name, make, nsteps, device,
          say=functools.partial(print, flush=True)):
    """Step make(float64) and make(float32) side by side for `nsteps` on
    `device`, each with the fast-time weights cast to its type, and return
    one row {"step", "zeta", "u", "temp", "ke_rel"} at step 1 and at every
    10th step (the schema of the root precision_study.study)."""
    device = torch.device(device)
    runs = []
    for dtype, npdt in ((torch.float64, np.float64),
                        (torch.float32, np.float32)):
        cfg, grid, st, frc = make(dtype)
        if st.zeta.device.type != device.type or st.zeta.dtype != dtype:
            raise ValueError(f"{name}: make({dtype}) built a "
                             f"{st.zeta.dtype} state on {st.zeta.device}, "
                             f"not on {device}")
        w1, w2, _ = set_weights(cfg.ndtfast)
        runs.append([cfg, grid, st, frc, w1.astype(npdt), w2.astype(npdt)])

    rows = []
    t0 = time.perf_counter()
    for i in range(nsteps):
        for run in runs:
            cfg, grid, st, frc, w1, w2 = run
            run[2] = step(st, frc, grid, w1, w2, cfg, first_step=(i == 0))
        if (i + 1) % 10 and i:
            continue
        (c64, g64, s64, *_), (c32, g32, s32, *_) = runs
        ke64 = float(compute_diag(s64, g64, c64).avke)
        ke32 = float(compute_diag(s32, g32, c32).avke)
        rows.append({
            "step": i + 1,
            "zeta": drift(_host(s64.zeta), _host(s32.zeta)),
            "u": drift(_host(s64.u), _host(s32.u)),
            "temp": drift(_host(s64.t[0]), _host(s32.t[0])),
            "ke_rel": abs(ke32 - ke64) / max(abs(ke64), 1e-300),
        })
        r = rows[-1]
        say(f"{name} step {i + 1:4d}: zeta {r['zeta']:.3e}  u {r['u']:.3e}  "
            f"temp {r['temp']:.3e}  KE rel {r['ke_rel']:.3e}  "
            f"({time.perf_counter() - t0:.1f} s)")
    return rows


def main(argv=None):
    p = argparse.ArgumentParser(
        prog="python -m roms_tpu_torch.precision_study",
        description="float32 against float64 trajectories, side by side")
    p.add_argument("nsteps", nargs="?", type=int, default=200)
    p.add_argument("--cases", nargs="+", choices=sorted(CASES),
                   default=list(DEFAULT_CASES))
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU instead of the CUDA device")
    p.add_argument("--out", default="PRECISION_DATA_torch.json")
    args = p.parse_args(argv)

    device = resolve_device("cpu" if args.cpu else "cuda")
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        # the card's name and power limit as nvidia-smi prints them
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True, timeout=60).stdout.strip()
        dev = {"type": "cuda", "name": torch.cuda.get_device_name(0),
               "count": torch.cuda.device_count(), "smi": smi}
    else:
        dev = {"type": "cpu", "name": "cpu", "count": 1, "smi": None}
    print(f"precision_study: torch {torch.__version__} on {dev['name']}"
          + (f" ({dev['smi']})" if dev["smi"] else ""), flush=True)

    out = {"device": dev, "torch": torch.__version__, "nsteps": args.nsteps,
           "shapes": {}, "seconds": {}, "rows": {}}
    for name in args.cases:
        cfg = CASES[name][0]()
        t0 = time.perf_counter()
        out["rows"][name] = study(name, maker(name, device), args.nsteps,
                                  device)
        out["seconds"][name] = time.perf_counter() - t0
        out["shapes"][name] = [cfg.nx, cfg.ny, cfg.nz, cfg.nt]
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    print(f"wrote {args.out}", flush=True)
    return out


if __name__ == "__main__":
    main()
