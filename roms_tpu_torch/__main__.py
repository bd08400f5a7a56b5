"""Command-line driver: `python -m roms_tpu_torch <case>.in [options]`
(port of roms_tpu/__main__.py; reference: `./roms <file>.in`,
src/main.F:26-52).

Reads the reference-format runtime input file, loads the grid and initial
NetCDF files onto the card (the CPU with `--cpu`), runs the time loop with
the diagnostics log, and writes history and restart output with full
provenance.  Without `--cpu` a host with no CUDA device is an error: the
run never falls back to the CPU.
"""

from __future__ import annotations

import argparse
import sys


def main(argv=None):
    p = argparse.ArgumentParser(
        prog="roms_tpu_torch",
        description="PyTorch/CUDA regional ocean model (UCLA-ROMS "
                    "capabilities)")
    p.add_argument("infile", help="runtime input file (roms.in format)")
    p.add_argument("--nx", type=int, required=True,
                   help="interior grid points in XI (reference: param.opt LLm)")
    p.add_argument("--ny", type=int, required=True,
                   help="interior grid points in ETA (MMm)")
    p.add_argument("--nz", type=int, required=True, help="sigma levels (N)")
    p.add_argument("--nt", type=int, default=2, help="tracer count")
    p.add_argument("--f64", action="store_true",
                   help="run in float64 (reference precision)")
    p.add_argument("--nhis", type=int, default=0,
                   help="history output interval in steps (0 = off)")
    p.add_argument("--nrst", type=int, default=0,
                   help="restart output interval (0 = final only)")
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU instead of the CUDA device")
    args = p.parse_args(argv)

    import torch

    from roms_tpu_torch.audit import check_config
    from roms_tpu_torch.cases import resolve_device
    from roms_tpu_torch.config import ModelConfig
    from roms_tpu_torch.driver import run
    from roms_tpu_torch.io import (HistoryWriter, read_grid, read_init,
                                   write_restart)
    from roms_tpu_torch.io.async_io import make_async_hook
    from roms_tpu_torch.monitor import Timers
    from roms_tpu_torch.runconfig import read_inp
    from roms_tpu_torch.state import zero_forcing

    try:
        device = resolve_device("cpu" if args.cpu else "cuda")
    except RuntimeError:
        raise SystemExit("roms_tpu_torch: no CUDA device (torch.cuda."
                         "is_available() is False); --cpu runs on the "
                         "CPU") from None
    dtype = torch.float64 if args.f64 else torch.float32
    rc = read_inp(args.infile)
    base = ModelConfig(nx=args.nx, ny=args.ny, nz=args.nz, nt=args.nt,
                       salinity=args.nt >= 2, nonlin_eos=args.nt >= 2,
                       ew_periodic=False, ns_periodic=False)
    cfg = rc.apply(base)
    check_config(cfg, strict=True)   # cppcheck/setup-check analog
    title = rc.paths.get("title", "roms_tpu_torch run")
    root = rc.paths.get("output_root", "roms")
    print(f"roms_tpu_torch :: {title}")
    print(f"  grid {cfg.nx}x{cfg.ny}x{cfg.nz}, nt={cfg.nt}, "
          f"dt={cfg.dt}s, ndtfast={cfg.ndtfast}, ntimes={cfg.ntimes}, "
          f"device {device}")

    timers = Timers()
    grid = read_grid(rc.paths["grid"], cfg, dtype=dtype, device=device)
    init = rc.paths.get("initial", "none")
    if init in ("none", ""):
        p.error("analytic initialization requires a case module; "
                "provide an initial file in the .in")
    state = read_init(init, cfg, grid, record=rc.paths.get("nrrec", 0) or -1,
                      dtype=dtype, device=device)
    forcing = zero_forcing(cfg, dtype, device)

    hw = HistoryWriter(f"{root}_his.nc", grid, cfg) if args.nhis else None

    def hook_sync(st, i):
        if hw is not None and i % args.nhis == 0:
            hw.write(st)
        if args.nrst and i % args.nrst == 0:
            write_restart(f"{root}_rst.nc", st, cfg)

    # writers run off-thread so the step loop only enqueues
    # (io/async_io.py; drained by driver.run before returning)
    hook = make_async_hook(hook_sync)

    timers.tic("time_loop")
    state, rows = run(grid, state, forcing, cfg, print_diag=True,
                      step_hook=hook)
    timers.toc("time_loop", sync=state.zeta)
    write_restart(f"{root}_rst.nc", state, cfg)
    if hw is not None:
        hw.close()
    print(timers.banner())
    return 0


if __name__ == "__main__":
    sys.exit(main())
