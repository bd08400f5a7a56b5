"""The control of `correct`: the plain reference put in the program's
place, in the nearest precision below the configuration's, judged as a
run of the program is judged.

    python3 bench_h100/control.py --workload <cell> --seeds 1 2 3 \\
        [--seconds <run seconds>] [--precisions bfloat16 bfloat16-state]

For each seed it makes the cell's raw inputs, runs the float64 reference
through the calls of an untraced run of `--seconds` (warm-up, window),
then the reference again from the same raw inputs in each of
`--precisions`, and prints one JSON line for each: every compared number
beside the cell's limit, and whether the cell would judge it correct.  The
configuration states float32; none of the step's operations is a matrix
product, so TF32 changes nothing, and bfloat16 is the nearest precision
below that changes the result.  The benchmark's own runs do not run it.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import dataclasses  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


PRECISIONS = ("bfloat16", "bfloat16-state", "bfloat16-prognostic")
# the prognostic fields, which a program could keep in bfloat16 between
# steps while it derives the rest in float32
PROGNOSTIC = ("zeta", "ubar", "vbar", "u", "v", "t", "u_prev", "v_prev",
              "t_prev")


def cast(obj, dtype):
    """`obj` with every floating tensor in `dtype`: a tensor, or a state,
    grid or forcing dataclass and the dataclasses and dicts inside it."""
    import torch
    if isinstance(obj, torch.Tensor):
        return obj.to(dtype) if obj.is_floating_point() else obj
    if dataclasses.is_dataclass(obj):
        return obj.replace(**{f.name: cast(getattr(obj, f.name), dtype)
                              for f in dataclasses.fields(obj)})
    if isinstance(obj, dict):
        return {k: cast(v, dtype) for k, v in obj.items()}
    return obj


def control_readings(name, seed, seconds, precisions=PRECISIONS,
                     device="cuda", model_overrides=None) -> dict:
    """{precision: {number: reading}} of the reference in each lower
    precision against one float64 reference, after the calls of an
    untraced run of `seconds`.  "bfloat16": every array and operation in
    bfloat16 (the state derived in float32, then cast); "bfloat16-state":
    float32 operations with the state rounded to bfloat16 after every
    step, as a program that keeps its state in bfloat16 between steps."""
    import torch

    from bench_h100 import compare, harness, inputs
    from bench_h100.reference.ops.weights import set_weights
    from bench_h100.reference.stepper import step
    cell = harness.load_cell(name)
    device = torch.device(device)
    model = dict(cell.config["model"], **(model_overrides or {}))
    calls = [cell.traffic["warmup_steps"], harness.window_steps(cell,
                                                                 seconds)]
    limits = cell.params["limits"]
    ref = harness.reference_state(cell, model, seed, device, calls)
    lib = inputs.side(inputs.REFERENCE)
    cfg = inputs.model_config(lib, model)
    w1, w2, _ = set_weights(cfg.ndtfast)
    bf16, out = torch.bfloat16, {}
    for precision in precisions:
        raw = cell.maker.raw_inputs(model, seed, device)
        grid, st, frc = cell.maker.derive(lib, cfg, raw, torch.float32,
                                            device)
        del raw
        if precision == "bfloat16":
            grid, st, frc = (cast(grid, bf16), cast(st, bf16),
                             cast(frc, bf16))
        try:
            for n in calls:
                for i in range(n):
                    st = step(st, frc, grid, w1, w2, cfg,
                              first_step=i == 0)
                    if precision == "bfloat16-state":
                        st = cast(cast(st, bf16), torch.float32)
                    elif precision == "bfloat16-prognostic":
                        st = st.replace(**{
                            f: getattr(st, f).to(bf16).to(torch.float32)
                            for f in PROGNOSTIC})
            out[precision] = {f: compare.gap(f, getattr(st, f), ref)
                              for f in limits}
        except (RuntimeError, ValueError, ZeroDivisionError) as err:
            # a control that fails outright is not correct
            print(f"control {name} seed {seed} {precision}: "
                  f"{type(err).__name__}: {err}", file=sys.stderr)
            out[precision] = {f: math.inf for f in limits}
        del grid, st, frc
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--seconds", type=float, default=None)
    p.add_argument("--precisions", choices=PRECISIONS, nargs="+",
                   default=list(PRECISIONS))
    args = p.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    from bench_h100 import harness
    if not torch.cuda.is_available():
        print("control: no CUDA device", file=sys.stderr)
        return 3
    spec = harness.load_json(ROOT / "BENCHMARK.json")
    seconds = args.seconds or spec["run_seconds"]
    limits = harness.load_cell(args.workload).params["limits"]
    for seed in args.seeds:
        t0 = time.perf_counter()
        out = control_readings(args.workload, seed, seconds,
                               args.precisions)
        for precision, r in out.items():
            print(json.dumps({
                "workload": args.workload, "seed": seed,
                "precision": precision, "seconds": seconds,
                "correct": all(r[f] <= limits[f] for f in r),
                "readings": r, "limits": limits,
                "s": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
