"""One run of one cell: set-up, the timed window, the traced window, the
judgement against the plain reference, and the result line.

Everything that belongs to one cell is data, found by name:

- `BENCHMARK.json` (the checkout's root): the cell's configuration,
  traffic and chips, and the metrics it reports;
- `configs/<config>.json`: the ModelConfig as run, its source and cuts;
  `configs/<config>.py`: `raw_inputs(model, seed, device)` and
  `derive(lib, cfg, raw, dtype, device)`;
- `traffic/<traffic>.json`: the step sequence (warm-up, traced steps,
  precision);
- `workloads/<cell>.json`: the window's steps per second of `--seconds`
  and the limit of each compared number;
- `metrics/<metric>.py`: `UNIT` and `read(run)`, which returns the value
  or None where the run holds nothing to read.

A run: the raw inputs from the seed (float64, on the card), the program's
state derived from them in the configuration's precision, the warm-up
(`warmup_steps` through `driver.run`, the first an LF-AM3 start); then the
window, one `driver.run` call of `steps_per_second * seconds` steps
between two synchronizes; with `--trace 1`, one more call of `trace_steps`
steps under the profiler with the layer spans (`trace.py`).  Then the
program's state is freed but for the compared fields, and the plain
reference (`reference/`) derives its own float64 state from the same raw
inputs and replays the same calls; `compare.judge` decides `correct`.
"""

from __future__ import annotations

import gc
import importlib.util
import json
import re
import subprocess
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path

import torch

from bench_h100 import compare, inputs, trace

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
DTYPES = {"float32": torch.float32, "float64": torch.float64}


def load_json(path: Path):
    with open(path) as f:
        return json.load(f)


def load_module(path: Path):
    """A module from a file of the benchmark, by path (names may hold
    dots and dashes)."""
    name = "bench_h100_" + re.sub(r"\W", "_", str(path.relative_to(BENCH)))
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclass
class Cell:
    """Everything one cell's run reads, from its files."""
    name: str
    entry: dict          # the cell's entry in BENCHMARK.json
    config: dict         # configs/<config>.json
    maker: object        # configs/<config>.py
    traffic: dict        # traffic/<traffic>.json
    params: dict         # workloads/<cell>.json
    spec: dict           # BENCHMARK.json


def load_cell(name: str, spec: dict | None = None) -> Cell:
    spec = load_json(ROOT / "BENCHMARK.json") if spec is None else spec
    entries = [w for w in spec["workloads"] if w["name"] == name]
    if len(entries) != 1:
        raise KeyError(f"BENCHMARK.json has no cell {name!r}")
    entry = entries[0]
    cfg = entry["config"]
    return Cell(name=name, entry=entry,
                config=load_json(BENCH / "configs" / f"{cfg}.json"),
                maker=load_module(BENCH / "configs" / f"{cfg}.py"),
                traffic=load_json(BENCH / "traffic"
                                  / f"{entry['traffic']}.json"),
                params=load_json(BENCH / "workloads" / f"{name}.json"),
                spec=spec)


def metrics_of(cell: Cell, traced: bool) -> list:
    """The BENCHMARK.json entries of the metrics this cell reports: its
    end-to-end metrics untraced, its per-layer metrics traced.  A metric
    with a `workloads` list is reported in those cells; one without it
    in every cell (a per-layer one in every cell that reports the
    end-to-end metric it moves)."""
    e2e = [m for m in cell.spec["end_to_end"]
           if cell.name in m.get("workloads", [cell.name])]
    if not traced:
        return e2e
    moved = {m["name"] for m in e2e}
    return [m for m in cell.spec["per_layer"]
            if cell.name in m.get("workloads", [cell.name])
            and ("workloads" in m or m["moves"] in moved)]


@dataclass
class Run:
    """What a metric's reader reads."""
    cell: Cell
    cfg: object                  # the program's ModelConfig
    elem: int                    # bytes of one element in the run
    setup_s: float
    window_steps: int
    window_s: float
    peak_bytes: int              # max_memory_allocated over the window
    trace: trace.Trace | None = None
    extra: dict = field(default_factory=dict)


def read_metrics(entries: list, run: Run) -> dict:
    """{name: {"value", "unit"}} of each metric whose reader finds
    something to read; the others are left out and named on stderr."""
    out = {}
    for m in entries:
        mod = load_module(BENCH / "metrics" / f"{m['name']}.py")
        if mod.UNIT != m["unit"]:
            raise ValueError(f"metric {m['name']}: the reader's unit "
                             f"{mod.UNIT!r} is not {m['unit']!r}")
        value = mod.read(run)
        if value is None:
            print(f"bench_h100: metric {m['name']} found nothing to read "
                  f"in {run.cell.name}", file=sys.stderr)
            continue
        out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def window_steps(cell: Cell, seconds: float) -> int:
    return max(1, round(seconds * cell.params["steps_per_second"]))


def card_description(device, chips: int) -> dict:
    """platform, kind, count and, where nvidia-smi answers, the power
    limit of the card."""
    out = {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
           "count": chips}
    try:
        res = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits", f"--id={device.index or 0}"],
            capture_output=True, text=True, timeout=30)
        out["power_limit_w"] = float(res.stdout.strip())
    except (OSError, ValueError, subprocess.TimeoutExpired):
        out["power_limit_w"] = None
    return out


def run_cell(name: str, seed: int, seconds: float, traced: bool,
             t_start: float, device="cuda", model_overrides=None,
             fault=None) -> dict:
    """One run of the cell; returns the result object (its last key,
    `compared`, holds each number judged beside its limit).

    device, model_overrides and fault exist for the benchmark's own
    tests: a CPU run at a small grid, and a fault planted in the timed
    path (`fault()` plants it and returns a function that undoes it)."""
    cell = load_cell(name)
    device = torch.device(device)
    model = dict(cell.config["model"], **(model_overrides or {}))
    dtype = DTYPES[cell.traffic["dtype"]]
    prog = inputs.side(inputs.PROGRAM)
    cfg = inputs.model_config(prog, model)
    undo = fault() if fault else None
    try:
        # ---- set-up: inputs, the program's derivation, the warm-up
        raw = cell.maker.raw_inputs(model, seed, device)
        grid, st, frc = cell.maker.derive(prog, cfg, raw, dtype, device)
        del raw
        calls = [cell.traffic["warmup_steps"]]
        st = prog.run(grid, st, frc, cfg, calls[0])
        sync(device)
        setup_s = time.perf_counter() - t_start
        setup_peak = 0
        if device.type == "cuda":
            setup_peak = torch.cuda.max_memory_allocated(device)
            torch.cuda.reset_peak_memory_stats(device)

        # ---- the timed window
        n = window_steps(cell, seconds)
        calls.append(n)
        sync(device)
        t0 = time.perf_counter()
        st = prog.run(grid, st, frc, cfg, n)
        sync(device)
        wall = time.perf_counter() - t0
        peak = (torch.cuda.max_memory_allocated(device)
                if device.type == "cuda" else 0)
        run = Run(cell=cell, cfg=cfg, elem=torch.empty((), dtype=dtype)
                  .element_size(), setup_s=setup_s, window_steps=n,
                  window_s=wall, peak_bytes=peak)

        # ---- the traced window
        if traced:
            k = cell.traffic["trace_steps"]
            calls.append(k)
            run.trace, st = trace.profile(
                lambda: prog.run(grid, st, frc, cfg, k), k)
            run.extra["untraced_ms_per_step"] = 1e3 * wall / n
            run.extra["traced_ms_per_step"] = 1e3 * run.trace.window_s / k
            run.extra["trace_reduce_s"] = run.trace.reduce_s
        metrics = read_metrics(metrics_of(cell, traced), run)
    finally:
        if undo is not None:
            undo()
    # ---- the judgement: free the program, replay on the reference
    limits = cell.params["limits"]
    outputs = {f: getattr(st, f) for f in limits}
    del st, grid, frc
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
    t_ref = time.perf_counter()
    ref_state = reference_state(cell, model, seed, device, calls)
    correct, readings = compare.judge(outputs, ref_state, limits)
    del ref_state, outputs
    ref_s = time.perf_counter() - t_ref
    if device.type == "cuda":
        run.extra["reference_peak_bytes"] = torch.cuda.max_memory_allocated(
            device)

    judged = sum(calls[1:])
    result = {"correct": correct, "attempted": judged,
              "failed": 0 if correct else judged, "metrics": metrics}
    if device.type == "cuda":
        result["device"] = card_description(device, cell.entry["chips"])
        result["device"]["memory_peak_bytes"] = max(peak, setup_peak)
    else:
        result["device"] = {"platform": "cpu", "kind": "cpu", "count": 0,
                            "memory_peak_bytes": 0}
    if traced:
        result["device"]["busy_s"] = run.trace.busy_s()
        result["device"]["window_s"] = run.trace.window_s
        result["breakdown"] = run.trace.breakdown()
    result["run"] = {"seed": seed, "calls": calls,
                     "window_ms_per_step": 1e3 * wall / n,
                     "reference_s": ref_s, **run.extra}
    result["compared"] = {k: {"value": v, "limit": lim}
                          for k, (v, lim) in readings.items()}
    return result


def reference_state(cell: Cell, model: dict, seed: int, device, calls):
    """The plain reference's float64 state after the run's calls, from
    raw inputs it makes again from the seed."""
    ref = inputs.side(inputs.REFERENCE)
    cfg = inputs.model_config(ref, model)
    raw = cell.maker.raw_inputs(model, seed, device)
    grid, st, frc = cell.maker.derive(ref, cfg, raw, torch.float64,
                                        device)
    del raw
    # the state rides in a list that lets go of it as a call takes it: a
    # name bound to it would hold the state a call starts from, its t and
    # t_prev (14.6 GB at 920x480x60), to the call's end
    held = [st]
    del st
    for n in calls:
        held.append(ref.run(grid, held.pop(), frc, cfg, n))
    return held.pop()
