"""Run one cell of the benchmark of roms_tpu_torch once, on the machine it
is started on, from the root of a checkout:

    python3 bench_h100/run.py --workload <cell> --seed <n> \\
        --seconds <run seconds> --trace <0|1>

Prints, as the last line of standard output, one JSON object: `correct`,
`attempted`, `failed`, `metrics` (the cell's end-to-end metrics, or with
`--trace 1` its per-layer metrics), `device`, with `--trace 1`
`breakdown`, and last `compared`, each number that decided `correct`
beside its limit; the same numbers are the last lines of standard error.
Exits non-zero, printing no result, where there is no CUDA device or
fewer than the cell asks for, where a file of the benchmark imports JAX,
jaxlib, flax or the JAX package (or the reference imports the program),
or where such a package is loaded once the window has closed.

Every build and kernel cache lives in a fixed directory of the checkout
(build/), where roms_tpu_torch's kernel library is built on the first
run and loaded by later ones.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def cache_dirs():
    """Point every compiler cache a run could touch at build/ inside the
    checkout, at fixed paths, so that only a checkout's first run
    compiles."""
    build = ROOT / "build"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ["CUDA_CACHE_PATH"] = str(build / "cuda_cache")


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    cache_dirs()
    sys.path.insert(0, str(ROOT))
    from bench_h100 import importcheck
    bad = importcheck.scan()
    if bad:
        for path, name in bad:
            print(f"bench_h100: {path} imports {name}", file=sys.stderr)
        return 2

    import torch
    from bench_h100 import harness
    chips = harness.load_cell(args.workload).entry["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"bench_h100: the cell needs {chips} CUDA device(s), this "
              f"machine has {n}", file=sys.stderr)
        return 3
    result = harness.run_cell(args.workload, args.seed, args.seconds,
                              bool(args.trace), T_START)
    leaked = importcheck.loaded()
    if leaked:
        print("bench_h100: the run loaded " + ", ".join(leaked),
              file=sys.stderr)
        return 4
    for name, c in result["compared"].items():
        print(f"compared {name} {c['value']:.6e} limit {c['limit']:.6e}",
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
