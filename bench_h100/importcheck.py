"""What the benchmark may import.  Names are compared whole, as the part
of a module's name before its first dot: `roms_tpu_torch` begins with
`roms_tpu` and is still not `roms_tpu`.

- `scan()` reads the import statements of every file under bench_h100/:
  none may name JAX, jaxlib, flax or the JAX package `roms_tpu`, and none
  under bench_h100/reference/ may name the program, `roms_tpu_torch`.
- `loaded()` lists the forbidden packages that the running process holds
  in `sys.modules`.
"""

from __future__ import annotations

import ast
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parent
FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "roms_tpu"})
PROGRAM = "roms_tpu_torch"


def top_names(path: Path) -> set:
    """Top-level names of the absolute imports in one source file."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def scan(root: Path = BENCH) -> list:
    """(file, name) of every forbidden import under `root`."""
    bad = []
    for path in sorted(root.rglob("*.py")):
        banned = set(FORBIDDEN)
        if "reference" in path.relative_to(root).parts:
            banned.add(PROGRAM)
        bad += [(str(path.relative_to(root.parent)), n)
                for n in sorted(top_names(path) & banned)]
    return bad


def loaded() -> list:
    """Forbidden top-level packages in this process's sys.modules."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & FORBIDDEN)
