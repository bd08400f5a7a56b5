"""Nothing of the benchmark imports JAX or the JAX package, and the
reference imports nothing of the program; names compare whole."""

import sys

from bench_h100 import importcheck


def test_benchmark_files_pass():
    assert importcheck.scan() == []


def test_whole_names(tmp_path):
    (tmp_path / "reference").mkdir()
    (tmp_path / "a.py").write_text(
        "import roms_tpu_torch.ops\nfrom roms_tpu_torch import driver\n"
        "import numpy\n")
    (tmp_path / "b.py").write_text("from roms_tpu.ops import bc\n")
    (tmp_path / "c.py").write_text("import jax.numpy as jnp\n")
    (tmp_path / "reference" / "d.py").write_text(
        "from roms_tpu_torch.ops import kpp\nfrom . import e\n")
    bad = {(p.split("/", 1)[1], n) for p, n in importcheck.scan(tmp_path)}
    assert bad == {("b.py", "roms_tpu"), ("c.py", "jax"),
                   ("reference/d.py", "roms_tpu_torch")}


def test_loaded_compares_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "roms_tpu_torchx", sys)
    assert "roms_tpu" not in importcheck.loaded()
    monkeypatch.setitem(sys.modules, "roms_tpu.config", sys)
    assert "roms_tpu" in importcheck.loaded()
