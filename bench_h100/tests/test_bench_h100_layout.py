"""BENCHMARK.json and the files it names: every configuration, cell and
metric is found by its name, and the file keeps its required shape."""

import json
import re

import pytest

from bench_h100 import harness

SPEC = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in SPEC["workloads"]]


def test_top_level_keys():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["bench_h100"]
    assert SPEC["command"][1] == "bench_h100/run.py"
    assert 1 <= SPEC["run_seconds"] <= 51


def test_check_fits_its_time_with_24_cells():
    runs = 2 + 14 * 24
    total = runs * (SPEC["run_seconds"] + 60) + 24 * 2 * 90 + 1200
    assert total <= 43200


@pytest.mark.parametrize("cfg", SPEC["configs"], ids=lambda c: c["name"])
def test_config_files(cfg):
    assert set(cfg) == {"name", "source", "file", "reduced", "why"}
    assert NAME.match(cfg["name"])
    data = json.loads((harness.ROOT / cfg["file"]).read_text())
    assert data["name"] == cfg["name"] and data["source"] == cfg["source"]
    assert data["reduced"] == cfg["reduced"]
    assert (harness.BENCH / "configs" / f"{cfg['name']}.py").exists()
    assert any(w["config"] == cfg["name"] for w in SPEC["workloads"])


@pytest.mark.parametrize("name", CELLS)
def test_cells_load_by_name(name):
    cell = harness.load_cell(name, SPEC)
    assert cell.entry["chips"] == 1
    assert len(cell.entry["why"]) <= 200
    assert cell.params["steps_per_second"] > 0
    assert cell.traffic["dtype"] in harness.DTYPES
    assert set(cell.params["limits"]) >= {"zeta", "ubar", "vbar", "u", "v",
                                          "t"}
    assert harness.metrics_of(cell, traced=False), "no end-to-end metric"
    assert harness.metrics_of(cell, traced=True), "no per-layer metric"
    names = {m["name"] for m in harness.metrics_of(cell, traced=False)}
    assert "setup_s" in names and len(names) >= 2


@pytest.mark.parametrize(
    "metric", SPEC["end_to_end"] + SPEC["per_layer"],
    ids=lambda m: m["name"])
def test_metric_readers(metric):
    assert NAME.match(metric["name"]) and UNIT.match(metric["unit"])
    assert metric["better"] in ("lower", "higher")
    mod = harness.load_module(harness.BENCH / "metrics"
                              / f"{metric['name']}.py")
    assert mod.UNIT == metric["unit"]
    assert callable(mod.read)
    for cell in metric.get("workloads", []):
        assert cell in CELLS


@pytest.mark.parametrize("metric", SPEC["end_to_end"],
                         ids=lambda m: m["name"])
def test_bounds(metric):
    assert metric["source"] in ("host_clock", "device_trace")
    assert 0.01 <= metric["bound"] <= 0.25


@pytest.mark.parametrize("metric", SPEC["per_layer"],
                         ids=lambda m: m["name"])
def test_per_layer_moves_an_end_to_end_metric(metric):
    assert metric["moves"] in {m["name"] for m in SPEC["end_to_end"]}
    assert metric["source"] in ("device_trace", "program_span",
                                "program_counter", "host_clock")


def test_file_is_small():
    assert len((harness.ROOT / "BENCHMARK.json").read_bytes()) < 64 * 1024
