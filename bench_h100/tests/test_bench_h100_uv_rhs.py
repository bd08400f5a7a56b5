"""The momentum r.h.s. kernel's frozen counts (counts/uv_rhs.py) against
the bytes `_build.compulsory_bytes` counts for the main path's arguments
at every cell's configuration, and its roofline read from a synthetic
trace: the kernel's launches by name, none on a program without it."""

import types

import pytest
import torch

from bench_h100 import harness, inputs, peaks, trace

CELLS = [w["name"] for w in harness.load_json(harness.ROOT
                                              / "BENCHMARK.json")["workloads"]]


def _run(cell, tr):
    c = harness.load_cell(cell)
    cfg = inputs.model_config(inputs.side(inputs.PROGRAM), c.config["model"])
    return harness.Run(cell=c, cfg=cfg, elem=4, setup_s=1.0, window_steps=10,
                       window_s=2.0, peak_bytes=2**30, trace=tr)


@pytest.mark.parametrize("cell", CELLS)
def test_frozen_counts_match_the_wrapper(cell):
    from roms_tpu_torch.ops import _build
    cfg = _run(cell, None).cfg.replace(nx=12, ny=10)
    counts = harness.load_module(harness.BENCH / "counts" / "uv_rhs.py")
    jy, ix, nz = cfg.ny + 2 * cfg.halo, cfg.nx + 2 * cfg.halo, cfg.nz

    def z(*shape):
        return torch.zeros(shape, dtype=torch.float32)
    curv = cfg.curvgrid and cfg.uv_adv
    reads = (z(nz, jy, ix), z(nz, jy, ix), z(nz, jy, ix), z(nz, jy, ix),
             z(nz, jy, ix), z(nz + 1, jy, ix), z(jy, ix)) + (
        (z(jy, ix), z(jy, ix)) if curv else ()) + (
        (z(jy, ix), z(jy, ix)) if cfg.masking and cfg.uv_adv else ())
    assert counts.launch_bytes(cfg, 4) == _build.compulsory_bytes(
        reads, (z(nz, jy, ix), z(nz, jy, ix)))
    assert counts.bound_s(cfg, 4) == peaks.bound_s(
        150 * nz * jy * ix, counts.launch_bytes(cfg, 4), 4)[0]


def test_roofline_reads_the_kernel_by_name():
    tr = trace.Trace(window_s=10e-3, steps=2)
    tr.device = [
        ("void (anonymous namespace)::uv_rhs_kernel<true, float>"
         "((anonymous namespace)::Args<float>)", 1e-3, 3e-3, "kernel"),
        ("void (anonymous namespace)::uv_rhs_kernel<false, float>"
         "((anonymous namespace)::Args<float>)", 4e-3, 6e-3, "kernel"),
        ("tracer_stage_kernel<float>", 6e-3, 7e-3, "kernel")]
    run = _run("production-920x480x60", tr)
    counts = harness.load_module(harness.BENCH / "counts" / "uv_rhs.py")
    read = harness.load_module(harness.BENCH / "metrics"
                               / "roofline.uv_rhs.py").read
    assert read(run) == pytest.approx(
        100.0 * 2 * counts.bound_s(run.cfg, 4) / 4e-3)
    tr.device = tr.device[2:]
    assert read(run) is None
    assert read(types.SimpleNamespace(trace=None)) is None
