"""The metric arithmetic on synthetic inputs: the union of device
intervals and the idle share, idle gaps by host span, launches, a
roofline from the frozen counts, throughput; and the frozen counts
against the port's own wrappers at the cells' shapes."""

import types

import pytest
import torch

from bench_h100 import harness, inputs, peaks, readers, trace

CELLS = ("filament-512x256x60", "production-384x192x60",
         "production-920x480x60")


def synthetic_trace():
    # a 10 ms window of 2 steps: kernels overlap in [1, 3] ms, then a gap
    # under the fast loop's span, a copy, and a gap with no span open
    tr = trace.Trace(window_s=10e-3, steps=2)
    tr.device = [("tracer_stage_kernel<float>", 1e-3, 2e-3, "kernel"),
                 ("momentum_solve_kernel<float>", 1.5e-3, 3e-3, "kernel"),
                 ("void k_column<float>(Args<float>)", 4e-3, 5e-3, "kernel"),
                 ("void k_profile<float>(Args<float>)", 5e-3, 5.5e-3,
                  "kernel"),
                 ("Memcpy HtoD", 7e-3, 8e-3, "gpu_memcpy")]
    tr.spans = [("barotropic.fast_loop", 3e-3, 3.8e-3),
                ("eos.rho_eos", 5.6e-3, 6.8e-3)]
    return tr


def run_of(cell_name, tr, window_steps=10, window_s=2.0):
    cell = harness.load_cell(cell_name)
    cfg = inputs.model_config(inputs.side(inputs.PROGRAM),
                              cell.config["model"])
    return harness.Run(cell=cell, cfg=cfg, elem=4, setup_s=1.0,
                       window_steps=window_steps, window_s=window_s,
                       peak_bytes=3 * 2**30, trace=tr)


def read(name, run):
    return harness.load_module(harness.BENCH / "metrics"
                               / f"{name}.py").read(run)


def test_union_and_idle_share():
    tr = synthetic_trace()
    assert tr.busy_intervals() == [(1e-3, 3e-3), (4e-3, 5.5e-3),
                                   (7e-3, 8e-3)]
    assert tr.busy_s() == pytest.approx(4.5e-3)
    run = run_of(CELLS[1], tr)
    assert read("device_idle_share", run) == pytest.approx(55.0)
    assert read("launches_per_step", run) == 2.0


def test_idle_gaps_by_host_span():
    idle = synthetic_trace().idle_by_span()
    assert idle["barotropic.fast_loop"] == pytest.approx(1e-3)
    assert idle["eos.rho_eos"] == pytest.approx(1.5e-3)
    assert idle[trace.OTHER_HOST] == pytest.approx(1e-3 + 2e-3)
    bd = synthetic_trace().breakdown()
    assert bd["idle_gaps"][0] == [trace.OTHER_HOST, pytest.approx(3e-3)]
    assert len(bd["device_ops"]) == 5


def test_span_time_per_step():
    run = run_of(CELLS[0], synthetic_trace())
    assert read("fast_loop_host_ms", run) == pytest.approx(0.4)


def test_roofline_from_counts():
    tr = synthetic_trace()
    run = run_of(CELLS[1], tr)
    kpp = harness.load_module(harness.BENCH / "counts" / "kpp_vmix.py")
    # one call: k_column + k_profile, 1.5 ms on the device
    assert readers.roofline(run, "kpp_vmix") == pytest.approx(
        100.0 * kpp.bound_s(run.cfg, 4) / 1.5e-3)
    solve = harness.load_module(harness.BENCH / "counts"
                                / "momentum_solve.py")
    assert read("roofline.momentum_solve", run) == pytest.approx(
        100.0 * solve.bound_s(run.cfg, 4) / 1.5e-3)
    # no launch of a kernel, or no trace: nothing to read, never 0
    tr.device = [d for d in tr.device if "tracer" not in d[0]]
    assert read("roofline.tracer_stage", run) is None
    assert read("roofline.tracer_stage", run_of(CELLS[1], None)) is None


def test_throughput_and_step_share():
    run = run_of(CELLS[0], synthetic_trace(), window_steps=10, window_s=2.0)
    assert read("mpoint_steps_per_s", run) == pytest.approx(
        512 * 256 * 60 * 10 / 2.0 / 1e6)
    assert read("peak_mem_gib", run) == pytest.approx(3.0)
    step = harness.load_module(harness.BENCH / "counts" / "step.py")
    bound, by = step.bound_s(run.cfg, 4)
    assert by == "bytes"
    assert read("step_mfu", run) == pytest.approx(100.0 * bound / 5e-3)


@pytest.mark.parametrize("cell", CELLS)
def test_frozen_kernel_counts_match_the_wrappers(cell):
    from roms_tpu_torch.ops import cuda_kpp, cuda_solve
    run = run_of(cell, None)
    cfg = run.cfg
    jy, ix, nz = cfg.ny + 2 * cfg.halo, cfg.nx + 2 * cfg.halo, cfg.nz
    col = jy * ix
    solve = harness.load_module(harness.BENCH / "counts"
                                / "momentum_solve.py")
    assert solve.bound_s(cfg, 4) == peaks.bound_s(
        10 * nz * col, cuda_solve.launch_bytes(nz, jy, ix, 4, True), 4)[0]
    kpp = harness.load_module(harness.BENCH / "counts" / "kpp_vmix.py")
    assert kpp.bound_s(cfg, 4) == peaks.bound_s(
        100 * nz * col, cuda_kpp.launch_bytes(nz, jy, ix, 4, cfg.salinity,
                                              cfg.masking), 4)[0]


@pytest.mark.parametrize("cell", CELLS)
def test_frozen_tracer_counts_match_the_wrapper(cell):
    """The predictor's and the corrector's bytes as `_build.
    compulsory_bytes` counts the main path's arguments (distinct
    tensors, the previous tracer level distinct from the present)."""
    from roms_tpu_torch.ops import _build
    from roms_tpu_torch.stepper import tracer_mix
    cfg = run_of(cell, None).cfg.replace(nx=12, ny=10)
    counts = harness.load_module(harness.BENCH / "counts"
                                 / "tracer_stage.py")
    jy, ix = cfg.ny + 2 * cfg.halo, cfg.nx + 2 * cfg.halo
    nt, nz = cfg.nt, cfg.nz

    def z(*shape):
        return torch.zeros(shape, dtype=torch.float32)
    imix = max(cfg.i_t_and_s, 1)
    akt = z(cfg.i_t_and_s, nz + 1, jy, ix)
    common = (z(nt, nz, jy, ix), z(nt, nz, jy, ix), z(nz, jy, ix),
              z(nz, jy, ix), z(nz, jy, ix), z(nz, jy, ix), z(nz + 1, jy, ix),
              z(nz + 1, jy, ix), akt[:imix], z(jy, ix), z(jy, ix), z(jy, ix),
              z(jy, ix))
    out = (z(nt, nz, jy, ix),)
    assert counts.launch_bytes(cfg, 4, "pred") == _build.compulsory_bytes(
        common, out)
    grid = types.SimpleNamespace(diff2=None, pmon_u=z(jy, ix),
                                 pnom_v=z(jy, ix), h=z(jy, ix))
    mix = tracer_mix(grid, cfg, z(1))
    extra = (z(nt, jy, ix),) + (tuple(mix.values()) if mix else ())
    assert counts.launch_bytes(cfg, 4, "corr") == _build.compulsory_bytes(
        common + extra, out)
