"""The frozen reference is the port's plain path: in float64 on the CPU,
where the port's kernel wrappers take their plain versions too, both
sides agree from the same raw inputs through the run's call sequence."""

import math
import types

import pytest
import torch

from bench_h100 import compare, harness, inputs

SMALL = {"filament-512x256x60": dict(nx=32, ny=32, nz=8),
         "production-384x192x60": dict(nx=24, ny=16, nz=8, nt=4),
         "production-920x480x60": dict(nx=24, ny=16, nz=8, nt=4)}
FIELDS = ("zeta", "ubar", "vbar", "u", "v", "t", "z_w", "hz", "we", "wi",
          "rho", "akv", "akt", "hbls", "hbbl", "du_avg1", "du_avg2")


@pytest.mark.parametrize("name", sorted(SMALL))
def test_reference_follows_the_port_in_float64(name):
    cell = harness.load_cell(name)
    model = dict(cell.config["model"], **SMALL[name])
    calls = [cell.traffic["warmup_steps"], 2]
    prog = inputs.side(inputs.PROGRAM)
    cfg = inputs.model_config(prog, model)
    grid, st, frc = cell.maker.derive(
        prog, cfg, cell.maker.raw_inputs(model, 11, "cpu"), torch.float64,
        "cpu")
    for n in calls:
        st = prog.run(grid, st, frc, cfg, n)
    ref = harness.reference_state(cell, model, 11, torch.device("cpu"),
                                  calls)
    for f in FIELDS:
        a, r = getattr(st, f), getattr(ref, f)
        assert a.dtype == r.dtype == torch.float64
        scale = max(1.0, float(r.abs().max()))
        assert float((a - r).abs().max()) <= 1e-12 * scale, f
    assert int(ref.iic) == sum(calls)


def test_reference_modules_are_not_the_program():
    ref = inputs.side(inputs.REFERENCE)
    for name in ("config", "grid", "vcoord", "state", "kinematics", "eos",
                 "kpp", "halo"):
        assert getattr(ref, name).__name__.startswith("bench_h100.reference")


BLOCKED = dict(nx=24, ny=16, nz=8, nt=7)


def blocked_run(monkeypatch, tracers_a_block):
    """Two steps (the LF-AM3 start and an AM3 step: two predictors and two
    correctors) of the reference at BLOCKED, in blocks of
    `tracers_a_block` tracers."""
    from bench_h100.reference import stepper
    cell = harness.load_cell("production-920x480x60")
    model = dict(cell.config["model"], **BLOCKED)
    jy, ix = model["ny"] + 2 * model["halo"], model["nx"] + 2 * model["halo"]
    one = model["nz"] * jy * ix * 8
    monkeypatch.setattr(stepper, "TRACER_BLOCK_BYTES",
                        tracers_a_block * one)
    blocks = stepper.tracer_blocks(
        model["nt"], torch.empty((model["nz"], jy, ix), dtype=torch.float64,
                                 device="meta"))
    return blocks, harness.reference_state(cell, model, 2**31 + 5,
                                           torch.device("cpu"), [2])


def test_blocked_reference_is_bitwise_one_pass(monkeypatch):
    """Blocks of 3 of the 7 tracers (3, 3, 1) give every array of one
    pass over all 7, bit for bit."""
    blocks, one = blocked_run(monkeypatch, 7)
    assert blocks == [slice(0, 7)]
    blocks, three = blocked_run(monkeypatch, 3)
    assert blocks == [slice(0, 3), slice(3, 6), slice(6, 7)]
    for f in FIELDS + ("t_prev", "hbbl", "flx_u", "dv_avg2"):
        assert torch.equal(getattr(one, f), getattr(three, f)), f


def test_tracer_blocks_at_the_cells_sizes():
    """At most 1 GiB a block: the 920x480x60 grid's 34 float64 tracers in
    blocks of 5; one block for Filament's one tracer."""
    from bench_h100.reference import stepper

    def blocks(nt, nx, ny, nz=60):
        like = torch.empty((nz, ny + 4, nx + 4), dtype=torch.float64,
                           device="meta")
        return [b.stop - b.start for b in stepper.tracer_blocks(nt, like)]
    assert blocks(34, 920, 480) == [5] * 6 + [4]
    assert blocks(1, 512, 256) == [1]
    assert blocks(4, 24, 16, 8) == [4]


def gap_in_one_pass(name, got, ref_state):
    """compare.gap as it read before it took one component at a time:
    every array converted to float64 whole."""
    ref = getattr(ref_state, name).to(torch.float64)
    got = got.to(dtype=torch.float64)
    speed = 0.0
    if name in compare.SPEEDS:
        speed = max(float(getattr(ref_state, f).abs().max())
                    for f in compare.SPEEDS[name])
    where = None
    if name in compare.BOUNDARY_LAYER:
        where = ref_state.z_w >= -ref_state.hbls
    if name in compare.COMPONENTS:
        return max(compare._one(name, got[i], ref[i], speed, where)
                   for i in range(ref.shape[0]))
    return compare._one(name, got, ref, speed, where)


@pytest.mark.parametrize("name", ["zeta", "ubar", "u", "t", "akv", "akt",
                                  "hbls"])
def test_gap_by_component_reads_as_one_pass(name):
    gen = torch.Generator().manual_seed(3)
    nz, jy, ix = 6, 10, 12
    shapes = {"zeta": (jy, ix), "ubar": (jy, ix), "vbar": (jy, ix),
              "u": (nz, jy, ix), "v": (nz, jy, ix), "t": (5, nz, jy, ix),
              "akv": (nz + 1, jy, ix), "akt": (2, nz + 1, jy, ix),
              "hbls": (jy, ix)}
    ref = {f: torch.randn(s, generator=gen, dtype=torch.float64)
           for f, s in shapes.items()}
    ref["hbls"] = ref["hbls"].abs() * 50.0
    ref["z_w"] = -100.0 * torch.rand((nz + 1, jy, ix), generator=gen,
                                     dtype=torch.float64)
    ref_state = types.SimpleNamespace(**ref)
    got = (ref[name] + 1e-3 * torch.randn(ref[name].shape, generator=gen,
                                          dtype=torch.float64)).float()
    assert compare.gap(name, got, ref_state) == gap_in_one_pass(
        name, got, ref_state)
    got[(0,) * got.dim()] = float("nan")
    assert compare.gap(name, got, ref_state) == math.inf
