"""The frozen reference is the port's plain path: in float64 on the CPU,
where the port's kernel wrappers take their plain versions too, both
sides agree from the same raw inputs through the run's call sequence."""

import pytest
import torch

from bench_h100 import harness, inputs

SMALL = {"filament-512x256x60": dict(nx=32, ny=32, nz=8),
         "production-384x192x60": dict(nx=24, ny=16, nz=8, nt=4)}
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
