"""The raw inputs: made from the seed, the same for the same seed and
different for another, and without the seed's perturbation the fields of
the port's own analytic cases."""

import pytest
import torch

from bench_h100 import harness, inputs
from roms_tpu_torch.cases import bench_production, filament

SMALL = {"filament": dict(nx=32, ny=32, nz=8),
         "production": dict(nx=24, ny=16, nz=8, nt=4),
         "production-full": dict(nx=24, ny=16, nz=8, nt=4)}
SEEDS = (0, 2**31 + 7, 98765432101)


def small_model(name):
    spec = harness.load_json(harness.BENCH / "configs" / f"{name}.json")
    return dict(spec["model"], **SMALL[name])


def input_module(name):
    return harness.load_module(harness.BENCH / "configs" / f"{name}.py")


@pytest.mark.parametrize("name", sorted(SMALL))
def test_same_seed_same_inputs(name):
    b, model = input_module(name), small_model(name)
    for seed in SEEDS:
        a1 = b.raw_inputs(model, seed, "cpu")
        a2 = b.raw_inputs(model, seed, "cpu")
        assert a1.keys() == a2.keys()
        for k in a1:
            assert torch.equal(a1[k], a2[k]), k
            assert a1[k].dtype == torch.float64


@pytest.mark.parametrize("name", sorted(SMALL))
def test_other_seed_other_inputs(name):
    b, model = input_module(name), small_model(name)
    raws = [b.raw_inputs(model, s, "cpu") for s in SEEDS]
    for i in range(len(raws)):
        for j in range(i + 1, len(raws)):
            assert not torch.equal(raws[i]["t"], raws[j]["t"])
    if name.startswith("production"):
        assert not torch.equal(raws[0]["sustr"], raws[1]["sustr"])
        # the passive tracers are perturbed too
        assert not torch.equal(raws[0]["t"][3], raws[1]["t"][3])


@pytest.mark.parametrize("name,case", [("filament", filament),
                                       ("production", bench_production),
                                       ("production-full", bench_production)])
def test_unperturbed_inputs_are_the_case(name, case, monkeypatch):
    b, model = input_module(name), small_model(name)
    # the module that defines raw_inputs: production-full imports it
    defs = b.raw_inputs.__globals__
    for attr in ("T_PERTURB", "TRACER_PERTURB", "WIND_SHIFT"):
        if attr in defs:
            monkeypatch.setitem(defs, attr, 0.0)
    prog = inputs.side(inputs.PROGRAM)
    cfg = inputs.model_config(prog, model)
    _, st, frc = b.derive(prog, cfg, b.raw_inputs(model, 5, "cpu"),
                          torch.float64, "cpu")
    _, st2, frc2 = case.setup(cfg, dtype=torch.float64, device="cpu")
    for f in ("zeta", "vbar", "v", "t", "z_w", "z_r", "hz", "we", "wi",
              "rho", "flx_u", "flx_v", "dv_avg1", "swrf"):
        a, ref = getattr(st, f), getattr(st2, f)
        assert torch.allclose(a, ref, rtol=1e-12,
                              atol=1e-12 * float(ref.abs().max())), f
    for f in ("sustr", "srflx", "stflx"):
        assert torch.equal(getattr(frc, f), getattr(frc2, f)), f


@pytest.mark.parametrize("name", sorted(SMALL))
def test_perturbation_is_small(name):
    b, model = input_module(name), small_model(name)
    t1 = b.raw_inputs(model, 1, "cpu")["t"]
    t2 = b.raw_inputs(model, 2, "cpu")["t"]
    assert float((t1[0] - t2[0]).abs().max()) <= (
        2 * b.raw_inputs.__globals__["T_PERTURB"])
