"""The port's float32-against-float64 study (roms_tpu_torch.precision_study)
on the CPU:

(a) `drift` equals the root precision_study.drift bit for bit on numpy
    arrays made from a seed;
(b) one step of Filament (64x64x32) through the root precision_study.study
    (the JAX package) and through the port's study, both built from one
    configuration: every field of the two rows within a factor FACTOR of
    each other, each floored at FLOOR (at step 1 both rows are float32
    round-off, which the two packages' step orders its sums differently
    for);
(c) the port's Rivers_ana row at step 1 against PRECISION_DATA.json's
    step-1 row, within the same factor;
(d) main(["--cpu", ...]) writes the rows, the device and the shapes;
(e) main without --cpu on a host with no CUDA device raises rather than
    falling back to the CPU;
(f) a fresh interpreter runs main --cpu for one step with no module of
    jax, jaxlib or roms_tpu imported.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import precision_study as jax_study
from roms_tpu.cases import filament as jfilament

from roms_tpu_torch import precision_study
from roms_tpu_torch.cases import filament as tfilament

from torch_helpers import port_cfg

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# two rows agree where each field, floored at FLOOR, is within FACTOR of
# the other's: the bound chip_smoke.py's phase 16 holds the card's rows to
FACTOR, FLOOR = 10.0, 1e-6


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def assert_rows_agree(got, ref, what):
    assert got["step"] == ref["step"], what
    for f in precision_study.FIELDS:
        a, b = max(got[f], FLOOR), max(ref[f], FLOOR)
        assert np.isfinite(a) and np.isfinite(b), (what, f, a, b)
        assert max(a / b, b / a) <= FACTOR, (
            f"{what} step {got['step']} {f}: {got[f]:.3e} against "
            f"{ref[f]:.3e}")


def test_drift_matches_root_script():
    rng = np.random.default_rng(11)
    for shape in ((8, 12), (4, 9, 7), (2, 3, 10, 6)):
        a64 = rng.standard_normal(shape)
        a32 = (a64 + 1e-6 * rng.standard_normal(shape)).astype(np.float32)
        assert precision_study.drift(a64, a32) == jax_study.drift(a64, a32)
    zero = np.zeros((6, 6))
    assert (precision_study.drift(zero, zero + 1.0)
            == jax_study.drift(zero, zero + 1.0) == 1.0)


def test_filament_step_one_against_jax_study():
    jcfg = jfilament.config()
    tcfg = port_cfg(jcfg)

    def jmake(dtype):
        return (jcfg, *jfilament.setup(jcfg, dtype=dtype))

    def tmake(dtype):
        return (tcfg, *tfilament.setup(tcfg, dtype=dtype, device="cpu"))

    ref = jax_study.study("filament", jmake, 1)
    got = precision_study.study("filament", tmake, 1, "cpu",
                                say=lambda *a: None)
    assert len(got) == len(ref) == 1
    assert_rows_agree(got[0], ref[0], "filament, port against JAX")


def test_rivers_ana_step_one_against_record():
    with open(os.path.join(ROOT, "PRECISION_DATA.json")) as f:
        record = json.load(f)["rivers_ana"][0]
    got = precision_study.study(
        "rivers_ana", precision_study.maker("rivers_ana", "cpu"), 1, "cpu",
        say=lambda *a: None)
    assert got[0]["step"] == 1
    assert_rows_agree(got[0], record, "rivers_ana against "
                      "PRECISION_DATA.json")


def test_main_writes_schema(tmp_path):
    out = tmp_path / "p.json"
    ret = precision_study.main(["--cpu", "--cases", "filament", "--out",
                                str(out), "1"])
    with open(out) as f:
        data = json.load(f)
    assert data == json.loads(json.dumps(ret))
    assert data["device"] == {"type": "cpu", "name": "cpu", "count": 1,
                              "smi": None}
    assert data["nsteps"] == 1
    assert data["shapes"] == {"filament": [64, 64, 32, 1]}
    assert list(data["rows"]) == ["filament"]
    (row,) = data["rows"]["filament"]
    assert set(row) == {"step", *precision_study.FIELDS}
    assert row["step"] == 1
    assert all(np.isfinite(row[f]) for f in precision_study.FIELDS)
    assert data["seconds"]["filament"] > 0


def test_main_without_cpu_needs_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        precision_study.main(["--cases", "filament", "--out",
                              str(tmp_path / "p.json"), "1"])
    assert not (tmp_path / "p.json").exists()


def test_study_imports_no_jax(tmp_path):
    code = (
        "import sys\n"
        "from roms_tpu_torch import precision_study\n"
        f"precision_study.main(['--cpu', '--cases', 'filament', '--out', "
        f"{str(tmp_path / 'p.json')!r}, '1'])\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'roms_tpu')]\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = ROOT
    env["OMP_NUM_THREADS"] = "1"
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().splitlines()[-1] == "ok"
