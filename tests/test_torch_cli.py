"""The port's command line, `python -m roms_tpu_torch case.in`, against the
JAX package's, on the closed obc_basin inputs of tests/test_cli.py
(16x12x6, nt=1, 3 steps, float64, history every step):

(a) `main([..., "--cpu", "--f64"])` of each package in this process:
    the same history and restart variables, dims and attributes (apart
    from `type` and `git_hash`), values within the 3-step tolerance of
    tests/torch_helpers.py (5e-11 * max(1, max|ref|));
(b) one `python -m roms_tpu_torch ... --cpu` subprocess exits 0 and
    prints the run_time banner;
(c) without `--cpu`, on a host with no CUDA device, it exits non-zero,
    says why, and writes nothing: it never falls back to the CPU.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from roms_tpu.__main__ import main as jmain
from roms_tpu.cases import obc_basin
from roms_tpu.io import HistoryWriter, write_grid

from roms_tpu_torch.__main__ import main as tmain
from roms_tpu_torch.io.netcdf import open_dataset

from torch_helpers import PACKAGE_ATTRS

torch.set_num_threads(1)

STEP_TOL = 5e-11
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

IN_TEMPLATE = """\
title:
   CLI smoke test

time_stepping: NTIMES   dt[sec]  NDTFAST  NINFO
               3        60       20       1

S-coord: THETA_S,   THETA_B,    hc (m)
          3.0D0        0.0D0     50.0D0

rho0:
      1000.

lateral_visc:   VISC2
                 0.

gamma2:
                  1.D0

tracer_diff2: TNU2
 0.

bottom_drag:     RDRG [m/s],  RDRG2,  Zob [m]
                  0.          1.0E-3   1.E-2

lin_rho_eos:  Tcoef    T0    Scoef   S0
              0.20   1.0   0.822  1.0

grid:  filename
     {grid}

initial: NRREC  filename
          0
     {init}

output_root_name:
     {root}
"""

ARGS = ["--nx", "16", "--ny", "12", "--nz", "6", "--nt", "1", "--f64",
        "--nhis", "1"]


def _inputs(tmp_path, tag):
    """Grid and initial files written by the JAX package (as
    tests/test_cli.py does) and a .in whose output root is `tag`."""
    gpath, ipath = str(tmp_path / "grid.nc"), str(tmp_path / "init.nc")
    if not os.path.exists(gpath):
        cfg = obc_basin.config("closed", ntimes=3).replace(
            nx=16, ny=12, nz=6, nt=1, dt=60.0, ndtfast=20)
        grid, st, _ = obc_basin.setup(cfg)
        write_grid(gpath, grid, cfg)
        hw = HistoryWriter(ipath, grid, cfg, dtype="f8")
        hw.write(st)
        hw.close()
    infile = str(tmp_path / f"{tag}.in")
    root = str(tmp_path / tag)
    with open(infile, "w") as f:
        f.write(IN_TEMPLATE.format(grid=gpath, init=ipath, root=root))
    return infile, root


def _env():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = ROOT
    return env


def test_cli_matches_jax(tmp_path, capsys):
    jin, jroot = _inputs(tmp_path, "jax")
    tin, troot = _inputs(tmp_path, "port")
    assert jmain([jin] + ARGS) == 0
    assert tmain([tin] + ARGS + ["--cpu"]) == 0
    out = capsys.readouterr().out
    assert "roms_tpu_torch :: CLI smoke test" in out and "run_time" in out
    for suffix in ("_his.nc", "_rst.nc"):
        with open_dataset(troot + suffix) as a, \
                open_dataset(jroot + suffix) as b:
            assert a.dimensions == b.dimensions
            assert {k: v for k, v in a.attrs.items()
                    if k not in PACKAGE_ATTRS} == \
                {k: v for k, v in b.attrs.items() if k not in PACKAGE_ATTRS}
            assert sorted(a.variables) == sorted(b.variables)
            for n in b.variables:
                assert (a[n].dims, a[n].attrs) == (b[n].dims, b[n].attrs), n
                x, y = np.asarray(a[n][...]), np.asarray(b[n][...])
                scale = max(1.0, float(np.abs(y).max()))
                np.testing.assert_allclose(x, y, rtol=0,
                                           atol=STEP_TOL * scale,
                                           err_msg=f"{suffix} {n}")
    with open_dataset(troot + "_his.nc") as ds:
        assert ds["zeta"].shape[0] == 3
        assert np.isfinite(ds["zeta"][...]).all()


def test_cli_subprocess(tmp_path):
    infile, root = _inputs(tmp_path, "sub")
    res = subprocess.run(
        [sys.executable, "-m", "roms_tpu_torch", infile] + ARGS + ["--cpu"],
        capture_output=True, text=True, timeout=600, cwd=str(tmp_path),
        env=_env())
    assert res.returncode == 0, res.stderr + res.stdout
    assert "run_time" in res.stdout
    with open_dataset(root + "_his.nc") as ds:
        assert ds["zeta"].shape[0] == 3
    with open_dataset(root + "_rst.nc") as ds:
        assert int(ds["iic"][0]) == 3


def test_cli_refuses_without_a_card(tmp_path):
    """Without --cpu the run is on the card; where there is none it stops
    before reading anything and never falls back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device: the run would use it")
    infile, root = _inputs(tmp_path, "nocard")
    res = subprocess.run(
        [sys.executable, "-m", "roms_tpu_torch", infile] + ARGS,
        capture_output=True, text=True, timeout=600, cwd=str(tmp_path),
        env=_env())
    assert res.returncode != 0
    assert "no CUDA device" in res.stderr
    assert "run_time" not in res.stdout
    assert not os.path.exists(root + "_his.nc")
    assert not os.path.exists(root + "_rst.nc")
