"""The port's partit / ncjoin / ncjoin_parallel
(roms_tpu_torch/tools/partition.py) write the same bytes as the JAX
package's tools on the same input (tests/test_tools.py:43,165 hold those
to a round trip): every per-node file, with its `partition` attribute,
and both joined files; the joined file equals the original, variable by
variable.  Two inputs: a grid file of staggered fields (no record
dimension), split 3x2, and a history-like file with record variables in
float32, split 2x2.
"""

import os

import numpy as np
import pytest

from roms_tpu.io.netcdf import NCWriter as JNCWriter
from roms_tpu.tools import partition as jpart

from roms_tpu_torch.io.netcdf import open_dataset
from roms_tpu_torch.tools import partition as tpart


def _grid_file(path, llm=19, mmm=11, nz=4):
    w = JNCWriter(path, {"title": "toolgrid"})
    for d, n in (("xi_rho", llm + 2), ("xi_u", llm + 1), ("eta_rho", mmm + 2),
                 ("eta_v", mmm + 1), ("s_rho", nz)):
        w.create_dim(d, n)
    rng = np.random.default_rng(3)
    for name, dims, shape in (
            ("h", ("eta_rho", "xi_rho"), (mmm + 2, llm + 2)),
            ("u3d", ("s_rho", "eta_rho", "xi_u"), (nz, mmm + 2, llm + 1)),
            ("v3d", ("s_rho", "eta_v", "xi_rho"), (nz, mmm + 1, llm + 2)),
            ("scalar_levels", ("s_rho",), (nz,))):
        w.create_var(name, dims, "f8", {"units": "x"})
        w.write(name, rng.normal(size=shape))
    w.close()


def _history_file(path, nx=20, ny=14, nz=5):
    rng = np.random.default_rng(4)
    w = JNCWriter(path, {"title": "join test"})
    w.create_dim("time", None)
    w.create_dim("s_rho", nz)
    w.create_dim("eta_rho", ny + 2)
    w.create_dim("xi_rho", nx + 2)
    w.create_dim("xi_u", nx + 1)
    w.create_var("ocean_time", ("time",), "f8", {})
    w.create_var("temp", ("time", "s_rho", "eta_rho", "xi_rho"), "f4", {})
    w.create_var("u", ("time", "s_rho", "eta_rho", "xi_u"), "f4", {})
    w.create_var("h", ("eta_rho", "xi_rho"), "f8", {})
    w.write("h", rng.standard_normal((ny + 2, nx + 2)))
    for r in range(3):
        w.write("ocean_time", float(r), rec=r)
        w.write("temp", rng.standard_normal((nz, ny + 2, nx + 2))
                .astype("f4"), rec=r)
        w.write("u", rng.standard_normal((nz, ny + 2, nx + 1))
                .astype("f4"), rec=r)
    w.close()


def _bytes(path):
    with open(path, "rb") as f:
        return f.read()


@pytest.mark.parametrize("make, npx, npe", [(_grid_file, 3, 2),
                                            (_history_file, 2, 2)],
                         ids=["grid_3x2", "history_2x2"])
def test_partit_and_ncjoin_write_the_jax_packages_bytes(tmp_path, make, npx,
                                                        npe):
    src = str(tmp_path / "whole.nc")
    make(src)
    out = {}
    for name, mod in (("jax", jpart), ("port", tpart)):
        d = tmp_path / name
        d.mkdir()
        parts = mod.partit(src, npx, npe, out_dir=str(d))
        ser = mod.ncjoin(parts, str(d / "ser.nc"))
        par = mod.ncjoin_parallel(parts, str(d / "par.nc"), workers=4)
        out[name] = [*parts, ser, par]
    assert len(out["port"]) == npx * npe + 2
    for a, b in zip(out["port"], out["jax"]):
        assert os.path.basename(a) == os.path.basename(b)
        assert _bytes(a) == _bytes(b), os.path.basename(a)
    with open_dataset(out["port"][0]) as ds:
        assert np.asarray(ds.attrs["partition"]).tolist()[:2] == [
            0, npx * npe]
    with open_dataset(src) as orig, open_dataset(out["port"][-1]) as joined:
        assert set(joined.variables) == set(orig.variables)
        for v in orig.variables:
            np.testing.assert_array_equal(np.asarray(joined[v][...]),
                                          np.asarray(orig[v][...]),
                                          err_msg=v)
