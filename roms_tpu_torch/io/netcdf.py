"""Self-contained NetCDF layer, no libnetcdf (port of
roms_tpu/io/netcdf.py).

The reference does all I/O through NetCDF-Fortran wrappers
(reference: src/nc_read_write.F:17-340 ncread/ncwrite/nccreate,
src/roms_read_write.F create_file / put_global_atts).  Here:

  * reading: auto-detects classic NetCDF-3 (magic ``CDF``, via
    scipy.io.netcdf_file) and NetCDF-4/HDF5 (magic ``\\x89HDF``, via h5py,
    imported only for such a file), so whole-grid reference input files
    of either flavor load directly, with no `partit` pre-split step.
  * writing: classic NetCDF-3 64-bit-offset via scipy, one file per run
    (sharded arrays are gathered before writing; the per-rank
    PARALLEL_FILES + ncjoin dance of the reference is unnecessary).
"""

from __future__ import annotations

import os
from typing import Any, Dict, Mapping, Optional, Sequence, Tuple

import numpy as np


class NCVar:
    """Uniform variable handle over scipy / h5py backends."""

    def __init__(self, name: str, data, dims: Tuple[str, ...],
                 attrs: Dict[str, Any]):
        self.name = name
        self._data = data
        self.dims = dims
        self.attrs = attrs

    @property
    def shape(self):
        return self._data.shape

    @property
    def dtype(self):
        return self._data.dtype

    def __getitem__(self, idx):
        return np.asarray(self._data[idx])

    def __array__(self, dtype=None):
        a = np.asarray(self._data[...])
        return a.astype(dtype) if dtype is not None else a


class NCDataset:
    """Read-only NetCDF dataset: variables, dimensions, global attrs."""

    def __init__(self, variables: Dict[str, NCVar],
                 dimensions: Dict[str, int], attrs: Dict[str, Any],
                 closer=None):
        self.variables = variables
        self.dimensions = dimensions
        self.attrs = attrs
        self._closer = closer

    def close(self):
        if self._closer is not None:
            self._closer()
            self._closer = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __contains__(self, name):
        return name in self.variables

    def __getitem__(self, name) -> NCVar:
        return self.variables[name]


def _decode(v):
    if isinstance(v, bytes):
        return v.decode("utf-8", "replace")
    if isinstance(v, np.ndarray) and v.dtype.kind == "S":
        return b"".join(v.ravel()).decode("utf-8", "replace")
    return v


def _open_nc3(path: str) -> NCDataset:
    from scipy.io import netcdf_file
    f = netcdf_file(path, "r", mmap=False)
    variables = {}
    for name, var in f.variables.items():
        attrs = {k: _decode(v) for k, v in var._attributes.items()}
        variables[name] = NCVar(name, var.data, tuple(var.dimensions), attrs)
    dims = {k: (v if v is not None else -1) for k, v in f.dimensions.items()}
    attrs = {k: _decode(v) for k, v in f._attributes.items()}
    return NCDataset(variables, dims, attrs, closer=f.close)


def _open_hdf5(path: str) -> NCDataset:
    try:
        import h5py
    except ImportError as e:
        raise ImportError(f"{path} is a NetCDF-4/HDF5 file and reading it "
                          "needs h5py, which is not installed") from e
    f = h5py.File(path, "r")
    variables = {}
    dims: Dict[str, int] = {}

    def visit(name, obj):
        if not isinstance(obj, h5py.Dataset):
            return
        # skip pure dimension-scale datasets with no data role
        attrs = {k: _decode(v) for k, v in obj.attrs.items()}
        dimnames = []
        for i in range(obj.ndim):
            labels = [d.label or f"phony_dim_{i}" for d in (obj.dims[i],)]
            # netCDF4 stores the dim name in the scale
            scale_names = [s.name.split("/")[-1]
                           for s in obj.dims[i].values() or []]
            dimnames.append(scale_names[0] if scale_names else labels[0])
        if attrs.get("CLASS") == "DIMENSION_SCALE" and \
                "NAME" in attrs and str(attrs["NAME"]).startswith(
                    "This is a netCDF dimension but not a netCDF variable"):
            dims[name.split("/")[-1]] = obj.shape[0]
            return
        for dn, sz in zip(dimnames, obj.shape):
            dims.setdefault(dn, sz)
        variables[name.split("/")[-1]] = NCVar(
            name.split("/")[-1], obj, tuple(dimnames),
            {k: v for k, v in attrs.items()
             if k not in ("CLASS", "NAME", "DIMENSION_LIST",
                          "REFERENCE_LIST", "_Netcdf4Dimid",
                          "_Netcdf4Coordinates")})

    f.visititems(visit)
    attrs = {k: _decode(v) for k, v in f.attrs.items()
             if not k.startswith("_NC")}
    return NCDataset(variables, dims, attrs, closer=f.close)


def open_dataset(path: str) -> NCDataset:
    """Open a NetCDF-3 or NetCDF-4(HDF5) file for reading."""
    with open(path, "rb") as fh:
        magic = fh.read(8)
    if magic[:3] == b"CDF":
        return _open_nc3(path)
    if magic[:8] == b"\x89HDF\r\n\x1a\n":
        return _open_hdf5(path)
    raise ValueError(f"{path}: not a NetCDF file (magic={magic[:4]!r})")


class NCWriter:
    """Streaming NetCDF-3 (64-bit offset) writer with one unlimited record
    dimension, mirroring the reference's nccreate/ncwrite layer
    (reference: src/nc_read_write.F:129-232)."""

    def __init__(self, path: str, attrs: Optional[Mapping[str, Any]] = None):
        from scipy.io import netcdf_file
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        self._f = netcdf_file(path, "w", version=2, mmap=False)
        self.path = path
        self._nrec = 0
        self._rec_dim: Optional[str] = None
        for k, v in (attrs or {}).items():
            setattr(self._f, k, v)

    def create_dim(self, name: str, size: Optional[int]):
        self._f.createDimension(name, size)
        if size is None:
            self._rec_dim = name

    def create_var(self, name: str, dims: Sequence[str], dtype="f8",
                   attrs: Optional[Mapping[str, Any]] = None):
        v = self._f.createVariable(name, dtype, tuple(dims))
        for k, a in (attrs or {}).items():
            setattr(v, k, a)
        return v

    def write(self, name: str, data, rec: Optional[int] = None):
        v = self._f.variables[name]
        data = np.asarray(data)
        if rec is None:
            v[...] = data
        else:
            v[rec] = data
            self._nrec = max(self._nrec, rec + 1)

    def sync(self):
        self._f.sync()

    def close(self):
        if self._f is not None:
            self._f.close()
            self._f = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
