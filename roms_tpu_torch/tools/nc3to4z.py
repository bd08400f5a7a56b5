"""nc3to4z: convert NetCDF-3 output to compressed NetCDF-4/HDF5 (a copy
of roms_tpu/tools/nc3to4z.py on the port's `io.netcdf`; h5py is
imported only inside `convert`)
(reference: Tools-Roms/nc3to4z.F — "compress ROMS output files").

Writes an HDF5 file in netCDF-4 layout (dimension-scale datasets +
attached scales, gzip-compressed variables) that this package's own
`io.netcdf.open_dataset` (and any netCDF-4 reader) opens directly.

Usage: python -m roms_tpu_torch.tools.nc3to4z file1.nc [file2.nc ...]
           [--level 4] [--suffix .nc4]
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from roms_tpu_torch.io.netcdf import open_dataset


def convert(path: str, out: str, level: int = 4) -> str:
    import h5py

    with open_dataset(path) as ds, h5py.File(out, "w") as f:
        for k, v in ds.attrs.items():
            f.attrs[k] = v
        # dimension-scale datasets (netCDF-4 layout)
        for dname, dsize in ds.dimensions.items():
            n = dsize if (dsize and dsize > 0) else 0
            if n == 0:              # unlimited: actual record count
                for v in ds.variables.values():
                    if v.dims and dname in v.dims:
                        n = max(n, v.shape[v.dims.index(dname)])
            if dname in ds.variables:
                continue            # coordinate variable doubles as scale
            d = f.create_dataset(dname, data=np.zeros(max(n, 1), "f4"))
            d.make_scale(dname)
            d.attrs["NAME"] = np.bytes_(
                f"This is a netCDF dimension but not a netCDF variable."
                f" {n:10d}")
        for vname in ds.variables:
            var = ds[vname]
            data = np.asarray(var[...])
            kw = {}
            if data.ndim > 0 and data.size > 1:
                kw = dict(compression="gzip", compression_opts=level,
                          shuffle=True)
            dset = f.create_dataset(vname, data=data, **kw)
            for k, a in var.attrs.items():
                dset.attrs[k] = a
            if vname in ds.dimensions:
                dset.make_scale(vname)
        for vname in ds.variables:
            dims = ds[vname].dims
            if dims is None:
                continue
            for ax, dname in enumerate(dims):
                if dname == vname or dname not in f:
                    continue
                try:
                    f[vname].dims[ax].attach_scale(f[dname])
                except Exception:
                    pass
    return out


def main(argv=None):
    p = argparse.ArgumentParser(
        prog="nc3to4z",
        description="compress NetCDF-3 ROMS output to NetCDF-4/HDF5 "
                    "(reference: Tools-Roms/nc3to4z.F)")
    p.add_argument("files", nargs="+")
    p.add_argument("--level", type=int, default=4, help="gzip level")
    p.add_argument("--suffix", default=".nc4")
    a = p.parse_args(argv)
    for fp in a.files:
        out = fp + a.suffix
        convert(fp, out, a.level)
        print(f"wrote {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
