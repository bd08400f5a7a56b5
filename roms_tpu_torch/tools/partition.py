"""partit / ncjoin: split and join whole-grid NetCDF files over an
NP_XI x NP_ETA processor grid (a numpy copy of roms_tpu/tools/partition.py
on the port's `io.netcdf`; reference: Tools-Roms/partit.F,
Tools-Roms/ncjoin.F, Tools-Roms/ncjoin_mpi.F).

The model itself reads whole-grid files directly (roms_tpu_torch.io.input), so
these tools exist for interoperability with reference workflows: producing
per-rank inputs for the Fortran model and re-assembling per-rank outputs.

Conventions follow the reference:
  * partitionable dims: xi_rho, xi_u, eta_rho, eta_v
    (reference: partit.F:290-345)
  * each per-node file carries the global int attribute
    `partition = [node, nnodes, xi_start, eta_start]` (1-based start of
    the node's block inside the global xi_rho/eta_rho index space;
    reference: partit.F:473-480)
  * non-partitionable variables are copied redundantly into every file
    (reference: partit.F:34-39)

The block decomposition mirrors partit's mpi_setup: interior nodes get
ceil(LLm/NP) interior points and the first/last nodes absorb the remainder
and the physical boundary ring (reference: partit.F mpi_setup).
`ncjoin` trusts each file's `partition` attribute and actual dimension
sizes, so it reassembles any consistently-written partition.
"""

from __future__ import annotations

import os
from typing import Dict, List, Tuple

import numpy as np

from roms_tpu_torch.io.netcdf import NCWriter, open_dataset

PART_X = ("xi_rho", "xi_u")
PART_E = ("eta_rho", "eta_v")


def node_blocks(np_xi: int, np_eta: int, llm: int, mmm: int):
    """Per-node interior blocks: list of (inode, jnode, i0, i1, j0, j1)
    with 0-based global INTERIOR indices [i0, i1) (reference:
    partit.F mpi_setup block sizing: interior = ceil(n/np), edges absorb
    the remainder)."""
    def split(n, p):
        base = (n + p - 1) // p
        off = p * base - n
        # distribute: first node loses off//2, last loses (off+1)//2
        sizes = [base] * p
        sizes[0] -= off // 2
        sizes[-1] -= (off + 1) // 2
        starts = np.concatenate([[0], np.cumsum(sizes)[:-1]])
        return list(zip(starts.tolist(), sizes))

    xs = split(llm, np_xi)
    es = split(mmm, np_eta)
    out = []
    for jn in range(np_eta):
        for in_ in range(np_xi):
            i0, isz = xs[in_]
            j0, jsz = es[jn]
            out.append((in_, jn, i0, i0 + isz, j0, j0 + jsz))
    return out


def _var_slices(dims: Tuple[str, ...], blk, np_xi, np_eta, llm, mmm):
    """Global index slice per dim for one node, handling staggered dims and
    boundary-ring attachment on edge nodes."""
    in_, jn, i0, i1, j0, j1 = blk
    sl = []
    for d in dims:
        if d == "xi_rho":       # global size llm+2, interior at 1..llm
            a = i0 + 1 - (1 if in_ == 0 else 0)
            b = i1 + 1 + (1 if in_ == np_xi - 1 else 0)
            sl.append(slice(a, b))
        elif d == "xi_u":       # global size llm+1, u points 1..llm+1->0..llm
            a = i0
            b = i1 + (1 if in_ == np_xi - 1 else 0)
            sl.append(slice(a, b))
        elif d == "eta_rho":
            a = j0 + 1 - (1 if jn == 0 else 0)
            b = j1 + 1 + (1 if jn == np_eta - 1 else 0)
            sl.append(slice(a, b))
        elif d == "eta_v":
            a = j0
            b = j1 + (1 if jn == np_eta - 1 else 0)
            sl.append(slice(a, b))
        else:
            sl.append(slice(None))
    return tuple(sl)


def partit(path: str, np_xi: int, np_eta: int,
           out_dir: str | None = None) -> List[str]:
    """Split one whole-grid file into np_xi*np_eta per-node files named
    <stem>.<node>.nc (reference: partit.F)."""
    with open_dataset(path) as ds:
        if "partition" in ds.attrs:
            raise ValueError(f"{path} is already a partitioned file")
        dims = ds.dimensions
        if "xi_rho" in dims:
            llm = dims["xi_rho"] - 2
        elif "xi_u" in dims:
            llm = dims["xi_u"] - 1
        else:
            raise ValueError(f"{path}: no partitionable xi dimension")
        if "eta_rho" in dims:
            mmm = dims["eta_rho"] - 2
        elif "eta_v" in dims:
            mmm = dims["eta_v"] - 1
        else:
            raise ValueError(f"{path}: no partitionable eta dimension")

        stem, ext = os.path.splitext(path)
        if out_dir:
            stem = os.path.join(out_dir, os.path.basename(stem))
        blocks = node_blocks(np_xi, np_eta, llm, mmm)
        nnodes = np_xi * np_eta
        names = []
        for node, blk in enumerate(blocks):
            in_, jn = blk[0], blk[1]
            fname = f"{stem}.{node}{ext or '.nc'}"
            names.append(fname)
            # per-node dimension sizes from a probe slice
            dimsz: Dict[str, int] = dict(dims)
            for d in ("xi_rho", "xi_u", "eta_rho", "eta_v"):
                if d in dims:
                    s = _var_slices((d,), blk, np_xi, np_eta, llm, mmm)[0]
                    dimsz[d] = s.stop - s.start
            # 1-based global start of this node's xi_rho/eta_rho block
            xi_start = (blk[2] + 1 - (1 if in_ == 0 else 0)) + 1
            eta_start = (blk[4] + 1 - (1 if jn == 0 else 0)) + 1
            attrs = dict(ds.attrs)
            attrs["partition"] = np.asarray(
                [node, nnodes, xi_start, eta_start], np.int32)
            rec_dim = next((k for k, v in dims.items() if v in (-1, None)
                            or k in ("time", "ocean_time")), None)
            with NCWriter(fname, attrs) as w:
                for dname, dsz in dimsz.items():
                    w.create_dim(dname,
                                 None if dname == rec_dim else int(dsz))
                # every variable defined before the first write (the
                # writer fixes its layout there)
                for vname, var in ds.variables.items():
                    w.create_var(vname, var.dims,
                                 np.dtype(var.dtype).str[1:], var.attrs)
                for vname, var in ds.variables.items():
                    sl = _var_slices(var.dims, blk, np_xi, np_eta, llm, mmm)
                    _put(w, vname, var, np.asarray(var[...])[sl], rec_dim)
    return names


def _put(w: NCWriter, vname: str, var, data, rec_dim):
    """Write one variable, a record variable record by record."""
    if rec_dim is not None and var.dims and var.dims[0] == rec_dim:
        for r in range(data.shape[0]):
            w.write(vname, data[r], rec=r)
    else:
        w.write(vname, data)


def _open_parts(paths: List[str]):
    """The per-node datasets sorted by node, with their `partition`
    attributes; the global dimension sizes (max over nodes of start - 1
    + local size), the record dimension and the global attributes."""
    parts = []
    for p in paths:
        ds = open_dataset(p)
        if "partition" not in ds.attrs:
            raise ValueError(f"{p}: missing 'partition' attribute")
        parts.append((np.asarray(ds.attrs["partition"], np.int64), ds))
    parts.sort(key=lambda t: t[0][0])
    nnodes = int(parts[0][0][1])
    if len(parts) != nnodes:
        raise ValueError(f"need {nnodes} files, got {len(parts)}")

    def gsize(dim_rho: str, start_col: int):
        return max(int(a[start_col] - 1) + ds.dimensions[dim_rho]
                   for a, ds in parts if dim_rho in ds.dimensions)

    dims0 = dict(parts[0][1].dimensions)
    gdims = dict(dims0)
    if "xi_rho" in dims0:
        gdims["xi_rho"] = gsize("xi_rho", 2)
        gdims["xi_u"] = gdims["xi_rho"] - 1
    if "eta_rho" in dims0:
        gdims["eta_rho"] = gsize("eta_rho", 3)
        gdims["eta_v"] = gdims["eta_rho"] - 1
    rec_dim = next((k for k in dims0 if k in ("time", "ocean_time")), None)
    attrs = {k: v for k, v in parts[0][1].attrs.items() if k != "partition"}
    return parts, gdims, rec_dim, attrs


def _block_slices(var, attr):
    """The slice of the global canvas one node's variable fills: xi_u
    blocks start one left of xi_rho except in node column 0 (eta_v
    likewise)."""
    xi0 = int(attr[2]) - 1
    eta0 = int(attr[3]) - 1
    sl = []
    for d, s in zip(var.dims, var.shape):
        if d in PART_X:
            off = xi0 if d == "xi_rho" else (xi0 - 1 if xi0 > 0 else 0)
            sl.append(slice(off, off + s))
        elif d in PART_E:
            off = eta0 if d == "eta_rho" else (eta0 - 1 if eta0 > 0 else 0)
            sl.append(slice(off, off + s))
        else:
            sl.append(slice(None))
    return tuple(sl)


def _canvas(var0, gdims, rec_dim):
    return np.zeros(tuple(s if d == rec_dim else gdims.get(d, s)
                          for d, s in zip(var0.dims, var0.shape)),
                    np.dtype(var0.dtype))


def _partitioned(var) -> bool:
    return any(d in PART_X + PART_E for d in var.dims)


def _create(parts, gdims, rec_dim, attrs, out_path) -> NCWriter:
    w = NCWriter(out_path, attrs)
    for dname, dsz in gdims.items():
        w.create_dim(dname, None if dname == rec_dim else int(dsz))
    for vname, var0 in parts[0][1].variables.items():
        w.create_var(vname, var0.dims, np.dtype(var0.dtype).str[1:],
                     var0.attrs)
    return w


def ncjoin(paths: List[str], out_path: str) -> str:
    """Join per-node files back into one whole-grid file
    (reference: Tools-Roms/ncjoin.F).  Placement uses each file's
    `partition` attribute + its actual dimension sizes; one variable's
    canvas is resident at a time."""
    parts, gdims, rec_dim, attrs = _open_parts(paths)
    try:
        with _create(parts, gdims, rec_dim, attrs, out_path) as w:
            for vname, var0 in parts[0][1].variables.items():
                if not _partitioned(var0):
                    _put(w, vname, var0, np.asarray(var0[...]), rec_dim)
                    continue
                canvas = _canvas(var0, gdims, rec_dim)
                for attr, ds in parts:
                    canvas[_block_slices(ds[vname], attr)] = np.asarray(
                        ds[vname][...])
                _put(w, vname, var0, canvas, rec_dim)
    finally:
        for _, ds in parts:
            ds.close()
    return out_path


def ncjoin_parallel(paths: List[str], out_path: str,
                    workers: int | None = None) -> str:
    """Parallel join: the `ncjoin_mpi` role (reference:
    Tools-Roms/ncjoin_mpi.F:1-40; documented 8-16x speedups over serial
    ncjoin, Documentation/readme-tools/readme.ncjoin_mpi:46-48).

    Same semantics and the same bytes as `ncjoin`, parallel at (variable,
    node file) granularity: the classic-netcdf reader holds each part in
    memory, so concurrent read-only jobs need no locks; each job converts
    its node's block (the big-endian -> native byteswap + copy that
    dominates serial ncjoin) into its disjoint slice of a preallocated
    global canvas.  The canvases then go to the writer in order.  All
    canvases are resident at once: peak memory is the joined file's
    size."""
    from concurrent.futures import ThreadPoolExecutor

    if workers is None:
        workers = min(16, (os.cpu_count() or 1) * 2)
    parts, gdims, rec_dim, attrs = _open_parts(paths)
    try:
        variables = parts[0][1].variables
        canvases = {v: _canvas(var0, gdims, rec_dim)
                    for v, var0 in variables.items() if _partitioned(var0)}

        def fill(job):
            vname, (attr, ds) = job
            canvases[vname][_block_slices(ds[vname], attr)] = np.asarray(
                ds[vname][...])

        with ThreadPoolExecutor(workers) as ex:
            list(ex.map(fill, [(v, p) for v in canvases for p in parts]))
        with _create(parts, gdims, rec_dim, attrs, out_path) as w:
            for vname, var0 in variables.items():
                _put(w, vname, var0, canvases.get(vname, np.asarray(
                    var0[...])), rec_dim)
    finally:
        for _, ds in parts:
            ds.close()
    return out_path


def nc3to4z(path: str, out_path: str, complevel: int = 4) -> str:
    """NetCDF-3 -> compressed NetCDF-4/HDF5: the port's
    `tools/nc3to4z.convert` (reference: Tools-Roms/nc3to4z.F)."""
    from roms_tpu_torch.tools.nc3to4z import convert
    return convert(path, out_path, level=complevel)


def _main(argv=None):
    import argparse
    p = argparse.ArgumentParser(prog="roms_tpu_torch.tools.partition")
    sub = p.add_subparsers(dest="cmd", required=True)
    sp = sub.add_parser("partit", help="split whole-grid files (partit.F)")
    sp.add_argument("np_xi", type=int)
    sp.add_argument("np_eta", type=int)
    sp.add_argument("files", nargs="+")
    sj = sub.add_parser("ncjoin", help="join per-node files (ncjoin.F)")
    sj.add_argument("out")
    sj.add_argument("files", nargs="+")
    sz = sub.add_parser("nc3to4z", help="compress to NetCDF4 (nc3to4z.F)")
    sz.add_argument("infile")
    sz.add_argument("outfile")
    a = p.parse_args(argv)
    if a.cmd == "partit":
        for f in a.files:
            for name in partit(f, a.np_xi, a.np_eta):
                print(name)
    elif a.cmd == "ncjoin":
        print(ncjoin(a.files, a.out))
    else:
        print(nc3to4z(a.infile, a.outfile))
    return 0


if __name__ == "__main__":
    import sys
    sys.exit(_main())
