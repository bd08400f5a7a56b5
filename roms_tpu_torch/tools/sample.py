"""Post-hoc sampling / depth-slicing of history files (a numpy copy of
roms_tpu/tools/sample.py)
(reference: Tools-Roms/sample.F and Tools-Roms/zslice.F +
sigma_to_z_intr.F — offline extraction of variables at fixed depths or
point sets from written output).

CLI:
  python -m roms_tpu_torch.tools.sample hist.nc --var temp --depths 10 100
  python -m roms_tpu_torch.tools.sample hist.nc --var temp --points 10.5,20 30,40.25
"""

from __future__ import annotations

import argparse
import sys

import numpy as np


def _zslice_np(f3, z_r3, depths):
    """Linear interpolation of (nz, ny, nx) f to fixed depths [m, >0 down]
    (reference: Tools-Roms/sigma_to_z_intr.F); NaN below the bottom."""
    nz = f3.shape[0]
    out = np.full((len(depths),) + f3.shape[1:], np.nan, np.float64)
    for d_i, d in enumerate(depths):
        zt = -abs(d)
        # find bracketing levels per column
        below = (z_r3 <= zt).sum(axis=0)        # levels below target
        k0 = np.clip(below - 1, 0, nz - 2)
        k1 = k0 + 1
        jj, ii = np.meshgrid(np.arange(f3.shape[1]),
                             np.arange(f3.shape[2]), indexing="ij")
        z0 = z_r3[k0, jj, ii]
        z1 = z_r3[k1, jj, ii]
        w = np.where(z1 != z0, (zt - z0) / (z1 - z0), 0.0)
        val = (1 - w) * f3[k0, jj, ii] + w * f3[k1, jj, ii]
        ok = (zt >= z_r3[0]) & (zt <= z_r3[-1])
        out[d_i] = np.where(ok, val, np.nan)
    return out


def _ipslice_np(f3, rho3, sigmas):
    """Interpolate (nz, ny, nx) f onto constant-density (sigma-t-like)
    surfaces (reference: Tools-Roms/zslice.F "ipslice" invocation name:
    the same program interpolates to isopycnals when given rho targets).
    rho decreases upward (k=0 is the sea floor here); NaN where the
    surface outcrops or grounds."""
    nz = f3.shape[0]
    out = np.full((len(sigmas),) + f3.shape[1:], np.nan, np.float64)
    jj, ii = np.meshgrid(np.arange(f3.shape[1]), np.arange(f3.shape[2]),
                         indexing="ij")
    for s_i, sg in enumerate(sigmas):
        # levels denser than the target, counted from the bottom
        denser = (rho3 >= sg).sum(axis=0)
        k0 = np.clip(denser - 1, 0, nz - 2)
        k1 = k0 + 1
        r0 = rho3[k0, jj, ii]
        r1 = rho3[k1, jj, ii]
        w = np.where(r1 != r0, (sg - r0) / (r1 - r0), 0.0)
        val = (1 - w) * f3[k0, jj, ii] + w * f3[k1, jj, ii]
        ok = (sg <= rho3[0]) & (sg >= rho3[-1])
        out[s_i] = np.where(ok, val, np.nan)
    return out


def _bilinear(f2, px, py):
    i0 = np.clip(np.floor(px).astype(int), 0, f2.shape[-1] - 2)
    j0 = np.clip(np.floor(py).astype(int), 0, f2.shape[-2] - 2)
    x = px - i0
    y = py - j0
    return ((1 - y) * ((1 - x) * f2[..., j0, i0] + x * f2[..., j0, i0 + 1])
            + y * ((1 - x) * f2[..., j0 + 1, i0]
                   + x * f2[..., j0 + 1, i0 + 1]))


def main(argv=None):
    from roms_tpu_torch.io.netcdf import NCWriter, open_dataset

    p = argparse.ArgumentParser(
        description="Sample/slice a roms_tpu_torch history file "
                    "(reference: Tools-Roms sample + zslice)")
    p.add_argument("histfile")
    p.add_argument("--var", required=True)
    p.add_argument("--sigmas", nargs="*", type=float, default=[],
                   help="isopycnal targets (density anomaly values of the "
                        "'rho' variable) -> <var>.ipslice.nc")
    p.add_argument("--depths", nargs="*", type=float, default=[],
                   help="depths [m] for horizontal slices")
    p.add_argument("--points", nargs="*", default=[],
                   help="fractional i,j index pairs, e.g. 10.5,20")
    p.add_argument("--rec", type=int, default=-1)
    p.add_argument("-o", "--out", default=None)
    a = p.parse_args(argv)

    with open_dataset(a.histfile) as ds:
        nrec = ds[a.var].shape[0]
        rec = a.rec % nrec
        f = np.asarray(ds[a.var][rec], np.float64)
        if a.depths:
            if "z_r" in ds:
                z_r = np.asarray(ds["z_r"][rec], np.float64)
            else:
                # reconstruct from zeta-free rest state: h + uniform sigma
                h = np.asarray(ds["h"][...], np.float64)
                nz = f.shape[0]
                sig = (np.arange(nz) + 0.5) / nz - 1.0
                z_r = sig[:, None, None] * h[None]
            sl = _zslice_np(f, z_r, a.depths)
            out = a.out or (a.histfile + f".{a.var}.zslice.nc")
            with NCWriter(out, attrs={"source": a.histfile}) as w:
                w.create_dim("depth", len(a.depths))
                w.create_dim("eta", sl.shape[1])
                w.create_dim("xi", sl.shape[2])
                w.create_var("depth", ("depth",))
                w.write("depth", np.asarray(a.depths, np.float64))
                w.create_var(a.var, ("depth", "eta", "xi"))
                w.write(a.var, sl)
            print(f"wrote {out}")
        if a.sigmas:
            rho = np.asarray(ds["rho"][rec], np.float64)
            sl = _ipslice_np(f, rho, a.sigmas)
            out = a.out or (a.histfile + f".{a.var}.ipslice.nc")
            with NCWriter(out, attrs={"source": a.histfile}) as w:
                w.create_dim("sigma", len(a.sigmas))
                w.create_dim("eta", sl.shape[1])
                w.create_dim("xi", sl.shape[2])
                w.create_var("sigma", ("sigma",))
                w.write("sigma", np.asarray(a.sigmas, np.float64))
                w.create_var(a.var, ("sigma", "eta", "xi"))
                w.write(a.var, sl)
            print(f"wrote {out}")
        if a.points:
            px = np.asarray([float(s.split(",")[0]) for s in a.points])
            py = np.asarray([float(s.split(",")[1]) for s in a.points])
            vals = _bilinear(f, px, py)
            for k, (x, y) in enumerate(zip(px, py)):
                v = vals[..., k] if vals.ndim > 1 else vals[k]
                print(f"({x},{y}): {np.array2string(np.atleast_1d(v), precision=6)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
