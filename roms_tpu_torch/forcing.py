"""Time-dependent forcing-data engine, the `ncforce` equivalent (port of
roms_tpu/forcing.py; reference: src/roms_read_write.F:59-83 ncforce type,
:303-652 set_frc_data_*, :654-827 find_new_record).

Host-side machinery in numpy float64: each forcing variable is a `Series`
holding a record time axis and a lazy per-record reader with a two-slot
cache.  `value(t)` returns the linearly time-interpolated field (or the
raw slot for non-interpolating point data), advancing the slots as model
time passes record boundaries and wrapping periodically when the variable
carries a cycle length.  A `ForcingSet` bundles surface, boundary and
point series and materializes the per-step `Forcing` on the experiment's
device: one `torch.as_tensor` per field.  The step never blocks on NetCDF
I/O beyond the record refresh, which a background read hides.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np
import torch

from roms_tpu_torch.config import ModelConfig
from roms_tpu_torch.state import BoundaryData, Forcing, zero_forcing

DAY = 86400.0


class Series:
    """Two-slot time-interpolated record series
    (reference: roms_read_write.F:319-390)."""

    def __init__(self, times: np.ndarray, read_rec: Callable[[int], np.ndarray],
                 cycle: Optional[float] = None, interp: bool = True,
                 name: str = "?", prefetch: bool = True):
        self.times = np.asarray(times, np.float64)
        if self.times.ndim != 1 or self.times.size < 1:
            raise ValueError(f"{name}: bad time axis")
        self.read_rec = read_rec
        self.cycle = cycle
        self.interp = interp
        self.name = name
        self.prefetch = prefetch
        self._slot_idx = [-1, -1]
        self._slot_data = [None, None]
        self._pending = {}           # record index -> Future (background read)

    def _read_locked(self, i: int) -> np.ndarray:
        # imported here: the io package's readers import this module
        from roms_tpu_torch.io.async_io import IO_LOCK
        with IO_LOCK:
            return np.asarray(self.read_rec(i), np.float64)

    def _schedule(self, i: int) -> None:
        """Start a background read of record i (the record the model will
        need next) so crossing the boundary never stalls the step loop
        (the reference blocks per rank instead, roms_read_write.F:319-390)."""
        if not self.prefetch or self.times.size <= 1:
            return
        i = int(i) % self.times.size
        if i in self._slot_idx or i in self._pending:
            return
        from roms_tpu_torch.io.async_io import read_pool
        self._pending[i] = read_pool().submit(self._read_locked, i)

    def _rec(self, i: int) -> np.ndarray:
        i = int(i) % self.times.size
        if i == self._slot_idx[0]:
            return self._slot_data[0]
        if i == self._slot_idx[1]:
            return self._slot_data[1]
        fut = self._pending.pop(i, None)
        if fut is not None and fut.exception() is None:
            data = fut.result()
        else:   # no prefetch (or it failed, e.g. racing a close): read now
            data = self._read_locked(i)
        # overwrite the stale slot (the one whose index is farther behind)
        s = 0 if self._slot_idx[0] <= self._slot_idx[1] else 1
        self._slot_idx[s] = i
        self._slot_data[s] = data
        return data

    def _bracket(self, t: float):
        times = self.times
        n = times.size
        if self.cycle:
            tm = t % self.cycle
            i2 = int(np.searchsorted(times, tm, side="right"))
            i1 = i2 - 1
            t1 = times[i1 % n] - (self.cycle if i1 < 0 else 0.0)
            t2 = times[i2 % n] + (self.cycle if i2 >= n else 0.0)
            return i1 % n, i2 % n, tm, t1, t2
        i2 = int(np.clip(np.searchsorted(times, t, side="right"), 1, n - 1))
        i1 = i2 - 1
        return i1, i2, t, times[i1], times[i2]

    def value(self, t: float) -> np.ndarray:
        if self.times.size == 1:
            return self._rec(0)
        i1, i2, tm, t1, t2 = self._bracket(t)
        if not self.interp:
            # hold the current record until the next one is reached
            # (reference: cdr_frc.opt time_interpolation=False semantics)
            self._schedule(i2)                  # next record to be held
            return self._rec(i1)
        n = self.times.size
        if self.cycle or i2 + 1 < n:
            self._schedule(i2 + 1)              # background-read ahead
        d1, d2 = self._rec(i1), self._rec(i2)
        if t2 <= t1:
            return d1
        w2 = (tm - t1) / (t2 - t1)
        w2 = float(np.clip(w2, 0.0, 1.0))
        return (1.0 - w2) * d1 + w2 * d2


def series_from_dataset(ds, varname: str, time_name: Optional[str] = None,
                        scale: float = 1.0, time_in_days: bool = True,
                        interp: bool = True) -> Series:
    """Build a Series from an open `NCDataset` following ROMS forcing-file
    conventions: the variable's record dim names its time coordinate; time
    in days; an optional `cycle_length` attribute on the time variable makes
    it periodic (reference: roms_read_write.F units/cycling logic)."""
    var = ds[varname]
    tname = time_name or var.dims[0]
    tvar = ds[tname]
    fac = DAY if time_in_days else 1.0
    times = np.asarray(tvar[...], np.float64) * fac
    cyc = tvar.attrs.get("cycle_length")
    cycle = float(np.asarray(cyc).reshape(())) * fac if cyc is not None else None

    def read(i):
        return np.asarray(var[i], np.float64) * scale

    return Series(times, read, cycle=cycle, interp=interp, name=varname)


def _pad_offset(size: int, n: int, h: int) -> int:
    """Padded-layout offset for a physical axis of `size` points on an
    interior of `n`: ROMS joined-file shapes are n+2 (rho incl. boundary
    ring, Fortran 0..n+1 -> py 1), n+1 (staggered u/v, Fortran 1..n+1 ->
    py 2), or n (bare interior, Fortran 1..n -> py 2)."""
    if size == n + 2:
        return h - 1
    if size in (n + 1, n):
        return h
    raise ValueError(f"axis size {size} does not fit interior {n}")


def pad_field(a: np.ndarray, cfg: ModelConfig) -> np.ndarray:
    """Embed an unpadded physical-grid field (ROMS joined-file shapes) into
    the padded compute layout, edge-replicated into the remaining ghosts."""
    h = cfg.halo
    jy, ix = cfg.ny + 2 * h, cfg.nx + 2 * h
    out_shape = a.shape[:-2] + (jy, ix)
    out = np.zeros(out_shape, a.dtype)
    ny, nx = a.shape[-2], a.shape[-1]
    j0 = _pad_offset(ny, cfg.ny, h)
    i0 = _pad_offset(nx, cfg.nx, h)
    out[..., j0:j0 + ny, i0:i0 + nx] = a
    # replicate edges outward
    for j in range(j0 - 1, -1, -1):
        out[..., j, :] = out[..., j + 1, :]
    for j in range(j0 + ny, jy):
        out[..., j, :] = out[..., j - 1, :]
    for i in range(i0 - 1, -1, -1):
        out[..., :, i] = out[..., :, i + 1]
    for i in range(i0 + nx, ix):
        out[..., :, i] = out[..., :, i - 1]
    return out


def pad_bry(a: np.ndarray, cfg: ModelConfig) -> np.ndarray:
    """Pad a boundary slice along its edge axis to the full padded length."""
    h = cfg.halo
    n = a.shape[-1]
    base = cfg.ny if n in (cfg.ny, cfg.ny + 1, cfg.ny + 2) else cfg.nx
    n_full = base + 2 * h
    out = np.zeros(a.shape[:-1] + (n_full,), a.dtype)
    i0 = _pad_offset(n, base, h)
    out[..., i0:i0 + n] = a
    for i in range(i0 - 1, -1, -1):
        out[..., i] = out[..., i + 1]
    for i in range(i0 + n, n_full):
        out[..., i] = out[..., i - 1]
    return out


def coarse2fine(cdata: np.ndarray, ratio: int = 2,
                gtype: str = "r") -> np.ndarray:
    """Bilinear refinement of coarse-grid forcing data onto a `ratio`-times
    finer grid, in numpy on the host (reference: roms_read_write.F:
    1210-1273 coarse2fine, which hardwires ratio 2; the index map
    generalizes to fine = r*coarse with the staggering offsets of the
    reference: rho +0.25, u/v +0.5).

    cdata: (..., nyc, nxc) coarse interior field; returns
    (..., r*nyc, r*nxc).
    """
    r = float(ratio)
    nyc, nxc = cdata.shape[-2:]
    ny, nx = int(r * nyc), int(r * nxc)
    # reference map (r=2): ic = i/2 + 0.25 (rho) / +0.5 (staggered)
    xi = np.arange(1, nx + 1) / r + (0.5 if gtype == "u" else 0.25) - 1.0
    yj = np.arange(1, ny + 1) / r + (0.5 if gtype == "v" else 0.25) - 1.0
    ic = np.clip(np.floor(xi).astype(int), 0, nxc - 2)
    jc = np.clip(np.floor(yj).astype(int), 0, nyc - 2)
    xl = np.clip(xi - ic, 0.0, 1.0)
    yl = np.clip(yj - jc, 0.0, 1.0)
    c00 = cdata[..., jc[:, None], ic[None, :]]
    c01 = cdata[..., jc[:, None], ic[None, :] + 1]
    c10 = cdata[..., jc[:, None] + 1, ic[None, :]]
    c11 = cdata[..., jc[:, None] + 1, ic[None, :] + 1]
    wx = xl[None, :]
    wy = yl[:, None]
    return ((1 - wy) * ((1 - wx) * c00 + wx * c01)
            + wy * ((1 - wx) * c10 + wx * c11))


class StackSeries:
    """Stack several Series along a new leading axis (tracer boundary data:
    per-tracer `<name>_<edge>` file variables -> one (nt, nz, edge) array,
    reference: boundary.F nc_t_w(itrc) per-tracer readers)."""

    def __init__(self, series, name="stack"):
        self.series = list(series)
        self.name = name

    def value(self, t: float) -> np.ndarray:
        return np.stack([s.value(t) for s in self.series], axis=0)


class DerivedSeries:
    """Pointwise function of other series, evaluated at the same time
    (e.g. pipe_flx = pipe_fraction * pipe_vol[pipe_idx],
    reference: pipe_frc.F:177-182)."""

    def __init__(self, fn: Callable, *parents, name="derived"):
        self.fn = fn
        self.parents = parents
        self.name = name

    def value(self, t: float) -> np.ndarray:
        return self.fn(*[p.value(t) for p in self.parents])


class ForcingSet:
    """Bundle of forcing series -> per-step `Forcing`
    (reference: src/set_forces.F:90-154 dispatch).

    surface: dict name -> Series for any of
        sustr, svstr (kinematic stress [m2/s2]),
        stflx_<i> (tracer-i surface flux), srflx (solar), swflx (freshwater)
    boundary: dict  '<var>_<edge>' -> Series  (var in zeta,ubar,vbar,u,v,t;
        edge in west,east,south,north)
    point: dict Forcing-field name -> Series whose value is placed verbatim
        into that field (riv_vol, riv_trc, pipe_flx, pipe_trc;
        reference: river_frc.F:82-83, pipe_frc.F:71-73 set_frc_data on
        point-source tables)
    Fields are padded/edge-replicated into compute layout on the host and
    copied to `device` in `dtype`, one tensor per field.
    """

    def __init__(self, cfg: ModelConfig, surface: Optional[Dict] = None,
                 boundary: Optional[Dict] = None, point: Optional[Dict] = None,
                 *, dtype: torch.dtype, device: torch.device):
        self.cfg = cfg
        self.surface = surface or {}
        self.boundary = boundary or {}
        self.point = point or {}
        self.dtype = dtype
        self.device = device

    def _tensor(self, a) -> torch.Tensor:
        return torch.as_tensor(a, dtype=self.dtype, device=self.device)

    def at(self, t: float, base: Optional[Forcing] = None) -> Forcing:
        cfg = self.cfg
        f = base if base is not None else zero_forcing(cfg, self.dtype,
                                                       self.device)
        kw = {}
        stflx = None
        for name, s in self.surface.items():
            val = s.value(t)
            val = pad_field(np.atleast_2d(val), cfg) if val.ndim >= 2 \
                else val
            if name.startswith("stflx_"):
                if stflx is None:
                    stflx = f.stflx.clone()
                stflx[int(name.split("_")[1])] = self._tensor(val)
            else:
                kw[name] = self._tensor(val)
        if stflx is not None:
            kw["stflx"] = stflx

        for name, s in self.point.items():
            kw[name] = self._tensor(s.value(t))

        if self.boundary:
            bkw = {name: self._tensor(pad_bry(np.atleast_1d(s.value(t)), cfg))
                   for name, s in self.boundary.items()}
            base_bry = f.bry if f.bry is not None else BoundaryData()
            kw["bry"] = base_bry.replace(**bkw)
        return f.replace(**kw)
