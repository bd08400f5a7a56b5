"""Model output: history / running-average / restart files (port of
roms_tpu/io/output.py; reference: src/basic_output.F wrt_his/wrt_avg/
wrt_rst_ocean_vars, src/roms_read_write.F create_file + put_global_atts,
src/get_init.F).

Conventions (the JAX package's, so that either package reads the other's
files):
  * history and averages: single precision, ROMS variable names, interior
    plus physical-boundary points: xi_rho = nx+2, xi_u = nx+1,
    eta_rho = ny+2, eta_v = ny+1, as the reference's `ncjoin` produces
    from its per-rank files (reference: set_global_definitions.h:407-450,
    history float32, restart float64).
  * restart: float64, every field of the state on the padded grid, so a
    restarted run is bit-identical to an uninterrupted one in float64: the
    functional-state equivalent of EXACT_RESTART's two-record logic
    (reference: set_global_definitions.h:104-112, get_init.F:58-66; the
    state carries u_prev/t_prev/du_avg* explicitly so one record suffices).
  * provenance: the full config as a JSON global attribute plus the repo
    git hash (reference: put_global_atts roms_read_write.F:1544-1716,
    add_git_hash.F).

Every field is pulled to the host with `host` (`.detach().cpu().numpy()`
for a tensor); on the card each pull waits for the stream.
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
from typing import Optional, Sequence

import numpy as np
import torch

from roms_tpu_torch.cases import resolve_device
from roms_tpu_torch.config import ModelConfig
from roms_tpu_torch.io.netcdf import NCWriter, open_dataset
from roms_tpu_torch.state import OceanState

# physical-region slices on the padded grid (halo=2):
# rho points incl. boundary ring: Fortran 0..n+1 -> py [1:-1]
RHO = slice(1, -1)
# u/v points: Fortran 1..n+1 -> py [2:-1]
UPT = slice(2, -1)

# (name, stagger, long name, units); stagger in {r2,u2,v2,r3,w3,u3,v3}
HIS_MENU = [
    ("zeta", "r2", "free-surface elevation", "meter"),
    ("ubar", "u2", "barotropic XI-velocity", "meter second-1"),
    ("vbar", "v2", "barotropic ETA-velocity", "meter second-1"),
    ("u", "u3", "XI-velocity", "meter second-1"),
    ("v", "v3", "ETA-velocity", "meter second-1"),
    ("w", "w3", "S-coordinate vertical velocity flux (We+Wi)", "meter3 second-1"),
    ("rho", "r3", "density anomaly", "kilogram meter-3"),
    ("akv", "w3", "vertical viscosity", "meter2 second-1"),
    ("hbls", "r2", "KPP surface boundary layer depth", "meter"),
    ("hbbl", "r2", "KPP bottom boundary layer depth", "meter"),
]

TRACER_NAMES = ["temp", "salt"]  # tracer 0, 1; extras are passive_NN


def host(x) -> np.ndarray:
    """A tensor (on any device) or array-like as a numpy array on the
    host."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


_SWAP = sys.byteorder == "little"      # NetCDF-3 data is big-endian


def file_bytes(t: torch.Tensor, dtype: torch.dtype):
    """`t` cast to `dtype` in big-endian byte order, on its way to the
    host as (uint8 host tensor, numpy type, shape, event or None).  On the
    card the device reorders the bytes and the copy into pinned memory
    does not block: wait on the event before reading the bytes."""
    b = t.to(dtype).reshape(-1).view(torch.uint8)
    if _SWAP:
        b = b.reshape(-1, dtype.itemsize).flip(1).reshape(-1)
    np_type = np.dtype({torch.float32: ">f4", torch.float64: ">f8"}[dtype])
    if not b.is_cuda:
        return b.contiguous(), np_type, tuple(t.shape), None
    out = torch.empty(b.numel(), dtype=torch.uint8, pin_memory=True)
    out.copy_(b, non_blocking=True)
    event = torch.cuda.Event()
    event.record()
    return out, np_type, tuple(t.shape), event


def write_file_bytes(nc: NCWriter, raw: dict, rec: Optional[int] = None):
    """Write {variable: `file_bytes(...)`} to `nc` once the copies are
    done (the last event comes after every copy on the stream)."""
    events = [e for *_, e in raw.values() if e is not None]
    if events:
        events[-1].synchronize()
    for name, (b, np_type, shape, _) in raw.items():
        nc.write(name, b.numpy().view(np_type).reshape(shape), rec=rec)


def tracer_name(cfg: ModelConfig, i: int) -> str:
    if i < len(TRACER_NAMES) and (i == 0 or cfg.salinity):
        return TRACER_NAMES[i]
    if cfg.bgc_model != "none" and cfg.n_bgc > 0 and i >= cfg.nt - cfg.n_bgc:
        from roms_tpu_torch.bgc.api import get_model
        try:
            return get_model(cfg.bgc_model).tracer_names[
                i - (cfg.nt - cfg.n_bgc)]
        except (KeyError, IndexError):
            pass
    return f"passive_{i:02d}"


@dataclasses.dataclass(frozen=True)
class TracerMeta:
    """Per-tracer output metadata row (reference: src/tracers.opt:36-67
    wrt_t / wrt_t_avg / t_vname / t_units / t_lname table)."""
    name: str
    long_name: str = ""
    units: str = ""
    wrt: bool = True          # write to history files
    wrt_avg: bool = True      # write to averages files


_KNOWN_META = {
    "temp": ("potential temperature", "Celsius"),
    "salt": ("salinity", "PSU"),
}


def tracer_table(cfg: ModelConfig):
    """Default per-tracer metadata table: temp/salt with physical units,
    BGC tracers named from the registered model (mmol m-3), the rest
    passive.  Writers accept a user-supplied table to override names,
    units, or the wrt/wrt_avg flags (reference: tracers.opt USER INPUT 2)."""
    rows = []
    nbgc0 = cfg.nt - cfg.n_bgc if cfg.bgc_model != "none" else cfg.nt
    for i in range(cfg.nt):
        nm = tracer_name(cfg, i)
        if nm in _KNOWN_META:
            ln, un = _KNOWN_META[nm]
        elif i >= nbgc0:
            ln, un = f"{nm} concentration", "mmol meter-3"
        else:
            ln, un = f"passive tracer {i}", ""
        rows.append(TracerMeta(name=nm, long_name=ln, units=un))
    return rows


def git_hash() -> str:
    """The checkout's commit, or "unknown" outside a git checkout."""
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    try:
        return subprocess.run(
            ["git", "rev-parse", "HEAD"], capture_output=True, text=True,
            timeout=5, cwd=root).stdout.strip() or "unknown"
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def provenance_attrs(cfg: ModelConfig) -> dict:
    d = dataclasses.asdict(cfg)
    for k, v in list(d.items()):
        if hasattr(v, "value"):
            d[k] = v.value
    return {
        "type": "roms_tpu_torch output file",
        "config": json.dumps(d),
        "git_hash": git_hash(),
    }


def _stagger_slices(stagger: str):
    if stagger.startswith("u"):
        return (RHO, UPT)
    if stagger.startswith("v"):
        return (UPT, RHO)
    return (RHO, RHO)


def _dims_for(stagger: str):
    ydim = "eta_v" if stagger.startswith("v") else "eta_rho"
    xdim = "xi_u" if stagger.startswith("u") else "xi_rho"
    if stagger.endswith("3"):
        zdim = "s_w" if stagger.startswith("w") else "s_rho"
        return ("time", zdim, ydim, xdim)
    return ("time", ydim, xdim)


class HistoryWriter:
    """Streaming history (or snapshot) file
    (reference: basic_output.F:273-419 wrt_his_ocean_vars)."""

    def __init__(self, path: str, grid, cfg: ModelConfig,
                 menu: Optional[Sequence] = None, dtype: str = "f4",
                 extra_attrs: Optional[dict] = None,
                 tracers: Optional[Sequence["TracerMeta"]] = None):
        self.cfg = cfg
        self.dtype = dtype
        menu = list(menu if menu is not None else HIS_MENU)
        # per-tracer metadata/flag table (reference: tracers.opt wrt_t /
        # t_vname / t_units / t_lname); wrt False drops the variable
        self.tracers = list(tracers) if tracers is not None \
            else tracer_table(cfg)
        self._trc_index = {}
        avg = isinstance(self, AverageWriter)
        for i, tm in enumerate(self.tracers):
            if not (tm.wrt_avg if avg else tm.wrt):
                continue
            self._trc_index[tm.name] = i
            menu.append((tm.name, "r3", tm.long_name or f"tracer {i}",
                         tm.units))
        self.menu = menu
        attrs = provenance_attrs(cfg)
        attrs.update(extra_attrs or {})
        self.nc = NCWriter(path, attrs)
        self.nc.create_dim("time", None)
        self.nc.create_dim("s_rho", cfg.nz)
        self.nc.create_dim("s_w", cfg.nz + 1)
        self.nc.create_dim("eta_rho", cfg.ny + 2)
        self.nc.create_dim("eta_v", cfg.ny + 1)
        self.nc.create_dim("xi_rho", cfg.nx + 2)
        self.nc.create_dim("xi_u", cfg.nx + 1)
        self.nc.create_var("ocean_time", ("time",), "f8",
                           {"long_name": "time since initialization",
                            "units": "second"})
        for name, stg, lname, units in self.menu:
            self.nc.create_var(name, _dims_for(stg), dtype,
                               {"long_name": lname, "units": units})
        # static grid fields for self-describing output
        self.nc.create_var("h", ("eta_rho", "xi_rho"), "f8",
                           {"long_name": "bathymetry", "units": "meter"})
        self.nc.write("h", host(grid.h)[RHO, RHO])
        self.rec = 0

    def _tensor(self, state: OceanState, name: str) -> torch.Tensor:
        if name == "w":
            return state.we + state.wi
        if name in self._trc_index:
            return state.t[self._trc_index[name]]
        return getattr(state, name)

    def _field(self, state: OceanState, name: str) -> np.ndarray:
        return host(self._tensor(state, name))

    def write(self, state: OceanState):
        """Append one record of `state`.  The device slices each field,
        casts it to the file's type and puts it in the file's big-endian
        byte order; the bytes are copied without blocking into pinned host
        memory, and the host waits once for all of them and writes them as
        they are.  The record thus holds the GIL only while it issues that
        work, so a writer thread (`io.async_io.make_async_hook`) leaves
        the host to the step loop."""
        dtype = {4: torch.float32, 8: torch.float64}[
            np.dtype(self.dtype).itemsize]
        raw = {"ocean_time": file_bytes(state.time, torch.float64)}
        for name, stg, _, _ in self.menu:
            jsl, isl = _stagger_slices(stg)
            raw[name] = file_bytes(self._tensor(state, name)[..., jsl, isl],
                                   dtype)
        write_file_bytes(self.nc, raw, rec=self.rec)
        self.rec += 1
        self.nc.sync()

    def close(self):
        self.nc.close()


class AverageWriter(HistoryWriter):
    """Running time averages written every `navg` steps
    (reference: basic_output.F calc_avg/wrt_avg_ocean_vars)."""

    def __init__(self, path: str, grid, cfg: ModelConfig, navg: int,
                 **kw):
        super().__init__(path, grid, cfg, **kw)
        self.navg = navg
        self._acc = None
        self._count = 0

    def accumulate(self, state: OceanState):
        fields = {name: self._field(state, name).astype(np.float64)
                  for name, *_ in self.menu}
        fields["ocean_time"] = float(state.time)
        if self._acc is None:
            self._acc = fields
        else:
            for k, v in fields.items():
                self._acc[k] = self._acc[k] + v
        self._count += 1
        if self._count == self.navg:
            self._flush()

    def _flush(self):
        inv = 1.0 / self._count
        self.nc.write("ocean_time", self._acc["ocean_time"] * inv,
                      rec=self.rec)
        for name, stg, _, _ in self.menu:
            jsl, isl = _stagger_slices(stg)
            self.nc.write(name,
                          (self._acc[name] * inv)[..., jsl, isl]
                          .astype(self.dtype), rec=self.rec)
        self.rec += 1
        self.nc.sync()
        self._acc = None
        self._count = 0


def write_grid(path: str, grid, cfg: ModelConfig):
    """Write a ROMS-convention grid file (reference: src/grid.F:231-290
    grid-output nccreate section): rho-grid fields incl. boundary ring."""
    nc = NCWriter(path, provenance_attrs(cfg))
    nc.create_dim("eta_rho", cfg.ny + 2)
    nc.create_dim("xi_rho", cfg.nx + 2)
    fields = {
        "h": (grid.h, "bathymetry", "meter"),
        "pm": (grid.pm, "curvilinear metric in XI", "meter-1"),
        "pn": (grid.pn, "curvilinear metric in ETA", "meter-1"),
        "f": (grid.f, "Coriolis parameter", "second-1"),
        "mask_rho": (grid.rmask, "land-sea mask at RHO points", ""),
        "x_rho": (grid.xr, "x coordinate of RHO points", "meter"),
        "y_rho": (grid.yr, "y coordinate of RHO points", "meter"),
    }
    for name, (a, lname, units) in fields.items():
        nc.create_var(name, ("eta_rho", "xi_rho"), "f8",
                      {"long_name": lname, "units": units})
        nc.write(name, host(a)[RHO, RHO])
    nc.close()


# ===========================================================================
# Exact restart
# ===========================================================================

def write_restart(path: str, state: OceanState, cfg: ModelConfig,
                  grid=None):
    """Float64 restart of every tensor field of the state (reference:
    basic_output.F:517-682 wrt_rst_ocean_vars + EXACT_RESTART); the dict
    fields (upscale, budgets) are skipped.  The fields reach the host as
    a history record's do (`file_bytes`)."""
    nc = NCWriter(path, provenance_attrs(cfg))
    h = cfg.halo
    jy, ix = cfg.ny + 2 * h, cfg.nx + 2 * h
    nc.create_dim("eta_pad", jy)
    nc.create_dim("xi_pad", ix)
    nc.create_dim("s_rho", cfg.nz)
    nc.create_dim("s_w", cfg.nz + 1)
    nc.create_dim("tracer", cfg.nt)
    nc.create_dim("n_akt", int(state.akt.shape[0]))
    nc.create_dim("one", 1)

    def dims_of(a):
        m = {jy: "eta_pad", ix: "xi_pad", cfg.nz: "s_rho",
             cfg.nz + 1: "s_w"}
        out = []
        for ax, s in enumerate(a.shape):
            if ax == 0 and a.ndim == 4 and s == cfg.nt:
                out.append("tracer")
            elif ax == 0 and a.ndim == 4 and s == state.akt.shape[0]:
                out.append("n_akt")
            else:
                out.append(m[s])
        return tuple(out)

    raw = {}
    for f in dataclasses.fields(state):
        val = getattr(state, f.name)
        if val is None or isinstance(val, dict):
            continue  # optional diagnostics (e.g. upscale capture)
        nc.create_var(f.name, dims_of(val) if val.dim() else ("one",), "f8")
        raw[f.name] = file_bytes(val.reshape(val.shape or (1,)),
                                 torch.float64)
    write_file_bytes(nc, raw)
    nc.close()


def read_restart(path: str, cfg: ModelConfig,
                 dtype: Optional[torch.dtype] = None,
                 device: torch.device | str = "cuda") -> OceanState:
    """Inverse of write_restart (reference: src/get_init.F), on the card
    unless `device` says otherwise: every field in `dtype` (float64 by
    default), `iic` an int32 0-d tensor, the (1,) scalars 0-d, the dict
    fields None."""
    device = resolve_device(device)
    dtype = dtype or torch.float64
    with open_dataset(path) as ds:
        kw = {}
        for f in dataclasses.fields(OceanState):
            if f.name not in ds:
                continue  # optional fields skipped at write time
            a = np.asarray(ds[f.name][...], np.float64)  # native order
            if f.name == "iic":
                kw[f.name] = torch.tensor(int(a.reshape(())),
                                          dtype=torch.int32, device=device)
            else:
                kw[f.name] = torch.as_tensor(
                    a.reshape(()) if a.shape == (1,) else a, dtype=dtype,
                    device=device)
    return OceanState(**kw)


# ---------------------------------------------------------------------------
# Date/node file naming + rotation (reference: roms_read_write.F:1161-1208
# create_file, :1389-1447 append_date_node, :1311-1344 sec2date)
# ---------------------------------------------------------------------------

#: seconds from 1970-01-01 to the model reference date 2000-01-01
#: (reference: roms_read_write.F init_refdate offset)
REF_OFFSET_2000 = 946684800.0


def sec2date(time_s: float, offset: float = REF_OFFSET_2000):
    """(year, month, day, hour, minute, second) of a model time in
    seconds since the reference date (reference: roms_read_write.F
    sec2date, Clive Page's MJD algorithm; here via the standard library
    on the same 1970 epoch)."""
    import datetime
    d = datetime.datetime.fromtimestamp(time_s + offset,
                                        datetime.timezone.utc)
    return (d.year, d.month, d.day, d.hour, d.minute, d.second)


def dated_filename(root: str, kind: str, time_s: float,
                   dt_format: int = 0, period: float = 900.0) -> str:
    """`<root>.<kind>.<datestamp>.nc` (reference: create_file +
    append_date_node dt_format menu; no node suffix: one global file a
    run)."""
    y, mo, d, h, mi, s = sec2date(time_s)
    if dt_format == 1:      # omit the year
        stamp = f"{mo:02d}{d:02d}{h:02d}{mi:02d}{s:02d}"
    elif dt_format == 2:    # omit year and month
        stamp = f"{d:02d}{h:02d}{mi:02d}{s:02d}"
    elif dt_format == 3:    # omit seconds
        stamp = f"{y:4d}{mo:02d}{d:02d}{h:02d}{mi:02d}"
    elif dt_format == 4:    # old-style counter from the output period
        stamp = f"{int(time_s / period):05d}"
    else:
        stamp = f"{y:4d}{mo:02d}{d:02d}{h:02d}{mi:02d}{s:02d}"
    return f"{root}.{kind}.{stamp}.nc"


class RotatingHistoryWriter:
    """History output with per-file record limits and dated names
    (reference: basic_output.F nrpf file rotation + create_file date
    suffixes): a new `<root>.his.<date>.nc` starts every `nrpf` records.
    """

    def __init__(self, root: str, grid, cfg: ModelConfig, nrpf: int,
                 dt_format: int = 0, **kw):
        self.root = root
        self.grid = grid
        self.cfg = cfg
        self.nrpf = nrpf
        self.dt_format = dt_format
        self.kw = kw
        self.w: Optional[HistoryWriter] = None
        self.files: list = []

    def write(self, state: OceanState):
        if self.w is None or self.w.rec >= self.nrpf:
            if self.w is not None:
                self.w.close()
            path = dated_filename(self.root, "his", float(state.time),
                                  self.dt_format)
            self.w = HistoryWriter(path, self.grid, self.cfg, **self.kw)
            self.files.append(path)
        self.w.write(state)

    def close(self):
        if self.w is not None:
            self.w.close()


class FrcWriter:
    """Applied-surface-forcing output (reference: src/frc_output.F:
    records the forcing actually applied each step: wind stress, net
    heat/salt flux, solar flux, freshwater flux)."""

    FIELDS = ("sustr", "svstr", "srflx", "swflx")

    def __init__(self, path: str, cfg: ModelConfig, navg: int = 1):
        self.cfg = cfg
        self.navg = navg
        self.nc = NCWriter(path, provenance_attrs(cfg))
        self.nc.create_dim("time", None)
        self.nc.create_dim("eta_rho", cfg.ny + 2)
        self.nc.create_dim("xi_rho", cfg.nx + 2)
        self.nc.create_var("ocean_time", ("time",), "f8")
        for nm in self.FIELDS + ("stflx_temp", "stflx_salt")[
                :2 if cfg.salinity else 1]:
            self.nc.create_var(nm, ("time", "eta_rho", "xi_rho"), "f4")
        self._acc: dict = {}
        self._n = 0
        self.rec = 0

    def accumulate(self, forcing, time: float):
        for nm in self.FIELDS:
            a = host(getattr(forcing, nm)).astype(np.float64)
            if a.ndim == 0:
                # a scalar constant forcing still carries its value
                a = np.full((self.cfg.ny + 4, self.cfg.nx + 4), float(a))
            self._acc[nm] = self._acc.get(nm, 0.0) + a
        st = host(forcing.stflx).astype(np.float64)
        self._acc["stflx_temp"] = (self._acc.get("stflx_temp", 0.0)
                                   + st[self.cfg.itemp])
        if self.cfg.salinity:
            self._acc["stflx_salt"] = (self._acc.get("stflx_salt", 0.0)
                                       + st[self.cfg.isalt])
        self._acc["ocean_time"] = self._acc.get("ocean_time", 0.0) + time
        self._n += 1
        if self._n >= self.navg:
            inv = 1.0 / self._n
            self.nc.write("ocean_time", self._acc.pop("ocean_time") * inv,
                          rec=self.rec)
            for nm, a in self._acc.items():
                self.nc.write(nm, (a * inv)[1:-1, 1:-1], rec=self.rec)
            self._acc = {}
            self._n = 0
            self.rec += 1
            self.nc.sync()

    def close(self):
        self.nc.close()


class CdrWriter:
    """mCDR release bookkeeping output (reference: src/cdr_output.F:
    per-release applied tracer fluxes)."""

    def __init__(self, path: str, cfg: ModelConfig, ncdr: int,
                 tracer_names: Sequence[str]):
        self.cfg = cfg
        self.names = list(tracer_names)
        self.nc = NCWriter(path, provenance_attrs(cfg))
        self.nc.create_dim("time", None)
        self.nc.create_dim("ncdr", ncdr)
        self.nc.create_dim("ntracers", len(self.names))
        self.nc.create_var("ocean_time", ("time",), "f8")
        self.nc.create_var("cdr_trcflx_applied",
                           ("time", "ntracers", "ncdr"), "f8",
                           {"units": "tracer m^3 s^-1"})
        self.rec = 0

    def write(self, cdr, time: float):
        self.nc.write("ocean_time", float(time), rec=self.rec)
        self.nc.write("cdr_trcflx_applied",
                      host(cdr.flx).astype(np.float64).T, rec=self.rec)
        self.rec += 1
        self.nc.sync()

    def close(self):
        self.nc.close()


class RandomWriter:
    """Arbitrary-variable-list output (reference: src/random_output.F:
    any menu of state fields at full 3D, on its own schedule; w-point
    fields averaged to rho levels)."""

    def __init__(self, path: str, grid, cfg: ModelConfig,
                 varlist: Sequence[str]):
        self.cfg = cfg
        self.varlist = list(varlist)
        self.nc = NCWriter(path, provenance_attrs(cfg))
        self.nc.create_dim("time", None)
        self.nc.create_dim("s_rho", cfg.nz)
        self.nc.create_dim("eta_rho", cfg.ny + 2)
        self.nc.create_dim("xi_rho", cfg.nx + 2)
        self.nc.create_var("ocean_time", ("time",), "f8")
        for nm in self.varlist:
            dims = ("time", "s_rho", "eta_rho", "xi_rho")
            if nm in ("zeta", "ubar", "vbar", "hbls", "hbbl"):
                dims = ("time", "eta_rho", "xi_rho")
            self.nc.create_var(nm, dims, "f4")
        self.rec = 0

    def write(self, state: OceanState):
        self.nc.write("ocean_time", float(state.time), rec=self.rec)
        for nm in self.varlist:
            if nm == "t":
                raise ValueError("use explicit tracer names")
            a = host(getattr(state, nm))
            if a.ndim == 3 and a.shape[0] == self.cfg.nz + 1:
                a = 0.5 * (a[1:] + a[:-1])
            self.nc.write(nm, a[..., 1:-1, 1:-1].astype("f4"),
                          rec=self.rec)
        self.rec += 1
        self.nc.sync()

    def close(self):
        self.nc.close()
