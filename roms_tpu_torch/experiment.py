"""Experiment assembly: `roms.in` + NetCDF input files -> a runnable model
(port of roms_tpu/experiment.py; reference: src/main.F:86-321 roms_init,
src/read_inp_mod.F read_inp, src/grid.F get_grid, src/get_init.F,
src/set_forces.F:90-154 dispatch, src/roms_read_write.F:654-827
find_new_record multi-file search):

  * parse the runtime input file (keyword registry, `runconfig`);
  * load grid + initial state from whole-grid NetCDF files onto the
    experiment's device;
  * scan the `forcing:` file list for every recognized forcing variable:
    each variable binds to the first file that contains it, with that
    file's own time axis and cycling, like the reference's per-variable
    record search;
  * build the host-side time-interpolating ForcingSet (surface fluxes
    OR bulk-COARE atmospheric state, open-boundary data incl. per-tracer
    variables, rivers, pipes, tides, BGC deposition, mCDR releases);
  * return a `forcing_fn(time, base, state)` the driver calls every step
    (the set_forces analog).  Bulk forcing reads the SST and the surface
    currents from the state on the device; only the atmospheric records
    come from the host, one host-to-device copy a field a step.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from roms_tpu_torch import cdr as cdrmod
from roms_tpu_torch.audit import check_config
from roms_tpu_torch.cases import resolve_device
from roms_tpu_torch.config import ModelConfig
from roms_tpu_torch.forcing import (DAY, DerivedSeries, ForcingSet, Series,
                                    StackSeries, pad_field,
                                    series_from_dataset)
from roms_tpu_torch.io.input import read_grid, read_init
from roms_tpu_torch.io.netcdf import NCDataset, open_dataset
from roms_tpu_torch.ops.bulk import bulk_flux
from roms_tpu_torch.ops.rivers import build_river_faces
from roms_tpu_torch.runconfig import RunConfig, read_inp
from roms_tpu_torch.sponge import set_nudgcof
from roms_tpu_torch.state import Forcing, zero_forcing
from roms_tpu_torch.tides import TidalForcing, set_tides

CP = 3985.0           # (reference: scalars.F:128)
CMDAY2MS = 0.01 / DAY  # cm/day -> m/s (reference: scalars.F cmday2ms)

_BULK_FORCING = ("uwnd", "vwnd", "Tair", "qair", "rain", "lwrad", "swrad")
_BGC_FORCING = ("dust", "iron", "pco2_air", "pco2_air_alt", "nox", "nhy",
                "swrad_LFreq")


class FileSet:
    """Open NetCDF forcing files; find each variable in the first file that
    provides it (reference: roms_read_write.F:654-827 find_new_record scans
    the frcfile list per variable).  `close()` also closes the files
    handed to `keep` (read beside the list, as the climatology is)."""

    def __init__(self, paths: Sequence[str]):
        self.paths = list(paths)
        self.datasets: List[NCDataset] = [open_dataset(p) for p in paths]
        self._kept: List[NCDataset] = []

    def keep(self, ds: NCDataset) -> NCDataset:
        self._kept.append(ds)
        return ds

    def has(self, varname: str) -> bool:
        return any(varname in ds for ds in self.datasets)

    def dataset_of(self, varname: str) -> NCDataset:
        for ds in self.datasets:
            if varname in ds:
                return ds
        raise KeyError(f"variable {varname!r} not found in any forcing file "
                       f"({self.paths})")

    def series(self, varname: str, scale: float = 1.0,
               interp: bool = True) -> Series:
        ds = self.dataset_of(varname)
        return series_from_dataset(ds, varname, scale=scale, interp=interp)

    def close(self):
        for ds in self.datasets + self._kept:
            ds.close()


@dataclass
class Experiment:
    """Everything `driver.run` needs, assembled from input files."""
    cfg: ModelConfig
    grid: object
    state: object
    forcing0: Forcing          # static parts (rivers/pipes structure, ...)
    forcing_fn: object         # f(time, base, state) -> Forcing
    rc: RunConfig
    tides: Optional[TidalForcing] = None
    fileset: Optional[FileSet] = None

    def run(self, **kw):
        from roms_tpu_torch.driver import run
        return run(self.grid, self.state, self.forcing0, self.cfg,
                   forcing_fn=self.forcing_fn, **kw)

    def run_distributed(self, mesh, **kw):
        """Run this experiment on a rank mesh (`parallel.dist.Mesh`; every
        rank calls it on its own Experiment), with the full time-dependent
        forcing path on every rank (record search, two-slot
        interpolation, bulk fluxes on the gathered surface, tides;
        reference: set_forces on every rank every step, main.F:385)."""
        from roms_tpu_torch.driver import run_distributed
        return run_distributed(self.grid, self.state, self.forcing0,
                               self.cfg, mesh, forcing_fn=self.forcing_fn,
                               **kw)


def _decode_point_sources(field2d: np.ndarray):
    """Split the reference's combined `value = fraction + 10*index`
    point-source encoding (reference: river_frc.F:150-160, pipe_frc.F:146)."""
    idx = np.floor(field2d / 10.0 + 1e-9).astype(np.int64)
    frc = np.where(idx > 0, field2d - 10.0 * idx, 0.0)
    return frc, idx


def _prepend_zero(a: np.ndarray) -> np.ndarray:
    """Point-source tables are 1-based (index 0 = "no source")."""
    return np.concatenate([np.zeros((1,) + a.shape[1:], a.dtype), a], axis=0)


def assemble(infile: str, base_cfg: ModelConfig,
             tracer_names: Sequence[str] = ("temp", "salt"),
             nz: Optional[int] = None, dtype: torch.dtype = torch.float64,
             device: torch.device | str = "cuda",
             cdr_mode: Optional[str] = None, cdr_file: Optional[str] = None,
             bry_tides: bool = False, pot_tides: bool = True,
             ntides: int = 10) -> Experiment:
    """Build an Experiment from a reference-format runtime input file, on
    the card unless `device` says otherwise.

    base_cfg supplies the compile-time switches the reference keeps in
    cppdefs.opt (OBC_*, LMD_KPP, MASKING, ...); grid dims are inferred from
    the grid file; roms.in keywords overlay the rest (reference split:
    param.opt/cppdefs.opt at compile time, roms.in at run time).
    cdr_mode: None | 'parameterized' | 'dp' | '3d' (reference: cdr_frc.opt
    forcing_* switches; cdr_file: cdr_frc.opt cdr_file — these live in
    the .opt file, not roms.in).  bry_tides/pot_tides: the boundary and
    potential tides of the first `ntides` constituents of the file that
    carries `omega` (reference: tides.F:285-342)."""
    device = resolve_device(device)
    rc = read_inp(infile)
    base_dir = os.path.dirname(os.path.abspath(infile))

    def resolve(p):
        return p if os.path.isabs(p) else os.path.join(base_dir, p)

    # grid dims from the grid file (reference: param.opt LLm,MMm)
    grid_path = resolve(rc.paths["grid"])
    with open_dataset(grid_path) as ds:
        ny_f, nx_f = ds["h"].shape[-2:]
    cfg = rc.apply(base_cfg).replace(
        nx=nx_f - 2, ny=ny_f - 2, nz=nz or base_cfg.nz,
        nt=len(tracer_names))

    # a MARBL_biogeochemistry block in roms.in requires a BGC-enabled
    # build (reference: read_inp_mod.F kwread_marbl + check_setup)
    if rc.paths.get("marbl_namelist") and cfg.bgc_model == "none":
        raise ValueError(
            f"{infile}: MARBL_biogeochemistry block present but the "
            f"compile-time config has bgc_model='none' (reference: "
            f"check_setup errors on MARBL input without the MARBL switch)")
    check_config(cfg, strict=True)

    grid = read_grid(grid_path, cfg, dtype=dtype, device=device)
    if cfg.sponge:
        grid = set_nudgcof(grid, cfg)

    # initial state
    nrrec = int(rc.paths.get("nrrec", 1))
    state = read_init(resolve(rc.paths["initial"]), cfg, grid,
                      record=(nrrec - 1 if nrrec >= 1 else -1),
                      tracer_names=tracer_names, dtype=dtype, device=device)

    # forcing files
    fs = FileSet([resolve(p) for p in rc.paths.get("forcing", [])])
    surface: Dict[str, object] = {}
    boundary: Dict[str, object] = {}
    point: Dict[str, object] = {}
    forcing0 = zero_forcing(cfg, dtype, device)

    def dev(a):
        return torch.as_tensor(a, dtype=dtype, device=device)

    # surface flux mode (reference: flux_frc.F:75-156 unit conversions)
    if fs.has("sustr"):
        r0i = 1.0 / cfg.rho0
        surface["sustr"] = fs.series("sustr", scale=r0i)
        surface["svstr"] = fs.series("svstr", scale=r0i)
        if fs.has("shflux"):
            surface["stflx_0"] = fs.series("shflux", scale=r0i / CP)
        if fs.has("swrad"):
            surface["srflx"] = fs.series("swrad", scale=r0i / CP)
        if fs.has("swflux"):
            # freshwater volume flux, not a salt flux (flux_frc.F:100-103)
            surface["swflx"] = fs.series("swflux", scale=-CMDAY2MS)

    # bulk-COARE mode (reference: bulk_frc.opt variable table)
    bulk_series = ({nm: fs.series(nm) for nm in _BULK_FORCING if fs.has(nm)}
                   if fs.has("uwnd") else {})

    # climatology file: boundary tracer rows for tracers absent from the
    # bry files (reference: read_inp_mod.F:1025-1036, t3dbc_im.F
    # TCLIMATOLOGY rows)
    clm_ds = None
    clm_path = rc.paths.get("climatology")
    if clm_path and clm_path != "none":
        clm_ds = fs.keep(open_dataset(resolve(clm_path)))

    # open-boundary data (reference: boundary.F:43-75 + per-tracer names)
    for edge in ("west", "east", "south", "north"):
        if not getattr(cfg, f"obc_{edge}"):
            continue
        for var in ("zeta", "ubar", "vbar", "u", "v"):
            name = f"{var}_{edge}"
            if fs.has(name):
                boundary[name] = fs.series(name)
        tser = []
        complete = True
        for nm in tracer_names:
            vn = f"{nm}_{edge}"
            if fs.has(vn):
                tser.append(fs.series(vn))
            elif clm_ds is not None and nm in clm_ds:
                tser.append(_clm_edge_series(clm_ds, nm, edge))
            else:
                complete = False
                tser.append(None)
        if complete and tser:
            boundary[f"t_{edge}"] = StackSeries(tser, name=f"t_{edge}")
        elif any(s is not None for s in tser):
            raise KeyError(
                f"boundary data for edge {edge} covers only a subset of "
                f"tracers {tracer_names} and no climatology file supplies "
                f"the rest; the reference requires all (boundary.F "
                f"per-tracer set_frc_data / clm_file alternative)")

    # rivers (reference: river_frc.F:46-49; faces decoded from the grid
    # file's river_flux field, :150-280)
    if cfg.river_source:
        with open_dataset(grid_path) as ds:
            rflx = pad_field(np.asarray(ds["river_flux"][...], np.float64),
                             cfg)
        rfrc, ridx = _decode_point_sources(rflx)
        rmask_np = grid.rmask.cpu().numpy().astype(np.float64)
        uflx, vflx = build_river_faces(rmask_np, rfrc, ridx)
        forcing0 = forcing0.replace(riv_uflx=dev(uflx), riv_vflx=dev(vflx))
        point["riv_vol"] = DerivedSeries(_prepend_zero,
                                         fs.series("river_volume"))
        point["riv_trc"] = DerivedSeries(
            lambda a: _prepend_zero(np.atleast_2d(a).T),
            fs.series("river_tracer"))

    # pipes (reference: pipe_frc.F:39-42 series + :115-116 location fields,
    # fixed bottom-two-level profile set_pipe_vert_prf)
    if cfg.pipe_source:
        pds = fs.dataset_of("pipe_volume")
        pidx = pad_field(np.asarray(pds["pipe_index"][...], np.float64), cfg)
        pfrac = pad_field(np.asarray(pds["pipe_fraction"][...], np.float64),
                          cfg)
        pidx = np.where(pfrac > 0.0, pidx, 0.0).astype(np.int32)
        npip = int(pidx.max())
        prf = np.zeros((npip + 1, cfg.nz))
        prf[1:, 0] = 0.5
        prf[1:, 1] = 0.5
        forcing0 = forcing0.replace(
            pipe_idx=torch.as_tensor(pidx, device=device), pipe_prf=dev(prf))
        point["pipe_flx"] = DerivedSeries(
            lambda v: pfrac * _prepend_zero(np.atleast_1d(v))[pidx],
            fs.series("pipe_volume"))
        point["pipe_trc"] = DerivedSeries(
            lambda a: _prepend_zero(np.atleast_2d(a).T),
            fs.series("pipe_tracer"))

    # tides (reference: tides.F:285-342)
    tidal = None
    if (bry_tides or pot_tides) and fs.has("omega"):
        tidal = _load_tides(fs, cfg, ntides, bry_tides, pot_tides, dev)

    # BGC atmospheric deposition / gas forcing (reference: bgc.opt,
    # src/bgc_forces.F)
    bgc_series = {nm: fs.series(nm) for nm in _BGC_FORCING if fs.has(nm)}

    # mCDR releases (reference: cdr_frc.F three forcing modes)
    cdr_static, cdr_flx_series = None, None
    if cdr_mode is not None:
        cdr_static, cdr_flx_series = _load_cdr(
            resolve(cdr_file), cdr_mode, cfg, grid, state, tracer_names,
            dtype, device)

    fset = ForcingSet(cfg, surface=surface, boundary=boundary, point=point,
                      dtype=dtype, device=device)

    def field(s, t):
        return dev(pad_field(np.atleast_2d(s.value(t)), cfg))

    def forcing_fn(t, base, st=None):
        frc = fset.at(t, base)
        if bulk_series:
            frc = _apply_bulk(frc, {nm: field(s, t)
                                    for nm, s in bulk_series.items()},
                              st, grid, cfg)
        if tidal is not None:
            bry_out, ptide = set_tides(tidal, dev(t), cfg, bry=frc.bry)
            frc = frc.replace(bry=bry_out, ptide=ptide)
        if bgc_series:
            # replaces the dict, as the JAX package does: the bulk wspd
            # does not reach the BGC engine when BGC series are present
            frc = frc.replace(bgc={nm: field(s, t)
                                   for nm, s in bgc_series.items()})
        if cdr_static is not None:
            cdr = cdr_static
            if cdr_flx_series is not None:
                flx = np.atleast_2d(cdr_flx_series.value(t)).T  # (ncdr, nt)
                cdr = cdr.replace(flx=dev(flx))
            frc = frc.replace(cdr=cdr)
        return frc

    # the hook reads the state only for the bulk fluxes
    forcing_fn.needs_state = bool(bulk_series)
    return Experiment(cfg=cfg, grid=grid, state=state, forcing0=forcing0,
                      forcing_fn=forcing_fn, rc=rc, tides=tidal, fileset=fs)


# On the joined-file (n+2) layout the boundary ring itself is column 0
# (west) / -1 (east) and row 0 (south) / -1 (north): the reference
# applies tclm(istr-1)/tclm(iend+1)/tclm(jstr-1)/tclm(jend+1)
# (t3dbc_im.F:158,233,301), i.e. the ring value, not the first interior
# value.
_CLM_EDGE_SLICE = {
    "west": (Ellipsis, slice(None), 0),
    "east": (Ellipsis, slice(None), -1),
    "south": (Ellipsis, 0, slice(None)),
    "north": (Ellipsis, -1, slice(None)),
}


def _clm_edge_series(ds, varname: str, edge: str) -> Series:
    """Boundary-row series sliced per record from a whole-grid climatology
    field (reference: tclm rows consumed by t3dbc_im.F:158,233,301;
    read_inp_mod.F:1026-1034).  Slicing happens at record granularity so
    only two time slots of the 3D field are ever resident."""
    var = ds[varname]
    tvar = ds[var.dims[0]]
    times = np.asarray(tvar[...], np.float64) * DAY
    cyc = tvar.attrs.get("cycle_length")
    cycle = (float(np.asarray(cyc).reshape(())) * DAY
             if cyc is not None else None)
    sl = _CLM_EDGE_SLICE[edge]

    def read(i):
        return np.asarray(var[i], np.float64)[sl]

    return Series(times, read, cycle=cycle, name=f"clm:{varname}_{edge}")


def _apply_bulk(frc: Forcing, v, st, grid, cfg) -> Forcing:
    """COARE bulk fluxes from the interpolated atmospheric state `v`
    (fields on the device) and the model's SST and surface currents, read
    from the state on the device (reference: set_forces.F -> bulk_frc.F
    set_bulk_frc)."""
    fx = bulk_flux(v["uwnd"], v["vwnd"], v["Tair"], v["qair"], v["rain"],
                   v["lwrad"], v["swrad"], st.t[cfg.itemp, -1],
                   st.u[-1], st.v[-1], grid, cfg)
    stflx = frc.stflx.clone()
    stflx[cfg.itemp] = fx.stflx_temp
    # the 10 m wind speed for gas exchange (reference: bec2_driver.F:186-188
    # BULK_FRC branch uses wspd directly)
    bgc = dict(frc.bgc) if frc.bgc else {}
    bgc["wspd"] = torch.sqrt(v["uwnd"] ** 2 + v["vwnd"] ** 2)
    return frc.replace(sustr=fx.sustr, svstr=fx.svstr, stflx=stflx,
                       srflx=fx.srflx, swflx=fx.swflx, bgc=bgc)


def _load_tides(fs: FileSet, cfg, ntides, bry_tides, pot_tides, dev):
    """TidalForcing from the file that carries `omega`: the first `ntides`
    constituents, amplitudes padded to the compute layout."""
    ds = fs.dataset_of("omega")
    om = np.asarray(ds["omega"][...], np.float64)[:ntides]

    def fld(nm):
        return dev(pad_field(np.asarray(ds[nm][...], np.float64)[:ntides],
                             cfg))

    kw = dict(ftide=dev(om))
    if pot_tides and "pot_Re" in ds:
        kw.update(ptide_re=fld("pot_Re"), ptide_im=fld("pot_Im"))
    if bry_tides and "ssh_Re" in ds:
        kw.update(ztide_re=fld("ssh_Re"), ztide_im=fld("ssh_Im"),
                  utide_re=fld("u_Re"), utide_im=fld("u_Im"),
                  vtide_re=fld("v_Re"), vtide_im=fld("v_Im"))
    return TidalForcing(**kw)


def _load_cdr(path: str, mode: str, cfg, grid, state, tracer_names, dtype,
              device):
    """CdrForcing from a cdr forcing file (reference: cdr_frc.F:111-114
    3D, :189-243 dp, :264-292 parameterized).

    Returns (static CdrForcing, per-step tracer-flux Series or None)."""
    names = list(tracer_names)
    ialk = names.index("ALK") if "ALK" in names else cfg.nt - 2
    idic = names.index("DIC") if "DIC" in names else cfg.nt - 1
    with open_dataset(path) as ds:
        def vec(nm):
            return np.atleast_1d(np.asarray(ds[nm][...], np.float64))

        if mode == "parameterized":
            lon, lat = vec("cdr_lon"), vec("cdr_lat")
            static = cdrmod.parameterized_releases(
                cfg, grid, state.z_r, state.hz, lon, lat, vec("cdr_dep"),
                vec("cdr_hsc"), vec("cdr_vsc"), np.zeros((len(lon), cfg.nt)),
                dtype=dtype, device=device)
            return static, series_from_dataset(ds, "cdr_trcflx",
                                               interp=False)
        if mode == "dp":
            hz_src = np.asarray(ds["cdr_layer_thickness"][0], np.float64).T
            # file layout (n_src, nrows, ncdr) -> (ncdr, nrows, n_src)
            prof = np.transpose(np.asarray(ds["cdr_trcflx_profile"][0],
                                           np.float64), (2, 1, 0))
            return cdrmod.profile_releases(
                cfg, grid, state.hz, vec("cdr_lon"), vec("cdr_lat"), hz_src,
                prof, tracer_indices=(ialk, idic), dtype=dtype,
                device=device), None
        if mode == "3d":
            alk = pad_field(np.asarray(ds["cdr_trcflx_3d_ALK"][0],
                                       np.float64), cfg)
            dic = pad_field(np.asarray(ds["cdr_trcflx_3d_DIC"][0],
                                       np.float64), cfg)
            flx3 = np.zeros((cfg.nt,) + alk.shape)
            flx3[ialk] = alk
            flx3[idic] = dic
            return cdrmod.cdr_3d(cfg, flx3, dtype=dtype, device=device), None
    raise ValueError(f"unknown cdr mode {mode!r}")
