"""mCDR (marine carbon dioxide removal) release forcing (port of
roms_tpu/cdr.py; reference: src/cdr_frc.F).

Three forcing modes, as the reference has them:
  (1) parameterized releases — point or Gaussian horizontal footprint with
      a Gaussian (or single-level) vertical profile (cdr_frc.F:403-493);
  (2) vertical profiles ("upscaling" input) — per-release source-grid
      profiles conservatively remapped onto the local model levels
      (cdr_frc.F:433-439, vertical_remapping.F);
  (3) full-3D ALK/DIC flux fields (cdr_frc.F:111-114).

The releases are built on the host in numpy at initialization; the step
applies them as a dense add or a sparse scatter-add that accumulates over
release points sharing a cell (reference: step3d_t_ISO.F:859-902).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np
import torch

from bench_h100.reference.config import ModelConfig
from bench_h100.reference.remap import remap_src_to_grid
from bench_h100.reference.state import _Replace

EARTH_RADIUS = 6371315.0  # [m]


@dataclass
class CdrForcing(_Replace):
    """Release data on the model's device.

    Sparse form (modes 1-2): `iloc/jloc` (nprf,) padded-grid indices and
    `icdr` (nprf,) release ids, all int64; `prf` (nprf, nt, nz) normalized
    vertical weights (global sum over a release = 1); `flx` (ncdr, nt)
    tracer flux [C m^3/s].  Dense form (mode 3): `flx_3d` (nt, nz, jy, ix).
    """
    iloc: Optional[torch.Tensor] = None
    jloc: Optional[torch.Tensor] = None
    icdr: Optional[torch.Tensor] = None
    prf: Optional[torch.Tensor] = None
    flx: Optional[torch.Tensor] = None
    flx_3d: Optional[torch.Tensor] = None


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x, np.float64)


def _sparse(ilocs, jlocs, icdrs, prf, flx, dtype, device) -> CdrForcing:
    def idx(a):
        return torch.as_tensor(np.asarray(a, np.int64), device=device)
    return CdrForcing(
        iloc=idx(ilocs), jloc=idx(jlocs), icdr=idx(icdrs),
        prf=torch.as_tensor(np.asarray(prf), dtype=dtype, device=device),
        flx=torch.as_tensor(np.asarray(flx), dtype=dtype, device=device))


def ll2dist(lon, lat, lon0, lat0):
    """Great-circle distance [m] (reference: cdr_frc.F ll2dist)."""
    d2r = np.pi / 180.0
    la, la0 = lat * d2r, lat0 * d2r
    dlo = (lon - lon0) * d2r
    dla = la - la0
    a = np.sin(dla / 2) ** 2 + np.cos(la) * np.cos(la0) * np.sin(dlo / 2) ** 2
    return 2.0 * EARTH_RADIUS * np.arcsin(np.minimum(1.0, np.sqrt(a)))


def _release_footprints(cfg: ModelConfig, lon_r, lat_r, rmask, cdr_lon,
                        cdr_lat, cdr_hsc, xy_dist=False):
    """Horizontal fractional footprint per release
    (reference: cdr_frc.F:294-401 find_release_locations).

    Returns (fracs (ncdr, jy, ix), nearest (ncdr, 2) indices), numpy.
    Only interior points (Fortran 1..n) are eligible.
    """
    h = cfg.halo
    jy, ix = cfg.ny + 2 * h, cfg.nx + 2 * h
    ncdr = len(cdr_lon)
    interior = np.zeros((jy, ix), bool)
    interior[h:-h, h:-h] = True
    fracs = np.zeros((ncdr, jy, ix))
    nearest = np.zeros((ncdr, 2), np.int64)
    for ic in range(ncdr):
        if xy_dist:
            dist = np.hypot(lon_r - cdr_lon[ic], lat_r - cdr_lat[ic])
        else:
            dist = ll2dist(lon_r, lat_r, cdr_lon[ic], cdr_lat[ic])
        dist = np.where(interior, dist, 1e6)
        jn, in_ = np.unravel_index(np.argmin(dist), dist.shape)
        nearest[ic] = (jn, in_)
        if cdr_hsc is None or cdr_hsc[ic] == 0:
            fracs[ic, jn, in_] = 1.0
        else:
            f = np.exp(-(dist / cdr_hsc[ic]) ** 2)
            f = np.where(interior & (rmask > 0) & (f > 1e-3), f, 0.0)
            if not f.any():
                f[jn, in_] = 1.0  # tiny-hscl fallback (cdr_frc.F:366-372)
            fracs[ic] = f
    return fracs, nearest


def parameterized_releases(cfg: ModelConfig, grid, z_r0, hz0,
                           cdr_lon: Sequence[float], cdr_lat: Sequence[float],
                           cdr_dep: Sequence[float], cdr_hsc: Sequence[float],
                           cdr_vsc: Sequence[float],
                           flx: np.ndarray, xy_dist: bool = False,
                           dtype: torch.dtype = torch.float64,
                           device=None) -> CdrForcing:
    """Mode (1): sparse releases with analytic Gaussian structure
    (reference: cdr_frc.F:264-292 init + :403-493 vertical structure).

    z_r0/hz0: rest-state level depths/thicknesses (nz, jy, ix).
    flx: (ncdr, nt) tracer flux [C m^3/s] (= cdr_vol*cdr_trc when driven by
    volume+concentration series, reference: cdr_frc.F:117-123).
    """
    lon_r, lat_r, rmask = _np(grid.xr), _np(grid.yr), _np(grid.rmask)
    z_r0, hz0 = _np(z_r0), _np(hz0)
    nz = cfg.nz
    ncdr = len(cdr_lon)

    fracs, _ = _release_footprints(cfg, lon_r, lat_r, rmask, cdr_lon,
                                   cdr_lat, cdr_hsc, xy_dist=xy_dist)
    ilocs, jlocs, icdrs, prfs = [], [], [], []
    for ic in range(ncdr):
        js, is_ = np.nonzero(fracs[ic] > (1e-3 if cdr_hsc[ic] else 0.0))
        cols = []
        for j, i in zip(js, is_):
            if cdr_vsc[ic] == 0:
                # single nearest level (reference: cdr_frc.F:443-448)
                k = int(np.argmin(np.abs(z_r0[:, j, i] + cdr_dep[ic])))
                p = np.zeros(nz)
                p[k] = fracs[ic, j, i]
            else:
                arg = ((z_r0[:, j, i] + cdr_dep[ic]) / cdr_vsc[ic]) ** 2
                p = np.exp(-arg) * hz0[:, j, i]
                vint = cdr_vsc[ic] * np.sqrt(np.pi)
                p = fracs[ic, j, i] * p / vint
            cols.append(p)
            ilocs.append(i)
            jlocs.append(j)
            icdrs.append(ic)
        # normalize so the global injection equals flx exactly
        # (reference: cdr_frc.F:468-489)
        block = np.asarray(cols)           # (nloc, nz)
        tot = block.sum()
        if tot > 0:
            block /= tot
        prfs.extend(np.broadcast_to(block[:, None, :],
                                    (block.shape[0], cfg.nt, nz)).copy())

    prf = np.asarray(prfs).reshape(len(ilocs), cfg.nt, nz)
    return _sparse(ilocs, jlocs, icdrs, prf, flx, dtype, device)


def profile_releases(cfg: ModelConfig, grid, hz, cdr_lon, cdr_lat,
                     cdr_hz_src: np.ndarray, cdr_flx_dp: np.ndarray,
                     tracer_indices: Sequence[int],
                     flx: Optional[np.ndarray] = None,
                     xy_dist: bool = False,
                     dtype: torch.dtype = torch.float64,
                     device=None) -> CdrForcing:
    """Mode (2): single-point releases whose vertical structure comes from
    source-grid profiles, conservatively remapped onto the local column
    (reference: cdr_frc.F:189-243, :433-439).

    cdr_hz_src: (ncdr, n_src) source layer thicknesses;
    cdr_flx_dp: (ncdr, len(tracer_indices), n_src) source profiles;
    tracer_indices: which model tracers receive each profile row (the
    reference hardwires (iALK, iDIC), cdr_frc.F:236-238).
    """
    lon_r, lat_r, rmask = _np(grid.xr), _np(grid.yr), _np(grid.rmask)
    hz = _np(hz)
    ncdr = len(cdr_lon)

    _, nearest = _release_footprints(cfg, lon_r, lat_r, rmask, cdr_lon,
                                     cdr_lat, None, xy_dist=xy_dist)
    ilocs, jlocs, icdrs, prfs = [], [], [], []
    for ic in range(ncdr):
        j, i = nearest[ic]
        p = np.zeros((cfg.nt, cfg.nz))
        for row, itrc in enumerate(tracer_indices):
            p[itrc] = remap_src_to_grid(cdr_hz_src[ic], cdr_flx_dp[ic, row],
                                        hz[:, j, i])
        ilocs.append(i)
        jlocs.append(j)
        icdrs.append(ic)
        prfs.append(p)

    if flx is None:
        flx = np.zeros((ncdr, cfg.nt))
        flx[:, list(tracer_indices)] = 1.0  # (reference: cdr_frc.F:240-241)
    return _sparse(ilocs, jlocs, icdrs, prfs, flx, dtype, device)


def cdr_3d(cfg: ModelConfig, flx_3d: np.ndarray,
           dtype: torch.dtype = torch.float64, device=None) -> CdrForcing:
    """Mode (3): dense per-cell tracer injection rate (nt, nz, jy, ix)
    [C m^3/s per cell]: applied as dt*pm*pn*flx onto the Hz-weighted
    tracer, so the domain tracer content rises by sum(flx_3d)*dt per step
    (reference: step3d_t_ISO.F:862-881)."""
    return CdrForcing(flx_3d=torch.as_tensor(flx_3d, dtype=dtype,
                                             device=device))


def _point_increment(cdr: CdrForcing, pmn, dt, j0=None, i0=None):
    """dt * pmn * prf * flx at each release point, (nprf, nt, nz), and the
    points' flat (j*ix + i) indices.  j0/i0: a mesh block's offsets; the
    release indices are global padded-array indices, made block-local
    here, and the points outside the block (its halo included) add zero
    at (0, 0) (reference: cdr_frc.F per-rank release search)."""
    amp = cdr.prf * cdr.flx[cdr.icdr][:, :, None]
    jl, il = cdr.jloc, cdr.iloc
    if j0 is not None:
        jy, ix = pmn.shape
        jl, il = jl - j0, il - i0
        inb = (jl >= 0) & (jl < jy) & (il >= 0) & (il < ix)
        jl, il = torch.where(inb, jl, 0), torch.where(inb, il, 0)
        amp = amp * inb[:, None, None]
    incr = dt * pmn[jl, il][:, None, None] * amp
    return incr, jl * pmn.shape[-1] + il


def apply_cdr_all(t_rhs, cdr: CdrForcing, pmn, dt, j0=None, i0=None):
    """The CDR source added onto the Hz-weighted tracer r.h.s. of every
    tracer, t_rhs (nt, nz, jy, ix) (reference: step3d_t_ISO.F:859-902).
    Release points that share a cell add up (`index_add_`); j0/i0 place a
    mesh block (grid.j0/i0; None on a single block); returns a new
    tensor."""
    if cdr is None:
        return t_rhs
    out = t_rhs
    if cdr.flx_3d is not None:
        out = out + dt * pmn[None, None] * cdr.flx_3d
    if cdr.prf is not None and cdr.prf.shape[0] > 0:
        incr, flat = _point_increment(cdr, pmn, dt, j0, i0)
        out = out.clone(memory_format=torch.contiguous_format)
        nt, nz, jy, ix = out.shape
        out.view(nt, nz, jy * ix).index_add_(2, flat, incr.permute(1, 2, 0))
    return out


def apply_cdr(t_rhs_itrc, itrc: int, cdr: CdrForcing, pmn, dt):
    """The CDR source of tracer itrc added onto its Hz-weighted r.h.s.
    (nz, jy, ix) (reference: step3d_t_ISO.F:859-902); returns a new
    tensor."""
    if cdr is None:
        return t_rhs_itrc
    out = t_rhs_itrc
    if cdr.flx_3d is not None:
        out = out + dt * pmn[None] * cdr.flx_3d[itrc]
    if cdr.prf is not None and cdr.prf.shape[0] > 0:
        incr, flat = _point_increment(cdr, pmn, dt)
        out = out.clone(memory_format=torch.contiguous_format)
        nz, jy, ix = out.shape
        out.view(nz, jy * ix).index_add_(1, flat, incr[:, itrc].T)
    return out
