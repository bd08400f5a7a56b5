"""Lateral boundary conditions: closed walls and open boundaries (port of
roms_tpu/ops/bc.py).

The full per-edge menu of the reference:

  * free surface:   zero-gradient (closed) | Flather (reference: src/zetabc.F)
  * 2D momentum:    no-flux wall | Flather | Orlanski-2D | specified
                    (reference: src/u2dbc_im.F, src/v2dbc_im.F); tangential
                    edges use the advective Orlanski-2D form even under
                    OBC_M2FLATHER (reference: u2dbc_im.F:279-282 redefine)
  * 3D momentum:    no-flux wall / gamma2 ghosts | Orlanski | specified
                    (reference: src/u3dbc_im.F, src/v3dbc_im.F)
  * tracers:        zero-gradient | advective Orlanski | specified
                    (reference: src/t3dbc_im.F)

All updates are masked and finish with the open-open corner averages
(reference: u2dbc_im.F:455-478, u3dbc_im.F:387-418, t3dbc_im.F:315-420).

Padded-index map (halo=2): Fortran i -> python i+1; the wall-adjacent
interior rho point is index 2 / -3, the physical ghost ring is 1 / -2.
u(istr) (the westernmost normal-velocity point) is python column 2;
u(iend+1) is column -2; v(jstr) is row 2; v(jend+1) is row -2.

Every edge write goes through `eset`: a slice write on a clone, gated by
the block's edge-ownership flag (grid.own_w/e/s/n; None = single block,
which owns every edge), so a tensor a state still holds is never written.
Boundary data absent from `bry` reads as the scalar 0.0, and a value that
is 0.0 on every branch stays a Python float, as in the JAX package.
"""

from __future__ import annotations

import torch

from bench_h100.reference.config import ModelConfig
from bench_h100.reference.parallel.halo import band, eset

EPS = 1e-33
# Flather free-surface correction threshold 1-1/sqrt(2)
# (reference: u2dbc_im.F:36)
FLATHER_CX0 = 0.292893218813452


def _pos(x):
    """max(x, 0) for a tensor or a float."""
    return torch.clamp(x, min=0.0) if isinstance(x, torch.Tensor) \
        else max(x, 0.0)


def _neg(x):
    """min(x, 0) for a tensor or a float."""
    return torch.clamp(x, max=0.0) if isinstance(x, torch.Tensor) \
        else min(x, 0.0)


def _where(c, a, b):
    """jnp.where for a tensor or Python bool condition."""
    if isinstance(c, bool):
        return a if c else b
    return torch.where(c, a, b)


class _Ax:
    """Pad-aware index set for one axis (mesh-divisibility padding: `pad`
    inert cells sit beyond the east/north ghost ring, so every
    end-relative CROSS-edge physical index shifts by -pad; cfg.pad_e /
    pad_n are 0 on the single-device path).  ALONG-edge ranges stay
    unpadded and are trimmed per block by `_trim_hi` / `_trim_lo`."""

    def __init__(self, pad: int):
        self.pad = pad
        self.gh = -2 - pad         # physical ghost (Fortran 0 / end+1)
        self.in1 = -3 - pad        # first interior (Fortran 1 / end)
        self.in2 = -4 - pad
        self.IN = slice(2, -2)     # edge update range (jstr..jend)
        self.GR = slice(2, -1)     # grad range (jstr..jend+1)
        self.GL = slice(1, -2)
        self.INW = slice(2, -2)    # widened tangential range istrU-1..iend
        self.IWW = slice(1, -3)
        self.GRW = slice(2, -1)    # grad high / low ranges
        self.GLW = slice(1, -2)
        self.IN1 = slice(3, -1)    # jstr+1..jend+1 range


def _axes_of(cfg):
    """(x-axis, y-axis) pad-aware index sets."""
    return _Ax(cfg.pad_e), _Ax(cfg.pad_n)


def _as_edge(val, orig):
    if not isinstance(val, torch.Tensor):
        return torch.full_like(orig, val)
    return torch.broadcast_to(val, orig.shape)


def _trim_hi(val, orig, own_hi, pad: int):
    """Drop the last `pad` along-edge positions of an edge update on
    blocks owning the high (east/north) end (own_hi None or True); there
    they are cross-ghost/pad cells set by the corner/ghost logic."""
    if pad == 0:
        return val
    val = _as_edge(val, orig)
    if own_hi is False:
        return val
    n = orig.shape[-1]
    keep = torch.arange(n, device=orig.device) < n - pad
    return torch.where(keep, val, orig)


def _trim_lo(val, orig, own_lo):
    """Drop the first edge-parallel position (local index 2, Fortran istr
    / jstr) from a tangential-BC update on blocks owning the low end of
    the edge (own_lo None or True): the staggered range starts at
    istrU=istr+1 there (reference: u2dbc_im.F istrU loop start)."""
    val = _as_edge(val, orig)
    if own_lo is False:
        return val
    n = orig.shape[-1]
    keep = torch.arange(2, 2 + n, device=orig.device) >= 3
    return torch.where(keep, val, orig)


def _bry_ub(bry, name, rng, cfg):
    """Per-point Orlanski binding velocity for one edge: the tuned
    BoundaryData.ub_* array when present, else the scalar cfg.ubind."""
    v = getattr(bry, name, None) if bry is not None else None
    return cfg.ubind if v is None else v[rng]


def _bry(bry, name, rng=None):
    """Boundary data slice; the scalar 0.0 if absent."""
    v = getattr(bry, name, None) if bry is not None else None
    if v is None:
        return 0.0
    return v[..., rng] if rng is not None else v


def _mask(grid, which, cfg):
    if not cfg.masking:
        return None
    return getattr(grid, which)


def _apply_mask(val, m, idx_rows, idx_col=None):
    if m is None:
        return val
    if idx_col is None:
        return val * m[idx_rows]
    return val * m[idx_rows, idx_col]


# ===========================================================================
# Free surface (reference: src/zetabc.F)
# ===========================================================================

def zetabc(z_new, z_stp, grid, cfg: ModelConfig, bry=None):
    """Ghost-ring update for the new free surface inside the fast loop.
    z_stp: zeta at the previous fast level.  Open Flather edges use the
    radiative formula (reference: zetabc.F:28-36); every other edge is
    zero-gradient."""
    if cfg.fully_periodic:
        return z_new
    z = z_new
    m = _mask(grid, "rmask", cfg)
    g = cfg.g
    dtf = cfg.dtfast
    flather = cfg.obc_m2 == "flather"
    ax, ay = _axes_of(cfg)
    INY, INX = ay.IN, ax.IN
    eg, ei = ax.gh, ax.in1
    ng, ni = ay.gh, ay.in1

    if not cfg.ew_periodic:
        if cfg.obc_west and flather:
            cx = dtf * grid.pm[INY, 2] * torch.sqrt(g * grid.h[INY, 2])
            val = (1.0 - cx) * z_stp[INY, 1] + cx * z_stp[INY, 2]
            val = _trim_hi(_apply_mask(val, m, INY, 1), z[INY, 1],
                           grid.own_n, ay.pad)
            z = eset(z, (INY, 1), val, grid.own_w)
        else:
            z = eset(z, (slice(None), 1),
                     z[:, 2] * (m[:, 1] if m is not None else 1.0),
                     grid.own_w)
        if cfg.obc_east and flather:
            cx = dtf * grid.pm[INY, ei] * torch.sqrt(g * grid.h[INY, ei])
            val = (1.0 - cx) * z_stp[INY, eg] + cx * z_stp[INY, ei]
            val = _trim_hi(_apply_mask(val, m, INY, eg), z[INY, eg],
                           grid.own_n, ay.pad)
            z = eset(z, (INY, eg), val, grid.own_e)
        else:
            z = eset(z, (slice(None), eg),
                     z[:, ei] * (m[:, eg] if m is not None else 1.0),
                     grid.own_e)
    if not cfg.ns_periodic:
        if cfg.obc_south and flather:
            cx = dtf * grid.pn[2, INX] * torch.sqrt(g * grid.h[2, INX])
            val = (1.0 - cx) * z_stp[1, INX] + cx * z_stp[2, INX]
            val = _trim_hi(_apply_mask(val, m, 1, INX), z[1, INX],
                           grid.own_e, ax.pad)
            z = eset(z, (1, INX), val, grid.own_s)
        else:
            z = eset(z, (1, slice(None)),
                     z[2, :] * (m[1, :] if m is not None else 1.0),
                     grid.own_s)
        if cfg.obc_north and flather:
            cx = dtf * grid.pn[ni, INX] * torch.sqrt(g * grid.h[ni, INX])
            val = (1.0 - cx) * z_stp[ng, INX] + cx * z_stp[ni, INX]
            val = _trim_hi(_apply_mask(val, m, ng, INX), z[ng, INX],
                           grid.own_e, ax.pad)
            z = eset(z, (ng, INX), val, grid.own_n)
        else:
            z = eset(z, (ng, slice(None)),
                     z[ni, :] * (m[ng, :] if m is not None else 1.0),
                     grid.own_n)
    if not cfg.ew_periodic and not cfg.ns_periodic:
        # ghost corners = average of the two adjacent ghosts
        # (reference: zetabc.F corner section)
        z = eset(z, (1, 1), 0.5 * (z[1, 2] + z[2, 1]),
                 band(grid.own_s, grid.own_w))
        z = eset(z, (1, eg), 0.5 * (z[1, ei] + z[2, eg]),
                 band(grid.own_s, grid.own_e))
        z = eset(z, (ng, 1), 0.5 * (z[ng, 2] + z[ni, 1]),
                 band(grid.own_n, grid.own_w))
        z = eset(z, (ng, eg), 0.5 * (z[ng, ei] + z[ni, eg]),
                 band(grid.own_n, grid.own_e))
    return z


# ===========================================================================
# 2D momentum (reference: src/u2dbc_im.F, src/v2dbc_im.F)
# ===========================================================================

def _flather_zx(z_stp_in, z_stp_gh, z_new_in, cx):
    """Flather half-point free surface with super-Courant correction
    (reference: u2dbc_im.F:35-40)."""
    zx = (0.5 + cx) * z_stp_in + (0.5 - cx) * z_stp_gh
    corr = ((z_new_in + cx * z_stp_gh - (1.0 + cx) * z_stp_in)
            * (1.0 - FLATHER_CX0 / torch.clamp(cx, min=EPS)) ** 2)
    return zx + torch.where(cx > FLATHER_CX0, corr, 0.0)


def _orl2d_normal(q_gh_stp, q_in_stp, q_in_new, q_in2_new, g_gh, g_in,
                  pm_edge, dtfast, cfg, q_ext, z_new_gh_adj, z_ext, gpm,
                  ubind=None):
    """Normal-component Orlanski-2D at one W/E/S/N edge; returns the new
    boundary value before masking (reference: u2dbc_im.F:55-124).
    g_gh/g_in: tangential grads at the boundary column and first interior
    column, each len(edge)+1 long."""
    dft = q_in_stp - q_in_new
    dfx = q_in_new - q_in2_new
    if cfg.obc_rad_normal:
        cy = 0.0
        cff = torch.clamp(dfx * dfx, min=EPS)
    else:
        dfy = torch.where(dft * (g_in[:-1] + g_in[1:]) > 0.0, g_in[:-1],
                          g_in[1:])
        cff = torch.clamp(dfx * dfx + dfy * dfy, min=EPS)
        cy = 0.0 if cfg.obc_rad_npo else torch.minimum(
            cff, torch.maximum(dft * dfy, -cff))
    cx = dft * dfx
    inflow = cx < 0.0
    ub = cfg.ubind if ubind is None else ubind
    cext = torch.where(inflow, dtfast * ub * pm_edge, 0.0) \
        if cfg.frc_bry else 0.0
    cx = torch.clamp(cx, min=0.0)
    if isinstance(cy, torch.Tensor):
        cy = torch.where(inflow, 0.0, cy)
    val = (cff * q_gh_stp + cx * q_in_new
           - _pos(cy) * g_gh[:-1]
           - _neg(cy) * g_gh[1:]) / (cff + cx)
    if cfg.frc_bry:
        val = ((1.0 - cext) * val + cext * q_ext
               - cfg.attnm2 * dtfast * cfg.g * gpm * (z_new_gh_adj - z_ext))
    return val


def u2dbc(ubar_new, ubar_stp, vbar_stp, z_new, z_stp, grid,
          cfg: ModelConfig, bry=None):
    """BCs for the barotropic XI velocity at knew (reference: src/u2dbc_im.F)."""
    if cfg.fully_periodic:
        return ubar_new
    u = ubar_new
    um = _mask(grid, "umask", cfg)
    pmk = grid.pmask if cfg.masking else None
    g, dtf = cfg.g, cfg.dtfast
    g2 = cfg.gamma2
    ax, ay = _axes_of(cfg)
    INY = ay.IN

    # ---- West/East: normal component --------------------------------------
    if not cfg.ew_periodic:
        for east in (False, True):
            open_edge = cfg.obc_east if east else cfg.obc_west
            own = grid.own_e if east else grid.own_w
            gh, in1, in2 = ((ax.gh, ax.in1, ax.in2) if east else (2, 3, 4))
            ghr, inr = ((ax.gh, ax.in1) if east else (1, 2))  # rho cols
            sgn = 1.0 if east else -1.0
            if not open_edge:
                # closed wall, no-flux
                u = eset(u, (Ellipsis, slice(None), gh), 0.0 * u[..., :, gh],
                         own)
                continue
            ub_ext = _bry(bry, "ubar_east" if east else "ubar_west", INY)
            z_ext = _bry(bry, "zeta_east" if east else "zeta_west", INY)
            if cfg.obc_m2 == "flather":
                cff = 0.5 * (grid.h[INY, ghr] + grid.h[INY, inr])
                hx = torch.sqrt(g / cff)
                cx = dtf * cff * hx * 0.5 * (grid.pm[INY, ghr]
                                             + grid.pm[INY, inr])
                zx = _flather_zx(z_stp[INY, inr], z_stp[INY, ghr],
                                 z_new[INY, inr], cx)
                val = 0.5 * ((1.0 - cx) * ubar_stp[INY, gh]
                             + cx * ubar_stp[INY, in1]
                             + ub_ext + sgn * hx * (zx - z_ext))
                val = _trim_hi(_apply_mask(val, um, INY, gh), u[INY, gh],
                               grid.own_n, ay.pad)
                u = eset(u, (INY, gh), val, own)
            elif cfg.obc_m2 == "orlanski":
                def grad_col(c):
                    gcol = ubar_stp[ay.GR, c] - ubar_stp[ay.GL, c]
                    return gcol * pmk[ay.GR, c] if pmk is not None else gcol
                gpm = 0.5 * (grid.pm[INY, ghr] + grid.pm[INY, inr])
                val = _orl2d_normal(
                    ubar_stp[INY, gh], ubar_stp[INY, in1], u[INY, in1],
                    u[INY, in2], grad_col(gh), grad_col(in1),
                    gpm, dtf, cfg, ub_ext, z_new[INY, inr], z_ext, gpm,
                    ubind=_bry_ub(bry, "ub_east" if east else "ub_west",
                                  INY, cfg))
                val = _trim_hi(_apply_mask(val, um, INY, gh), u[INY, gh],
                               grid.own_n, ay.pad)
                u = eset(u, (INY, gh), val, own)
            else:  # specified / gradient
                val = ub_ext if cfg.obc_m2 == "specified" else u[INY, in1]
                val = _trim_hi(_apply_mask(val, um, INY, gh), u[INY, gh],
                               grid.own_n, ay.pad)
                u = eset(u, (INY, gh), val, own)

    # ---- South/North: tangential component ---------------------------------
    # Orlanski-2D advective form whenever the edge is open and the scheme is
    # flather or orlanski (reference: u2dbc_im.F:279-282, :288-328)
    if not cfg.ns_periodic:
        for north in (False, True):
            open_edge = cfg.obc_north if north else cfg.obc_south
            own = grid.own_n if north else grid.own_s
            gh, in1 = ((ay.gh, ay.in1) if north else (1, 2))
            if not open_edge:
                mfac = um[gh, :] if um is not None else 1.0
                u = eset(u, (Ellipsis, gh, slice(None)),
                         g2 * u[..., in1, :] * mfac, own)
                continue
            II = ax.INW         # istrU-1..iend (see _trim_lo)
            IW = ax.IWW         # i-1
            ub_ext = _bry(bry, "ubar_north" if north else "ubar_south", II)
            if cfg.obc_m2 in ("flather", "orlanski"):
                # grads along i at rows gh, in1 for i = istrU-2..iend
                def grad_row(r):
                    return ubar_stp[r, ax.GRW] - ubar_stp[r, ax.GLW]
                g_gh, g_in = grad_row(gh), grad_row(in1)
                sgn = 1.0 if north else -1.0
                vrow = ay.gh if north else 2  # vbar(jend+1) / vbar(jstr)
                cx = sgn * 0.125 * dtf * (vbar_stp[vrow, II]
                                          + vbar_stp[vrow, IW]) \
                    * (grid.pn[gh, II] + grid.pn[gh, IW]
                       + grid.pn[in1, II] + grid.pn[in1, IW])
                cy = 0.125 * dtf * (ubar_stp[gh, II] + ubar_stp[in1, II]) \
                    * (grid.pm[gh, II] + grid.pm[gh, IW]
                       + grid.pm[in1, II] + grid.pm[in1, IW])
                cext = torch.where(cx > 0.0, 0.0, -cx)
                cx = torch.clamp(cx, min=0.0)
                val = ((1.0 - cx) * (ubar_stp[gh, II]
                                     - _pos(cy) * g_gh[:-1]
                                     - _neg(cy) * g_gh[1:])
                       + cx * (ubar_stp[in1, II]
                               - _pos(cy) * g_in[:-1]
                               - _neg(cy) * g_in[1:]))
                if cfg.frc_bry:
                    val = (1.0 - cext) * val + cext * ub_ext
                val = _trim_lo(_apply_mask(val, um, gh, II), u[gh, II],
                               grid.own_w)
                val = _trim_hi(val, u[gh, II], grid.own_e, ax.pad)
                u = eset(u, (gh, II), val, own)
            else:  # specified / gradient
                val = ub_ext if cfg.obc_m2 == "specified" else u[in1, II]
                val = _trim_lo(_apply_mask(val, um, gh, II), u[gh, II],
                               grid.own_w)
                val = _trim_hi(val, u[gh, II], grid.own_e, ax.pad)
                u = eset(u, (gh, II), val, own)

    # ---- open-open corners (reference: u2dbc_im.F:455-478) ----------------
    return _uv_corners_u(u, cfg, grid)


def _uv_corners_u(u, cfg: ModelConfig, grid):
    ax, ay = _axes_of(cfg)
    eg, ei, ng, ni = ax.gh, ax.in1, ay.gh, ay.in1
    if cfg.obc_south and cfg.obc_west:
        u = eset(u, (Ellipsis, 1, 2), 0.5 * (u[..., 1, 3] + u[..., 2, 2]),
                 band(grid.own_s, grid.own_w))
    if cfg.obc_south and cfg.obc_east:
        u = eset(u, (Ellipsis, 1, eg), 0.5 * (u[..., 1, ei] + u[..., 2, eg]),
                 band(grid.own_s, grid.own_e))
    if cfg.obc_north and cfg.obc_west:
        u = eset(u, (Ellipsis, ng, 2), 0.5 * (u[..., ng, 3] + u[..., ni, 2]),
                 band(grid.own_n, grid.own_w))
    if cfg.obc_north and cfg.obc_east:
        u = eset(u, (Ellipsis, ng, eg),
                 0.5 * (u[..., ng, ei] + u[..., ni, eg]),
                 band(grid.own_n, grid.own_e))
    return _u_normal_ghosts(u, cfg, grid)


def _u_normal_ghosts(u, cfg: ModelConfig, grid):
    """Bound the cross-boundary u-face ghost line (col 1 / gh+1) by
    replicating the BC-written boundary face.  The reference never reads
    u(istr-1,:) at a physical west edge; the roll-based stencils here
    integrate a wrap-seam value there every step, so it is replicated
    from the boundary face to stay bounded and deterministic (see
    roms_tpu/ops/bc.py:_u_normal_ghosts)."""
    if cfg.ew_periodic:
        return u
    ax, _ = _axes_of(cfg)
    um = _mask(grid, "umask", cfg)
    val_w = u[..., :, 2] if um is None else u[..., :, 2] * um[:, 1]
    u = eset(u, (Ellipsis, slice(None), 1), val_w, grid.own_w)
    eo = ax.gh + 1                     # -1-pad: outer east ghost face
    val_e = (u[..., :, ax.gh] if um is None
             else u[..., :, ax.gh] * um[:, eo])
    return eset(u, (Ellipsis, slice(None), eo), val_e, grid.own_e)


def _uv_corners_v(v, cfg: ModelConfig, grid):
    ax, ay = _axes_of(cfg)
    eg, ei, ng, ni = ax.gh, ax.in1, ay.gh, ay.in1
    if cfg.obc_south and cfg.obc_west:
        v = eset(v, (Ellipsis, 2, 1), 0.5 * (v[..., 3, 1] + v[..., 2, 2]),
                 band(grid.own_s, grid.own_w))
    if cfg.obc_south and cfg.obc_east:
        v = eset(v, (Ellipsis, 2, eg), 0.5 * (v[..., 3, eg] + v[..., 2, ei]),
                 band(grid.own_s, grid.own_e))
    if cfg.obc_north and cfg.obc_west:
        v = eset(v, (Ellipsis, ng, 1), 0.5 * (v[..., ni, 1] + v[..., ng, 2]),
                 band(grid.own_n, grid.own_w))
    if cfg.obc_north and cfg.obc_east:
        v = eset(v, (Ellipsis, ng, eg),
                 0.5 * (v[..., ni, eg] + v[..., ng, ei]),
                 band(grid.own_n, grid.own_e))
    return _v_normal_ghosts(v, cfg, grid)


def _v_normal_ghosts(v, cfg: ModelConfig, grid):
    """Row analog of `_u_normal_ghosts` for the ETA-normal v faces."""
    if cfg.ns_periodic:
        return v
    _, ay = _axes_of(cfg)
    vm = _mask(grid, "vmask", cfg)
    val_s = v[..., 2, :] if vm is None else v[..., 2, :] * vm[1, :]
    v = eset(v, (Ellipsis, 1, slice(None)), val_s, grid.own_s)
    no = ay.gh + 1
    val_n = (v[..., ay.gh, :] if vm is None
             else v[..., ay.gh, :] * vm[no, :])
    return eset(v, (Ellipsis, no, slice(None)), val_n, grid.own_n)


def v2dbc(vbar_new, vbar_stp, ubar_stp, z_new, z_stp, grid,
          cfg: ModelConfig, bry=None):
    """BCs for the barotropic ETA velocity at knew (reference: src/v2dbc_im.F)."""
    if cfg.fully_periodic:
        return vbar_new
    v = vbar_new
    vm = _mask(grid, "vmask", cfg)
    pmk = grid.pmask if cfg.masking else None
    g, dtf = cfg.g, cfg.dtfast
    g2 = cfg.gamma2
    ax, ay = _axes_of(cfg)
    INX = ax.IN

    # ---- South/North: normal component ------------------------------------
    if not cfg.ns_periodic:
        for north in (False, True):
            open_edge = cfg.obc_north if north else cfg.obc_south
            own = grid.own_n if north else grid.own_s
            gh, in1, in2 = ((ay.gh, ay.in1, ay.in2) if north else (2, 3, 4))
            ghr, inr = ((ay.gh, ay.in1) if north else (1, 2))
            sgn = 1.0 if north else -1.0
            if not open_edge:
                v = eset(v, (Ellipsis, gh, slice(None)), 0.0 * v[..., gh, :],
                         own)
                continue
            vb_ext = _bry(bry, "vbar_north" if north else "vbar_south", INX)
            z_ext = _bry(bry, "zeta_north" if north else "zeta_south", INX)
            if cfg.obc_m2 == "flather":
                cff = 0.5 * (grid.h[ghr, INX] + grid.h[inr, INX])
                hx = torch.sqrt(g / cff)
                cx = dtf * cff * hx * 0.5 * (grid.pn[ghr, INX]
                                             + grid.pn[inr, INX])
                zx = _flather_zx(z_stp[inr, INX], z_stp[ghr, INX],
                                 z_new[inr, INX], cx)
                val = 0.5 * ((1.0 - cx) * vbar_stp[gh, INX]
                             + cx * vbar_stp[in1, INX]
                             + vb_ext + sgn * hx * (zx - z_ext))
                val = _trim_hi(_apply_mask(val, vm, gh, INX), v[gh, INX],
                               grid.own_e, ax.pad)
                v = eset(v, (gh, INX), val, own)
            elif cfg.obc_m2 == "orlanski":
                def grad_row(r):
                    grow = vbar_stp[r, ax.GR] - vbar_stp[r, ax.GL]
                    return grow * pmk[r, ax.GR] if pmk is not None else grow
                gpn = 0.5 * (grid.pn[ghr, INX] + grid.pn[inr, INX])
                val = _orl2d_normal(
                    vbar_stp[gh, INX], vbar_stp[in1, INX], v[in1, INX],
                    v[in2, INX], grad_row(gh), grad_row(in1),
                    gpn, dtf, cfg, vb_ext, z_new[inr, INX], z_ext, gpn,
                    ubind=_bry_ub(bry, "ub_north" if north else "ub_south",
                                  INX, cfg))
                val = _trim_hi(_apply_mask(val, vm, gh, INX), v[gh, INX],
                               grid.own_e, ax.pad)
                v = eset(v, (gh, INX), val, own)
            else:
                val = vb_ext if cfg.obc_m2 == "specified" else v[in1, INX]
                val = _trim_hi(_apply_mask(val, vm, gh, INX), v[gh, INX],
                               grid.own_e, ax.pad)
                v = eset(v, (gh, INX), val, own)

    # ---- West/East: tangential component -----------------------------------
    if not cfg.ew_periodic:
        for east in (False, True):
            open_edge = cfg.obc_east if east else cfg.obc_west
            own = grid.own_e if east else grid.own_w
            gh, in1 = ((ax.gh, ax.in1) if east else (1, 2))
            if not open_edge:
                mfac = vm[:, gh] if vm is not None else 1.0
                v = eset(v, (Ellipsis, slice(None), gh),
                         g2 * v[..., :, in1] * mfac, own)
                continue
            JJ = ay.INW         # jstrV-1..jend (see _trim_lo)
            JS = ay.IWW         # j-1
            vb_ext = _bry(bry, "vbar_east" if east else "vbar_west", JJ)
            if cfg.obc_m2 in ("flather", "orlanski"):
                def grad_col(c):
                    return vbar_stp[ay.GRW, c] - vbar_stp[ay.GLW, c]
                g_gh, g_in = grad_col(gh), grad_col(in1)
                sgn = 1.0 if east else -1.0
                ucol = ax.gh if east else 2  # ubar(iend+1) / ubar(istr)
                cx = sgn * 0.125 * dtf * (ubar_stp[JJ, ucol]
                                          + ubar_stp[JS, ucol]) \
                    * (grid.pm[JJ, gh] + grid.pm[JS, gh]
                       + grid.pm[JJ, in1] + grid.pm[JS, in1])
                cy = 0.125 * dtf * (vbar_stp[JJ, gh] + vbar_stp[JJ, in1]) \
                    * (grid.pn[JJ, gh] + grid.pn[JS, gh]
                       + grid.pn[JJ, in1] + grid.pn[JS, in1])
                cext = torch.where(cx > 0.0, 0.0, -cx)
                cx = torch.clamp(cx, min=0.0)
                val = ((1.0 - cx) * (vbar_stp[JJ, gh]
                                     - _pos(cy) * g_gh[:-1]
                                     - _neg(cy) * g_gh[1:])
                       + cx * (vbar_stp[JJ, in1]
                               - _pos(cy) * g_in[:-1]
                               - _neg(cy) * g_in[1:]))
                if cfg.frc_bry:
                    val = (1.0 - cext) * val + cext * vb_ext
                val = _trim_lo(_apply_mask(val, vm, JJ, gh), v[JJ, gh],
                               grid.own_s)
                val = _trim_hi(val, v[JJ, gh], grid.own_n, ay.pad)
                v = eset(v, (JJ, gh), val, own)
            else:
                val = vb_ext if cfg.obc_m2 == "specified" else v[JJ, in1]
                val = _trim_lo(_apply_mask(val, vm, JJ, gh), v[JJ, gh],
                               grid.own_s)
                val = _trim_hi(val, v[JJ, gh], grid.own_n, ay.pad)
                v = eset(v, (JJ, gh), val, own)

    return _uv_corners_v(v, cfg, grid)


# ===========================================================================
# 3D momentum (reference: src/u3dbc_im.F, src/v3dbc_im.F)
# ===========================================================================

def _orl3d_normal(q_gh_stp, q_in_stp, q_in_new, q_in2_new, g_gh, g_in,
                  pm_edge, dtfwd, cfg, q_ext, inflow_speed, ubind=None):
    """Normal-component Orlanski for a 3D field at one edge; operands are
    (nz, len(edge)) slices (reference: u3dbc_im.F:49-110)."""
    dft = q_in_stp - q_in_new
    dfx = q_in_new - q_in2_new
    if cfg.obc_rad_normal:
        cy = 0.0
        cff = torch.clamp(dfx * dfx, min=EPS)
    else:
        dfy = torch.where(dft * (g_in[..., :-1] + g_in[..., 1:]) > 0.0,
                          g_in[..., :-1], g_in[..., 1:])
        cff = torch.clamp(dfx * dfx + dfy * dfy, min=EPS)
        cy = 0.0 if cfg.obc_rad_npo else torch.minimum(
            cff, torch.maximum(dft * dfy, -cff))
    cx = dft * dfx
    inflow = cx < 0.0
    if cfg.frc_bry:
        # bind toward external data at the external inflow speed, floored by
        # ubind (reference: u3dbc_im.F:83-92)
        ub = cfg.ubind if ubind is None else ubind
        cext_in = _where(inflow_speed > 0.0, inflow_speed, ub) \
            * dtfwd * pm_edge
        cext = torch.where(inflow, cext_in, 0.0)
    else:
        cext = 0.0
    cx = torch.clamp(cx, min=0.0)
    if isinstance(cy, torch.Tensor):
        cy = torch.where(inflow, 0.0, cy)
    val = (cff * q_gh_stp + cx * q_in_new
           - _pos(cy) * g_gh[..., :-1]
           - _neg(cy) * g_gh[..., 1:]) / (cff + cx)
    if cfg.frc_bry:
        val = (1.0 - cext) * val + cext * q_ext
    return val


def u3dbc(u_new, u_stp, u_rhs, v_rhs, grid, cfg: ModelConfig, bry=None,
          pred_stage: bool = False):
    """BCs for 3D XI momentum at nnew (reference: src/u3dbc_im.F).
    u_stp: u at time n; u_rhs/v_rhs: velocities at the r.h.s. time level
    (time n in the predictor, n+1/2 in the corrector) used by the
    tangential advective form."""
    if cfg.fully_periodic:
        return u_new
    dtfwd = 0.5 * cfg.dt if pred_stage else cfg.dt
    u = u_new
    um = _mask(grid, "umask", cfg)
    pmk = grid.pmask if cfg.masking else None
    g2 = cfg.gamma2
    ax, ay = _axes_of(cfg)
    INY = ay.IN

    # ---- West/East: normal Orlanski ----------------------------------------
    if not cfg.ew_periodic:
        for east in (False, True):
            open_edge = cfg.obc_east if east else cfg.obc_west
            own = grid.own_e if east else grid.own_w
            gh, in1, in2 = ((ax.gh, ax.in1, ax.in2) if east else (2, 3, 4))
            ghr, inr = ((ax.gh, ax.in1) if east else (1, 2))
            if not open_edge:
                u = eset(u, (Ellipsis, slice(None), gh), 0.0 * u[..., :, gh],
                         own)
                continue
            u_ext = _bry(bry, "u_east" if east else "u_west", INY)
            if cfg.obc_m3 == "orlanski":
                def grad_col(c):
                    gcol = u_stp[:, ay.GR, c] - u_stp[:, ay.GL, c]
                    return gcol * pmk[ay.GR, c] if pmk is not None else gcol
                gpm = 0.5 * (grid.pm[INY, ghr] + grid.pm[INY, inr])
                inflow_speed = (-u_ext if east else u_ext) \
                    if cfg.frc_bry else 0.0
                val = _orl3d_normal(
                    u_stp[:, INY, gh], u_stp[:, INY, in1], u[:, INY, in1],
                    u[:, INY, in2], grad_col(gh), grad_col(in1),
                    gpm, dtfwd, cfg, u_ext, inflow_speed,
                    ubind=_bry_ub(bry, "ub_east" if east else "ub_west",
                                  INY, cfg))
                val = _trim_hi(_apply_mask(val, um, INY, gh), u[:, INY, gh],
                               grid.own_n, ay.pad)
                u = eset(u, (slice(None), INY, gh), val, own)
            else:
                val = u_ext if cfg.obc_m3 == "specified" else u[:, INY, in1]
                val = _trim_hi(_apply_mask(val, um, INY, gh), u[:, INY, gh],
                               grid.own_n, ay.pad)
                u = eset(u, (slice(None), INY, gh), val, own)

    # ---- South/North: tangential advective ---------------------------------
    if not cfg.ns_periodic:
        for north in (False, True):
            open_edge = cfg.obc_north if north else cfg.obc_south
            own = grid.own_n if north else grid.own_s
            gh, in1 = ((ay.gh, ay.in1) if north else (1, 2))
            vrow = ay.gh if north else 2  # v(jend+1) / v(jstr)
            if not open_edge:
                mfac = um[gh, :] if um is not None else 1.0
                u = eset(u, (Ellipsis, gh, slice(None)),
                         g2 * u[..., in1, :] * mfac, own)
                continue
            II = ax.INW
            IW = ax.IWW
            u_ext = _bry(bry, "u_north" if north else "u_south", II)
            if cfg.obc_m3 == "orlanski":
                def grad_row(r):
                    return u_stp[:, r, ax.GRW] - u_stp[:, r, ax.GLW]
                g_gh, g_in = grad_row(gh), grad_row(in1)
                sgn = 1.0 if north else -1.0
                cx = sgn * 0.125 * dtfwd * (v_rhs[:, vrow, II]
                                            + v_rhs[:, vrow, IW]) \
                    * (grid.pn[gh, II] + grid.pn[gh, IW]
                       + grid.pn[in1, II] + grid.pn[in1, IW])
                cy = 0.125 * dtfwd * (u_rhs[:, gh, II] + u_rhs[:, in1, II]) \
                    * (grid.pm[gh, II] + grid.pm[gh, IW]
                       + grid.pm[in1, II] + grid.pm[in1, IW])
                cext = torch.where(cx > 0.0, 0.0, -cx)
                cx = torch.clamp(cx, min=0.0)
                val = ((1.0 - cx) * (u_stp[:, gh, II]
                                     - _pos(cy) * g_gh[..., :-1]
                                     - _neg(cy) * g_gh[..., 1:])
                       + cx * (u_stp[:, in1, II]
                               - _pos(cy) * g_in[..., :-1]
                               - _neg(cy) * g_in[..., 1:]))
                if cfg.frc_bry:
                    val = (1.0 - cext) * val + cext * u_ext
                val = _trim_lo(_apply_mask(val, um, gh, II), u[:, gh, II],
                               grid.own_w)
                val = _trim_hi(val, u[:, gh, II], grid.own_e, ax.pad)
                u = eset(u, (slice(None), gh, II), val, own)
            else:
                val = u_ext if cfg.obc_m3 == "specified" else u[:, in1, II]
                val = _trim_lo(_apply_mask(val, um, gh, II), u[:, gh, II],
                               grid.own_w)
                val = _trim_hi(val, u[:, gh, II], grid.own_e, ax.pad)
                u = eset(u, (slice(None), gh, II), val, own)

    return _uv_corners_u(u, cfg, grid)


def v3dbc(v_new, v_stp, u_rhs, v_rhs, grid, cfg: ModelConfig, bry=None,
          pred_stage: bool = False):
    """BCs for 3D ETA momentum at nnew (reference: src/v3dbc_im.F)."""
    if cfg.fully_periodic:
        return v_new
    dtfwd = 0.5 * cfg.dt if pred_stage else cfg.dt
    v = v_new
    vm = _mask(grid, "vmask", cfg)
    pmk = grid.pmask if cfg.masking else None
    g2 = cfg.gamma2
    ax, ay = _axes_of(cfg)
    INX = ax.IN

    # ---- South/North: normal Orlanski --------------------------------------
    if not cfg.ns_periodic:
        for north in (False, True):
            open_edge = cfg.obc_north if north else cfg.obc_south
            own = grid.own_n if north else grid.own_s
            gh, in1, in2 = ((ay.gh, ay.in1, ay.in2) if north else (2, 3, 4))
            ghr, inr = ((ay.gh, ay.in1) if north else (1, 2))
            if not open_edge:
                v = eset(v, (Ellipsis, gh, slice(None)), 0.0 * v[..., gh, :],
                         own)
                continue
            v_ext = _bry(bry, "v_north" if north else "v_south", INX)
            if cfg.obc_m3 == "orlanski":
                def grad_row(r):
                    grow = v_stp[:, r, ax.GR] - v_stp[:, r, ax.GL]
                    return grow * pmk[r, ax.GR] if pmk is not None else grow
                gpn = 0.5 * (grid.pn[ghr, INX] + grid.pn[inr, INX])
                inflow_speed = (-v_ext if north else v_ext) \
                    if cfg.frc_bry else 0.0
                val = _orl3d_normal(
                    v_stp[:, gh, INX], v_stp[:, in1, INX], v[:, in1, INX],
                    v[:, in2, INX], grad_row(gh), grad_row(in1),
                    gpn, dtfwd, cfg, v_ext, inflow_speed,
                    ubind=_bry_ub(bry, "ub_north" if north else "ub_south",
                                  INX, cfg))
                val = _trim_hi(_apply_mask(val, vm, gh, INX), v[:, gh, INX],
                               grid.own_e, ax.pad)
                v = eset(v, (slice(None), gh, INX), val, own)
            else:
                val = v_ext if cfg.obc_m3 == "specified" else v[:, in1, INX]
                val = _trim_hi(_apply_mask(val, vm, gh, INX), v[:, gh, INX],
                               grid.own_e, ax.pad)
                v = eset(v, (slice(None), gh, INX), val, own)

    # ---- West/East: tangential advective -----------------------------------
    if not cfg.ew_periodic:
        for east in (False, True):
            open_edge = cfg.obc_east if east else cfg.obc_west
            own = grid.own_e if east else grid.own_w
            gh, in1 = ((ax.gh, ax.in1) if east else (1, 2))
            ucol = ax.gh if east else 2
            if not open_edge:
                mfac = vm[:, gh] if vm is not None else 1.0
                v = eset(v, (Ellipsis, slice(None), gh),
                         g2 * v[..., :, in1] * mfac, own)
                continue
            JJ = ay.INW
            JS = ay.IWW
            v_ext = _bry(bry, "v_east" if east else "v_west", JJ)
            if cfg.obc_m3 == "orlanski":
                def grad_col(c):
                    return v_stp[:, ay.GRW, c] - v_stp[:, ay.GLW, c]
                g_gh, g_in = grad_col(gh), grad_col(in1)
                sgn = 1.0 if east else -1.0
                cx = sgn * 0.125 * dtfwd * (u_rhs[:, JJ, ucol]
                                            + u_rhs[:, JS, ucol]) \
                    * (grid.pm[JJ, gh] + grid.pm[JS, gh]
                       + grid.pm[JJ, in1] + grid.pm[JS, in1])
                cy = 0.125 * dtfwd * (v_rhs[:, JJ, gh] + v_rhs[:, JJ, in1]) \
                    * (grid.pn[JJ, gh] + grid.pn[JS, gh]
                       + grid.pn[JJ, in1] + grid.pn[JS, in1])
                cext = torch.where(cx > 0.0, 0.0, -cx)
                cx = torch.clamp(cx, min=0.0)
                val = ((1.0 - cx) * (v_stp[:, JJ, gh]
                                     - _pos(cy) * g_gh[..., :-1]
                                     - _neg(cy) * g_gh[..., 1:])
                       + cx * (v_stp[:, JJ, in1]
                               - _pos(cy) * g_in[..., :-1]
                               - _neg(cy) * g_in[..., 1:]))
                if cfg.frc_bry:
                    val = (1.0 - cext) * val + cext * v_ext
                val = _trim_lo(_apply_mask(val, vm, JJ, gh), v[:, JJ, gh],
                               grid.own_s)
                val = _trim_hi(val, v[:, JJ, gh], grid.own_n, ay.pad)
                v = eset(v, (slice(None), JJ, gh), val, own)
            else:
                val = v_ext if cfg.obc_m3 == "specified" else v[:, JJ, in1]
                val = _trim_lo(_apply_mask(val, vm, JJ, gh), v[:, JJ, gh],
                               grid.own_s)
                val = _trim_hi(val, v[:, JJ, gh], grid.own_n, ay.pad)
                v = eset(v, (slice(None), JJ, gh), val, own)

    return _uv_corners_v(v, cfg, grid)


# ===========================================================================
# Tracers (reference: src/t3dbc_im.F)
# ===========================================================================

def t3dbc(t_new, t_stp, u_rhs, v_rhs, grid, cfg: ModelConfig, bry=None,
          pred_stage: bool = False):
    """BCs for all tracers at nnew; t arrays are (nt, nz, jy, ix)
    (reference: src/t3dbc_im.F).  Open edges use the advective upwinded
    radiation (OBC_TORLANSKI) or specified data; closed edges are
    zero-gradient.  The interior donor value is taken at nstp on the
    west/south edges and nnew on the east/north edges, as the reference
    does (t3dbc_im.F:63-70 vs :129-136)."""
    if cfg.fully_periodic:
        return t_new
    dtfwd = 0.5 * cfg.dt if pred_stage else cfg.dt
    t = t_new
    m = grid.rmask if cfg.masking else torch.ones_like(grid.h)
    vm = _mask(grid, "vmask", cfg)
    um = _mask(grid, "umask", cfg)
    orl = cfg.obc_t == "orlanski"
    ax, ay = _axes_of(cfg)
    INY, INX = ay.IN, ax.IN

    if not cfg.ew_periodic:
        for east in (False, True):
            open_edge = cfg.obc_east if east else cfg.obc_west
            own = grid.own_e if east else grid.own_w
            gh, in1 = ((ax.gh, ax.in1) if east else (1, 2))
            ucol = ax.gh if east else 2
            t_ext = _bry(bry, "t_east" if east else "t_west", INY)
            if not open_edge:
                t = eset(t, (Ellipsis, slice(None), gh),
                         t[..., :, in1] * m[:, gh], own)
                continue
            if orl:
                def grad_col(c):
                    gcol = t_stp[..., ay.GR, c] - t_stp[..., ay.GL, c]
                    return gcol * vm[ay.GR, c] if vm is not None else gcol
                g_gh, g_in = grad_col(gh), grad_col(in1)
                sgn = 1.0 if east else -1.0
                cx = sgn * dtfwd * u_rhs[:, INY, ucol] * grid.pm[INY, gh]
                cy = 0.5 * dtfwd * (v_rhs[:, ay.IN, gh]
                                    + v_rhs[:, ay.IN1, gh]) \
                    * grid.pn[INY, gh]
                cext = torch.where(cx > 0.0, 0.0, -cx)
                cx = torch.clamp(cx, min=0.0)
                # donor level: nstp on west, nnew on east (see docstring)
                don = t[..., INY, in1] if east else t_stp[..., INY, in1]
                val = ((1.0 - cx) * (t_stp[..., INY, gh]
                                     - _pos(cy) * g_gh[..., :-1]
                                     - _neg(cy) * g_gh[..., 1:])
                       + cx * (don
                               - _pos(cy) * g_in[..., :-1]
                               - _neg(cy) * g_in[..., 1:]))
                if cfg.frc_bry:
                    val = (1.0 - cext) * val + cext * t_ext
                val = _trim_hi(val * m[INY, gh], t[..., INY, gh],
                               grid.own_n, ay.pad)
                t = eset(t, (Ellipsis, INY, gh), val, own)
            else:  # specified
                val = t_ext if cfg.frc_bry else t[..., INY, in1]
                val = _trim_hi(val * m[INY, gh], t[..., INY, gh],
                               grid.own_n, ay.pad)
                t = eset(t, (Ellipsis, INY, gh), val, own)

    if not cfg.ns_periodic:
        for north in (False, True):
            open_edge = cfg.obc_north if north else cfg.obc_south
            own = grid.own_n if north else grid.own_s
            gh, in1 = ((ay.gh, ay.in1) if north else (1, 2))
            vrow = ay.gh if north else 2
            t_ext = _bry(bry, "t_north" if north else "t_south", INX)
            if not open_edge:
                t = eset(t, (Ellipsis, gh, slice(None)),
                         t[..., in1, :] * m[gh, :], own)
                continue
            if orl:
                def grad_row(r):
                    grow = t_stp[..., r, ax.GR] - t_stp[..., r, ax.GL]
                    return grow * um[r, ax.GR] if um is not None else grow
                g_gh, g_in = grad_row(gh), grad_row(in1)
                sgn = 1.0 if north else -1.0
                cx = sgn * dtfwd * v_rhs[:, vrow, INX] * grid.pn[gh, INX]
                cy = 0.5 * dtfwd * (u_rhs[:, gh, ax.IN]
                                    + u_rhs[:, gh, ax.IN1]) \
                    * grid.pm[gh, INX]
                cext = torch.where(cx > 0.0, 0.0, -cx)
                cx = torch.clamp(cx, min=0.0)
                don = t[..., in1, INX] if north else t_stp[..., in1, INX]
                val = ((1.0 - cx) * (t_stp[..., gh, INX]
                                     - _pos(cy) * g_gh[..., :-1]
                                     - _neg(cy) * g_gh[..., 1:])
                       + cx * (don
                               - _pos(cy) * g_in[..., :-1]
                               - _neg(cy) * g_in[..., 1:]))
                if cfg.frc_bry:
                    val = (1.0 - cext) * val + cext * t_ext
                val = _trim_hi(val * m[gh, INX], t[..., gh, INX],
                               grid.own_e, ax.pad)
                t = eset(t, (Ellipsis, gh, INX), val, own)
            else:
                val = t_ext if cfg.frc_bry else t[..., in1, INX]
                val = _trim_hi(val * m[gh, INX], t[..., gh, INX],
                               grid.own_e, ax.pad)
                t = eset(t, (Ellipsis, gh, INX), val, own)

    if not cfg.ew_periodic and not cfg.ns_periodic:
        # masked corner averages (reference: t3dbc_im.F:315-420)
        def corner(t, jc, ic, ja, ia, jb, ib, own):
            cff = m[ja, ia] + m[jb, ib]
            avg = torch.where(cff > 0.0,
                              (m[ja, ia] * t[..., ja, ia]
                               + m[jb, ib] * t[..., jb, ib])
                              / torch.clamp(cff, min=1.0),
                              t[..., jc, ic])
            return eset(t, (Ellipsis, jc, ic), avg, own)

        eg, ei, ng, ni = ax.gh, ax.in1, ay.gh, ay.in1
        t = corner(t, 1, 1, 1, 2, 2, 1, band(grid.own_s, grid.own_w))
        t = corner(t, 1, eg, 1, ei, 2, eg, band(grid.own_s, grid.own_e))
        t = corner(t, ng, 1, ng, 2, ni, 1, band(grid.own_n, grid.own_w))
        t = corner(t, ng, eg, ng, ei, ni, eg, band(grid.own_n, grid.own_e))
    return t


# ===========================================================================
# Closed-wall wrappers (used by init paths)
# ===========================================================================

def u_momentum_bc(u, grid, cfg: ModelConfig):
    """Closed-wall-only BC for u-type fields (no OBC, no boundary data)."""
    if cfg.fully_periodic:
        return u
    g2 = cfg.gamma2
    um = grid.umask
    ax, ay = _axes_of(cfg)
    if not cfg.ew_periodic:
        if not cfg.obc_west:
            u = eset(u, (Ellipsis, slice(None), 2), 0.0 * u[..., :, 2],
                     grid.own_w)
        if not cfg.obc_east:
            u = eset(u, (Ellipsis, slice(None), ax.gh),
                     0.0 * u[..., :, ax.gh], grid.own_e)
    if not cfg.ns_periodic:
        if not cfg.obc_south:
            u = eset(u, (Ellipsis, 1, slice(None)),
                     g2 * u[..., 2, :] * (um[1, :] if cfg.masking else 1.0),
                     grid.own_s)
        if not cfg.obc_north:
            u = eset(u, (Ellipsis, ay.gh, slice(None)),
                     g2 * u[..., ay.in1, :]
                     * (um[ay.gh, :] if cfg.masking else 1.0),
                     grid.own_n)
    return u


def v_momentum_bc(v, grid, cfg: ModelConfig):
    """Closed-wall-only BC for v-type fields."""
    if cfg.fully_periodic:
        return v
    g2 = cfg.gamma2
    vm = grid.vmask
    ax, ay = _axes_of(cfg)
    if not cfg.ns_periodic:
        if not cfg.obc_south:
            v = eset(v, (Ellipsis, 2, slice(None)), 0.0 * v[..., 2, :],
                     grid.own_s)
        if not cfg.obc_north:
            v = eset(v, (Ellipsis, ay.gh, slice(None)),
                     0.0 * v[..., ay.gh, :], grid.own_n)
    if not cfg.ew_periodic:
        if not cfg.obc_west:
            v = eset(v, (Ellipsis, slice(None), 1),
                     g2 * v[..., :, 2] * (vm[:, 1] if cfg.masking else 1.0),
                     grid.own_w)
        if not cfg.obc_east:
            v = eset(v, (Ellipsis, slice(None), ax.gh),
                     g2 * v[..., :, ax.in1]
                     * (vm[:, ax.gh] if cfg.masking else 1.0),
                     grid.own_e)
    return v
