"""Non-hydrostatic pressure projection (port of roms_tpu/nhmg.py;
reference: NHMG/src/nhmg.f90:24-100 entry points, solver
NHMG/src/mg_solvers.f90:17-149, seamount validation
NHMG/tests/mg_testseamount.f90).

A preconditioned conjugate gradient on the cell-centred pressure Poisson
problem, with a vertical-line (tridiagonal) preconditioner, as in the
JAX package; its docstring sets out the discrete projection.  In short:
the operator is L = G^T A G, with G the discrete z-gradient (horizontal
differences minus the sigma slope times the averaged vertical derivative
when cfg.nh_sigma_terms), A the face areas and G^T the exact adjoint of
G, so L is symmetric positive semi-definite and U - G p has zero
tilted-face divergence.  Where the JAX package builds G^T with
`jax.linear_transpose`, `_gradient_t` writes it out by hand.

The PCG runs a fixed cfg.nh_iters iterations on the device and freezes
once the residual falls to 1e-13 of its start, with `torch.where` and no
read of the residual on the host.  The clamps of the two divisions at
1e-300 are 0 in float32, as in the JAX package.

On a rank mesh (`parallel.dist`) the projection is one global problem,
as the reference's NHMG solves it with MPI halo exchanges
(NHMG/src/nhmg.f90), and its result is the single block's to
round-off.  Global: the walls, put only at the physical edges a block
owns (the east/north one `pad_e`/`pad_n` cells inside a padded block,
as ops/bc.py places it), so faces across a shared edge stay active; and
every dot product, each block's sum over its own cells added over the
ranks.  Per column, with no communication: the line preconditioner.
The operator reads its argument one cell beyond the block, so each
iteration makes one halo refresh (of the search direction) and two
world sums (one of d.Ad; one of r.z and r.r together); the solve adds
one refresh of (u, v) for the right-hand side, one world sum of two
numbers at the start and one refresh of p for the correction: n_iter + 2
refreshes and 2 n_iter + 1 sums.  Every rank makes them in the same
order whatever its residual.  The JAX package's own mesh step solves one
problem a block instead (ROADMAP Queue 3); the port holds its mesh
projection to the JAX package's single-device one.

Remaining deviation (the JAX package's, documented there): w is not
prognostic.  The step passes a zero trial w and discards nh.w, so the
non-divergence holds for (u, v, nh.w), not for (u, v) with the model's
recomputed vertical velocity.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from bench_h100.reference.config import ModelConfig
from bench_h100.reference.parallel.halo import halo_group


class NHResult(NamedTuple):
    p: torch.Tensor       # (nz, jy, ix) non-hydrostatic pressure potential
    u: torch.Tensor       # corrected velocities
    v: torch.Tensor
    w: torch.Tensor       # (nz+1, jy, ix) at w points
    res0: torch.Tensor    # initial r.h.s. norm (0-d)
    res: torch.Tensor     # final residual norm (0-d)


def _west(a):
    """a[.., i-1] at [.., i] (periodic roll, as jnp.roll(a, 1, -1))."""
    return torch.roll(a, 1, dims=-1)


def _south(a):
    return torch.roll(a, 1, dims=-2)


def _east(a):
    return torch.roll(a, -1, dims=-1)


def _north(a):
    return torch.roll(a, -1, dims=-2)


def _owned(flag) -> bool:
    """An edge-ownership flag (None on a single block) as a bool."""
    return flag is None or bool(flag)


def _span(n: int, own_lo, own_hi, pad: int, device):
    """One axis of a block of n points: (cells, faces, own) as bool
    vectors.  cells: the physical interior the block holds, halo included;
    a wall stands only at an edge the block owns, below index 2 and above
    n - 3 - pad (the high edge's block holds the mesh-divisibility pad
    beyond the physical edge, ops/bc.py:_Ax), and across a shared edge the
    halo cells are interior.
    faces: index i, between cells i-1 and i, active between two interior
    cells.  own: the interior cells in the block's own range [2, n-2)."""
    i = torch.arange(n, device=device)
    lo = 2 if _owned(own_lo) else 0
    hi = n - 3 - pad if _owned(own_hi) else n - 1
    cells = (i >= lo) & (i <= hi)
    return cells, (i >= lo + 1) & (i <= hi), cells & (i >= 2) & (i <= n - 3)


def _coefficients(hz, z_r, pm, pn, umask, vmask, cfg: ModelConfig,
                  grid=None):
    """Face coefficients of the Poisson operator, zeroed outside the
    interior and at land and wall faces; the cell mask (where G and G^T
    are evaluated) and the owned interior (`_span`, from the grid's edge
    ownership; the whole interior on a single block)."""
    jy, ix = pm.shape
    dx = 1.0 / pm
    dy = 1.0 / pn
    # u faces: index i holds the face between cells i-1, i
    hz_u = 0.5 * (hz + _west(hz))
    dy_u = 0.5 * (dy + _west(dy))
    pm_u = 0.5 * (pm + _west(pm))
    hz_v = 0.5 * (hz + _south(hz))
    dx_v = 0.5 * (dx + _south(dx))
    pn_v = 0.5 * (pn + _south(pn))

    cx, fx, ox = _span(ix, getattr(grid, "own_w", None),
                       getattr(grid, "own_e", None), cfg.pad_e, pm.device)
    cy, fy, oy = _span(jy, getattr(grid, "own_s", None),
                       getattr(grid, "own_n", None), cfg.pad_n, pm.device)
    # on a single block: interior cells [2:-2], active u faces 3..ix-3
    # (between interior cells), walls (faces 2 and ix-2) carry zero flux
    face_u = fx[None, :] & cy[:, None]
    face_v = fy[:, None] & cx[None, :]
    mu = face_u.to(hz.dtype) * (umask if umask is not None else 1.0)
    mv = face_v.to(hz.dtype) * (vmask if vmask is not None else 1.0)

    au = hz_u * dy_u * pm_u * mu                 # (nz, jy, ix)
    av = hz_v * dx_v * pn_v * mv
    dA = dx * dy
    dz_w = z_r[1:] - z_r[:-1]                    # (nz-1, jy, ix)
    aw_int = dA[None] / dz_w                     # interior z faces 1..nz-1
    aw_top = dA / (0.5 * hz[-1])                 # Dirichlet p=0 at surface
    cell = (cy[:, None] & cx[None, :]).to(hz.dtype)
    own = (oy[:, None] & ox[None, :]).to(hz.dtype)
    return au, av, aw_int, aw_top, dA, cell, own


class _Geometry(NamedTuple):
    au: torch.Tensor      # hz_u*dy_u*pm_u * face mask (orthogonal coeff)
    av: torch.Tensor
    aw_int: torch.Tensor
    aw_top: torch.Tensor
    dA: torch.Tensor
    cell: torch.Tensor    # where G and G^T are evaluated
    own: torch.Tensor     # the owned interior: b, r, z, Ad and the dots
    area_u: torch.Tensor  # hz_u*dy_u * face mask (area only)
    area_v: torch.Tensor
    pm_u: torch.Tensor
    pn_v: torch.Tensor
    zx_u: torch.Tensor    # sigma-surface slope at u faces (per level)
    zy_v: torch.Tensor
    dz_w: torch.Tensor
    hz_top: torch.Tensor
    mu: torch.Tensor      # active-face indicators (au > 0), (av > 0)
    mv: torch.Tensor
    sigma: bool


def _geometry(hz, z_r, pm, pn, umask, vmask, cfg: ModelConfig,
              grid=None) -> _Geometry:
    au, av, aw_int, aw_top, dA, cell, own = _coefficients(
        hz, z_r, pm, pn, umask, vmask, cfg, grid)
    pm_u = 0.5 * (pm + _west(pm))
    pn_v = 0.5 * (pn + _south(pn))
    mu = (au > 0.0).to(hz.dtype)
    mv = (av > 0.0).to(hz.dtype)
    area_u = au / torch.clamp_min(pm_u, 1e-300) * mu
    area_v = av / torch.clamp_min(pn_v, 1e-300) * mv
    # sigma-surface slope at the faces, per level (reference: the zx/zy
    # metric arrays of mg_define_matrices.f90)
    zx_u = (z_r - _west(z_r)) * pm_u[None] * mu
    zy_v = (z_r - _south(z_r)) * pn_v[None] * mv
    return _Geometry(au=au, av=av, aw_int=aw_int, aw_top=aw_top, dA=dA,
                     cell=cell, own=own, area_u=area_u, area_v=area_v,
                     pm_u=pm_u, pn_v=pn_v, zx_u=zx_u, zy_v=zy_v,
                     dz_w=z_r[1:] - z_r[:-1], hz_top=hz[-1], mu=mu, mv=mv,
                     sigma=bool(cfg.nh_sigma_terms))


def _gradient(p, geo: _Geometry):
    """Discrete z-coordinate gradient of the cell pressure at the three
    face families: gx (u faces), gy (v faces), gz (w faces 0..nz; floor
    Neumann 0, surface Dirichlet p=0 at half-cell distance)."""
    gz_int = (p[1:] - p[:-1]) / geo.dz_w
    gz_top = (0.0 - p[-1]) / (0.5 * geo.hz_top)
    gz = torch.cat([torch.zeros_like(p[:1]), gz_int, gz_top[None]])
    dpx = (p - _west(p)) * geo.pm_u[None]
    dpy = (p - _south(p)) * geo.pn_v[None]
    if geo.sigma:
        gz_c = 0.5 * (gz[1:] + gz[:-1])                 # cell centres
        gx = dpx - geo.zx_u * (0.5 * (gz_c + _west(gz_c)))
        gy = dpy - geo.zy_v * (0.5 * (gz_c + _south(gz_c)))
    else:
        gx, gy = dpx, dpy
    return gx * geo.mu, gy * geo.mv, gz * geo.cell[None]


def _gradient_t(fx, fy, fz, geo: _Geometry):
    """The exact adjoint G^T of `_gradient`: <G p, (fx, fy, fz)> =
    <p, G^T (fx, fy, fz)> for every p (the negated tilted-face divergence
    of area-weighted face fields)."""
    fx = fx * geo.mu
    fy = fy * geo.mv
    fz = fz * geo.cell[None]
    ax = fx * geo.pm_u[None]
    ay = fy * geo.pn_v[None]
    out = ax - _east(ax) + ay - _north(ay)
    if geo.sigma:
        bx = -geo.zx_u * fx
        by = -geo.zy_v * fy
        gz_c = 0.5 * (bx + _east(bx)) + 0.5 * (by + _north(by))
        half = 0.5 * gz_c
        fz[1:] += half
        fz[:-1] += half
    # gz[1:nz] = (p[1:] - p[:-1]) / dz_w; gz[nz] = -p[-1] / (hz_top / 2);
    # gz[0] is the constant floor value and takes nothing back
    c = fz[1:-1] / geo.dz_w
    out[1:] += c
    out[:-1] -= c
    out[-1] -= fz[-1] / (0.5 * geo.hz_top)
    return out


def _aw_faces(geo: _Geometry):
    """w-face areas 0..nz (floor face zero: Neumann)."""
    nz = geo.dz_w.shape[0] + 1
    flat = geo.dA.expand((nz - 1,) + tuple(geo.dA.shape))
    return torch.cat([torch.zeros_like(geo.dA)[None], flat,
                      geo.dA[None]]) * geo.cell[None]


def _apply(p, au, av, aw_int, aw_top, cell):
    """L(p) = div(a grad p) of the orthogonal operator; Neumann at the
    floor, Dirichlet 0 above the surface."""
    fx = au * (p - _west(p))                     # at u faces
    fy = av * (p - _south(p))
    div = _east(fx) - fx + _north(fy) - fy
    fz = aw_int * (p[1:] - p[:-1])               # upward flux
    div[:-1] += fz
    div[1:] -= fz
    div[-1] -= aw_top * p[-1]                    # to the p=0 surface ghost
    return div * cell


def _line_precond(r, au, av, aw_int, aw_top, cell):
    """Vertical tridiagonal part of L (plus the full diagonal): one Thomas
    solve per column, unrolled over the levels (its launches grow with
    nz; ROADMAP Queue 2 holds a column kernel for it)."""
    nz = r.shape[0]
    # diagonal: -(sum of all face coefficients at the cell)
    diag = -(au + _east(au) + av + _north(av))
    diag[:-1] -= aw_int
    diag[1:] -= aw_int
    diag[-1] -= aw_top
    diag = torch.where(cell > 0.0, diag, -1.0)
    # coupling k-1 <- k; decoupled outside the active columns (their diag
    # is -1, rhs 0)
    lower = aw_int * cell
    dprime = [None] * nz
    beta = diag[0]
    dprime[0] = r[0] / beta
    cs = [None] * (nz - 1)
    for k in range(nz - 1):
        cs[k] = lower[k] / beta
        beta = diag[k + 1] - lower[k] * cs[k]
        dprime[k + 1] = (r[k + 1] - lower[k] * dprime[k]) / beta
    x = [None] * nz
    x[nz - 1] = dprime[nz - 1]
    for k in range(nz - 2, -1, -1):
        x[k] = dprime[k] - cs[k] * x[k + 1]
    return torch.stack(x) * cell


def _masks(grid, cfg: ModelConfig):
    if not (cfg.masking and grid is not None):
        return None, None
    return getattr(grid, "umask", None), getattr(grid, "vmask", None)


def _identity(a):
    return a


def nh_solve(u, v, w, hz, z_r, pm, pn, grid, cfg: ModelConfig,
             n_iter: int | None = None, halo=None) -> NHResult:
    """Project (u, v, w) onto a discretely non-divergent field.

    u/v: (nz, jy, ix) at u/v points; w: (nz+1, jy, ix) at w points (w[0]
    the floor, w[nz] the surface).  Returns the corrected fields and the
    residual norms (reference: nhmg_solve, NHMG/src/nhmg.f90).

    On a rank mesh: the arrays are the rank's block, `grid` carries its
    edge ownership and `halo` is its halo refresh (a `HaloExchange`:
    called, it refreshes an array; its `world_sum` adds a small tensor
    over the ranks); the result is the global projection's on the block's
    own cells and faces (the halo's are left for the caller's refresh).
    Without it (a single block) there is no refresh and the sums are the
    block's own."""
    if n_iter is None:
        n_iter = cfg.nh_iters
    umask, vmask = _masks(grid, cfg)
    geo = _geometry(hz, z_r, pm, pn, umask, vmask, cfg, grid)
    au, av, aw_int, aw_top, own = (geo.au, geo.av, geo.aw_int,
                                   geo.aw_top, geo.own)
    aw_f = _aw_faces(geo)
    refresh = _identity if halo is None else halo

    def a_pos(x):
        gx, gy, gz = _gradient(refresh(x), geo)
        return _gradient_t(geo.area_u * gx, geo.area_v * gy, aw_f * gz,
                           geo) * own

    def m_pos(x):
        return -_line_precond(x, au, av, aw_int, aw_top, own)

    def dots(*pairs):
        """Each pair's dot product: the block's sum over its own cells
        (zero elsewhere), then on a mesh one world sum for all of them."""
        sums = [torch.sum(a_ * b_) for a_, b_ in pairs]
        return sums if halo is None else halo.world_sum(torch.stack(sums))

    # r.h.s. of the normal equations G^T A G p = G^T A U*; it reads u and
    # v one face beyond the block
    if halo is not None:
        u_b, v_b = halo_group(halo, u, v)
    else:
        u_b, v_b = u, v
    w_f = w.clone()
    w_f[0] = 0.0                                 # no flux through the floor
    bp = _gradient_t(geo.area_u * u_b * geo.mu, geo.area_v * v_b * geo.mv,
                     aw_f * w_f, geo) * own

    p = torch.zeros_like(bp)
    r = bp
    z = m_pos(r)
    d = z
    rz, rr = dots((r, z), (bp, bp))
    res0 = torch.sqrt(rr)
    res = res0
    # freeze the recurrence once converged: CG continued past the
    # round-off floor re-amplifies noise (the JAX package's rtol)
    rtol = 1e-13
    done = torch.zeros((), dtype=torch.bool, device=bp.device)
    for _ in range(n_iter):
        ad = a_pos(d)
        (dad,) = dots((d, ad))
        alpha = rz / torch.clamp_min(dad, 1e-300)
        p_n = p + alpha * d
        r_n = r - alpha * ad
        z = m_pos(r_n)
        rz_new, rr = dots((r_n, z), (r_n, r_n))
        beta = rz_new / torch.clamp_min(rz, 1e-300)
        d_n = z + beta * d
        p = torch.where(done, p, p_n)
        r = torch.where(done, r, r_n)
        d = torch.where(done, d, d_n)
        rz = torch.where(done, rz, rz_new)
        # the norm of the frozen r once done, as the JAX package's
        # sqrt(dot(r, r)) after the freeze
        res = torch.where(done, res, torch.sqrt(rr))
        done = done | (res <= rtol * res0)

    # correction: U - G p (the same discrete gradient)
    gx, gy, gz = _gradient(refresh(p), geo)
    gz[0] = 0.0
    return NHResult(p=p, u=u - gx, v=v - gy, w=w - gz, res0=res0, res=res)


def divergence(u, v, w, hz, pm, pn, cfg: ModelConfig, grid=None,
               z_r=None, halo=None):
    """Tilted-face volume-flux divergence on the discrete operators of the
    projection (a diagnostic), on the owned interior.  With
    cfg.nh_sigma_terms=False this is the orthogonal divergence.  On a
    rank mesh, `grid` carries the block's edge ownership and `halo`
    refreshes (u, v) first, as in `nh_solve`."""
    umask, vmask = _masks(grid, cfg)
    if z_r is None:
        z_r = torch.cumsum(hz, dim=0) - 0.5 * hz
    geo = _geometry(hz, z_r, pm, pn, umask, vmask, cfg, grid)
    if halo is not None:
        u, v = halo_group(halo, u, v)
    aw_f = _aw_faces(geo)
    w_f = w.clone()
    w_f[0] = 0.0
    return _gradient_t(geo.area_u * u * geo.mu, geo.area_v * v * geo.mv,
                       aw_f * w_f, geo) * geo.own
