"""Rank functions of the port's distributed tests (tests/test_torch_dist.py,
tests/test_torch_dist_jax.py, tests/test_torch_dist_nh.py): each runs in
a spawned rank as fn(mesh, *args) through
`roms_tpu_torch.parallel.dist.launch`, and returns numpy arrays and plain
values.  This module imports the port
only, so a rank starts without JAX.  Cases are named by a spec (case,
config keywords, setup keywords), built in float64 on the CPU by `build`
in the test and in every rank alike.
"""

from types import SimpleNamespace

import numpy as np
import torch

from roms_tpu_torch import bridge, nhmg
from roms_tpu_torch.cases import (bench_production, filament, obc_basin,
                                  rivers_ana)
from roms_tpu_torch.diag import make_distributed_diag
from roms_tpu_torch.driver import run_distributed
from roms_tpu_torch.monitor import BlowupError
from roms_tpu_torch.parallel.dist import from_blocks, pad_for_mesh, to_block
from roms_tpu_torch.parallel.halo import (HaloExchange, halo_group,
                                          mixed_fill, periodic_fill)
from roms_tpu_torch.particles import (ParticleState,
                                      make_distributed_particle_step)

F64 = torch.float64
H = 2


def build(spec):
    """(cfg, grid, state, forcing) of a spec (case, config keywords,
    setup keywords), in float64 on the CPU."""
    case, cfg_kw, setup_kw = spec
    if case == "bench_production":
        cfg = bench_production.config(**{k: cfg_kw[k] for k in
                                         ("nx", "ny", "nz", "nt")})
        mod = bench_production
    elif case == "filament":
        cfg, mod = filament.config(), filament
    elif case == "rivers_ana":
        cfg, mod = rivers_ana.config(), rivers_ana
    else:
        cfg, mod = obc_basin.config(case.split(":")[1]), obc_basin
    cfg = cfg.replace(**{k: v for k, v in cfg_kw.items()
                         if k not in ("nx", "ny", "nz", "nt")
                         or case != "bench_production"})
    grid, st, frc = mod.setup(cfg, dtype=F64, device="cpu", **setup_kw)
    return cfg, grid, st, frc


def run_case(mesh, spec, nsteps, poison=None):
    """run_distributed of the spec's case: (state as numpy, diag rows).
    poison: a (j, i) point of the padded global u set to NaN first."""
    cfg, grid, st, frc = build(spec)
    if poison is not None:
        u = st.u.clone()
        u[:, poison[0], poison[1]] = float("nan")
        st = st.replace(u=u)
    s, rows = run_distributed(grid, st, frc, cfg, mesh, nsteps=nsteps)
    return bridge.to_numpy(s), rows


def forced(spec):
    """(cfg, grid, state, forcing, hook) of a production 48x32 spec with
    chip_smoke.py's mCDR point releases and 3-argument bulk-forcing hook
    (`production_forced`), on the CPU."""
    import chip_smoke
    _, cfg_kw, _ = spec
    return chip_smoke.production_forced("cpu", nz=cfg_kw["nz"],
                                        nt=cfg_kw["nt"])


def run_cases(mesh, specs, nsteps):
    """`run_case` of each spec in turn: a list of (state, diag rows)."""
    return [run_case(mesh, spec, nsteps) for spec in specs]


def nh_blocks(mesh, cases):
    """`nhmg.nh_solve` on this rank's block of each case's global arrays,
    a case being (arrays, cfg, n_iter): arrays a dict of numpy u, v, w,
    hz, z_r, pm, pn and, with cfg.masking, umask and vmask.  The solve gets
    the block's edge ownership, the mesh's halo refresh and world sum;
    then `nhmg.divergence` of its result on the block.  Returns, a case,
    (the joined p, u, v, w and divergence; res0; res)."""
    py, px = mesh.shape
    out = []
    for arrays, cfg, n_iter in cases:
        b = to_block({k: torch.as_tensor(a) for k, a in arrays.items()},
                     mesh, H)
        grid = SimpleNamespace(umask=b.get("umask"), vmask=b.get("vmask"),
                               own_w=mesh.ix == 0, own_e=mesh.ix == px - 1,
                               own_s=mesh.iy == 0, own_n=mesh.iy == py - 1)
        halo = HaloExchange(mesh, H, cfg.ew_periodic, cfg.ns_periodic)
        r = nhmg.nh_solve(b["u"], b["v"], b["w"], b["hz"], b["z_r"], b["pm"],
                          b["pn"], grid, cfg, n_iter=n_iter, halo=halo)
        div = nhmg.divergence(r.u, r.v, r.w, b["hz"], b["pm"], b["pn"], cfg,
                              grid, b["z_r"], halo)
        out.append((from_blocks({"p": r.p, "u": r.u, "v": r.v, "w": r.w,
                                 "div": div}, mesh, H),
                    float(r.res0), float(r.res)))
    return out


def run_forced(mesh, spec, nsteps):
    """run_distributed of `forced(spec)`: (state as numpy, diag rows)."""
    cfg, grid, st, frc, hook = forced(spec)
    s, rows = run_distributed(grid, st, frc, cfg, mesh, nsteps=nsteps,
                              forcing_fn=hook)
    return bridge.to_numpy(s), rows


def blowup(mesh, spec, poison):
    """run_distributed with a NaN in one rank's block: the message of the
    BlowupError this rank raised."""
    try:
        run_case(mesh, spec, 2, poison=poison)
    except BlowupError as e:
        return str(e)
    return None


FILLS = ((True, True), (False, True), (True, False), (False, False))


def halo(mesh, shape, seed):
    """HaloExchange and halo_group on blocks of random global arrays of
    `shape` (.., ny + 2h, nx + 2h) whose ghosts were trashed, gathered
    back, for each (ew_periodic, ns_periodic) of FILLS."""
    out = []
    rng = np.random.default_rng(seed)
    for ew, ns in FILLS:
        glob = torch.as_tensor(rng.standard_normal(shape))
        ex = HaloExchange(mesh, h=H, ew_periodic=ew, ns_periodic=ns)
        blk = trash(to_block({"f": glob}, mesh, H)["f"], mesh, ew, ns)
        two = (blk[0], blk[1:])
        got = {"f": ex(blk)}
        got["g0"], got["g1"] = halo_group(ex, *two)
        out.append(from_blocks(got, mesh, H))
    return out


def trash(a, mesh, ew, ns):
    """The block with -9e9 in every ghost line the exchange must refresh:
    all of them, but the ring line (h-1 / -h) of a block at a closed
    physical edge, which the boundary conditions own."""
    py, px = mesh.shape
    a = a.clone()
    keep_w = not ew and mesh.ix == 0
    keep_e = not ew and mesh.ix == px - 1
    keep_s = not ns and mesh.iy == 0
    keep_n = not ns and mesh.iy == py - 1
    a[..., :, :H - keep_w] = -9e9
    a[..., :, a.shape[-1] - H + keep_e:] = -9e9
    a[..., :H - keep_s, :] = -9e9
    a[..., a.shape[-2] - H + keep_n:, :] = -9e9
    return a


def reference_fills(shape, seed):
    """What `halo` must give: the single-block fills of the same arrays."""
    rng = np.random.default_rng(seed)
    out = []
    for ew, ns in FILLS:
        glob = torch.as_tensor(rng.standard_normal(shape))
        fill = (periodic_fill(glob, H) if ew and ns else
                mixed_fill(glob, H, ew_periodic=ew, ns_periodic=ns))
        out.append(fill.numpy())
    return out


def diag(mesh, spec, state_np):
    """The distributed diagnostics of a given padded-global state."""
    cfg, grid, _, _ = build(spec)
    st = bridge.state_from_numpy(state_np, dtype=F64, device="cpu")
    cfg_p = pad_for_mesh(cfg, mesh)
    pads = (cfg_p.pad_n, cfg_p.pad_e)
    d = make_distributed_diag(cfg_p, mesh)(to_block(st, mesh, H, pads),
                                           to_block(grid, mesh, H, pads))
    return [float(x) for x in d]


def particles(mesh, spec, fields, ps_np, nsteps):
    """`nsteps` distributed particle steps on given padded-global fields
    (u, v, we, wi, hz); the particle state as numpy."""
    cfg, grid, _, _ = build(spec)
    cfg_p = pad_for_mesh(cfg, mesh)
    pads = (cfg_p.pad_n, cfg_p.pad_e)
    f = to_block({k: torch.as_tensor(v) for k, v in fields.items()},
                 mesh, H, pads)
    g = to_block(grid, mesh, H, pads)
    ps = ParticleState(**{k: torch.as_tensor(v) for k, v in ps_np.items()})
    step = make_distributed_particle_step(cfg, mesh)
    for _ in range(nsteps):
        ps = step(ps, f["u"], f["v"], f["we"], f["wi"], f["hz"], g)
    return bridge.to_numpy(ps)
