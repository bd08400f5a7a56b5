"""The port's boundary conditions and lateral mixing against the JAX
package's, in float64 on the CPU, at rtol 1e-13 and atol 1e-13 *
max(1, max|ref|) (the arithmetic is transcribed operation by operation):

(a) every function of roms_tpu_torch/ops/bc.py against roms_tpu/ops/bc.py
    across the closed / Flather / Orlanski / specified menu, its radiation
    options, boundary data with and without per-point binding velocities,
    and pred_stage True and False;
(b) `hmix.visc3d` and `hmix.t3dmix` against roms_tpu/ops/hmix.py.

The same random fields, made with numpy from a seed, go to both packages.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from roms_tpu import grid as jgrid
from roms_tpu.config import ModelConfig
from roms_tpu.ops import bc as jbc
from roms_tpu.ops import hmix as jhmix
from roms_tpu.state import BoundaryData as JBoundaryData

from roms_tpu_torch import bridge
from roms_tpu_torch.ops import bc as tbc
from roms_tpu_torch.ops import hmix as thmix
from roms_tpu_torch.state import BoundaryData as TBoundaryData

from torch_helpers import np_tree, port_cfg

torch.set_num_threads(1)

NX, NY, NZ, NT = 12, 10, 5, 2
JY, IX = NY + 4, NX + 4
F64 = torch.float64

OPEN4 = dict(obc_west=True, obc_east=True, obc_south=True, obc_north=True)
MENU = {
    "closed": dict(),
    "flather": dict(OPEN4, frc_bry=True),
    "flather_nodata": dict(OPEN4),
    "orlanski": dict(OPEN4, obc_m2="orlanski", frc_bry=True, attnm2=0.3),
    "specified": dict(OPEN4, obc_m2="specified", obc_m3="specified",
                      obc_t="specified", frc_bry=True),
    "gradient": dict(OPEN4, obc_m2="gradient", obc_m3="gradient",
                     obc_t="specified"),
    "rad_normal": dict(OPEN4, frc_bry=True, obc_rad_normal=True),
    "rad_npo": dict(OPEN4, frc_bry=True, obc_rad_npo=True),
    "west_east": dict(obc_west=True, obc_east=True, frc_bry=True,
                      gamma2=-1.0),
    "south_north_ew_periodic": dict(obc_south=True, obc_north=True,
                                    frc_bry=True, ew_periodic=True),
    "no_mask": dict(OPEN4, frc_bry=True, masking=False),
}


def _cfg(name):
    kw = dict(nx=NX, ny=NY, nz=NZ, nt=NT, ew_periodic=False,
              ns_periodic=False, dt=60.0, ndtfast=20)
    kw.update(MENU[name])
    return ModelConfig(**kw)


def _setup(name, ub=False, seed=0):
    """(JAX cfg, port cfg, JAX grid, port grid, JAX bry, port bry, rng)."""
    cfg = _cfg(name)
    rng = np.random.default_rng(seed)
    h = 50.0 + 20.0 * rng.random((JY, IX))
    pm = 1e-3 * (1.0 + 0.1 * rng.random((JY, IX)))
    pn = 1e-3 * (1.0 + 0.1 * rng.random((JY, IX)))
    f = 1e-4 * (1.0 + 0.1 * rng.random((JY, IX)))
    rmask = (rng.random((JY, IX)) > 0.1).astype(np.float64)
    jg = jgrid.build_grid(cfg, h, pm, pn, f, rmask)
    tg = bridge.grid_from_numpy(np_tree(jg), dtype=F64, device="cpu")
    bry = {}
    for edge, n in (("west", JY), ("east", JY), ("south", IX),
                    ("north", IX)):
        if not getattr(cfg, f"obc_{edge}"):
            continue
        bry[f"zeta_{edge}"] = 0.05 * rng.standard_normal(n)
        bry[f"ubar_{edge}"] = 0.1 * rng.standard_normal(n)
        bry[f"vbar_{edge}"] = 0.1 * rng.standard_normal(n)
        bry[f"u_{edge}"] = 0.1 * rng.standard_normal((NZ, n))
        bry[f"v_{edge}"] = 0.1 * rng.standard_normal((NZ, n))
        bry[f"t_{edge}"] = 10.0 + rng.standard_normal((NT, NZ, n))
        if ub:
            bry[f"ub_{edge}"] = 0.05 + 0.1 * rng.random(n)
    jb = JBoundaryData(**{k: jnp.asarray(v) for k, v in bry.items()})
    tb = TBoundaryData(**{k: torch.as_tensor(v) for k, v in bry.items()})
    return cfg, port_cfg(cfg), jg, tg, jb, tb, rng


def _pair(rng, *shape, scale=1.0, offset=0.0):
    a = offset + scale * rng.standard_normal(shape)
    return jnp.asarray(a), torch.as_tensor(a)


def _close(got, ref, rtol=1e-13):
    g, r = got.numpy(), np.asarray(ref)
    assert g.shape == r.shape
    np.testing.assert_allclose(g, r, rtol=rtol,
                               atol=rtol * max(1.0, np.abs(r).max()))


# ------------------------------------------------------------- (a) BCs
@pytest.mark.parametrize("name", list(MENU))
def test_zetabc(name):
    cfg, tcfg, jg, tg, jb, tb, rng = _setup(name)
    jz, tz = _pair(rng, JY, IX, scale=0.1)
    js, ts = _pair(rng, JY, IX, scale=0.1)
    _close(tbc.zetabc(tz, ts, tg, tcfg, tb), jbc.zetabc(jz, js, jg, cfg, jb))


@pytest.mark.parametrize("ub", [False, True])
@pytest.mark.parametrize("name", list(MENU))
def test_barotropic_uv_bc(name, ub):
    cfg, tcfg, jg, tg, jb, tb, rng = _setup(name, ub=ub)
    j, t = zip(*[_pair(rng, JY, IX, scale=0.1) for _ in range(5)])
    ju, jus, jvs, jzn, jzs = j
    tu, tus, tvs, tzn, tzs = t
    _close(tbc.u2dbc(tu, tus, tvs, tzn, tzs, tg, tcfg, tb),
           jbc.u2dbc(ju, jus, jvs, jzn, jzs, jg, cfg, jb))
    _close(tbc.v2dbc(tu, tvs, tus, tzn, tzs, tg, tcfg, tb),
           jbc.v2dbc(ju, jvs, jus, jzn, jzs, jg, cfg, jb))


@pytest.mark.parametrize("pred_stage", [True, False])
@pytest.mark.parametrize("name", list(MENU))
def test_momentum_3d_bc(name, pred_stage):
    cfg, tcfg, jg, tg, jb, tb, rng = _setup(name, ub=name == "orlanski")
    j, t = zip(*[_pair(rng, NZ, JY, IX, scale=0.1) for _ in range(4)])
    _close(tbc.u3dbc(*t, tg, tcfg, tb, pred_stage=pred_stage),
           jbc.u3dbc(*j, jg, cfg, jb, pred_stage=pred_stage))
    _close(tbc.v3dbc(*t, tg, tcfg, tb, pred_stage=pred_stage),
           jbc.v3dbc(*j, jg, cfg, jb, pred_stage=pred_stage))


@pytest.mark.parametrize("pred_stage", [True, False])
@pytest.mark.parametrize("name", list(MENU))
def test_t3dbc(name, pred_stage):
    cfg, tcfg, jg, tg, jb, tb, rng = _setup(name)
    jt, tt = _pair(rng, NT, NZ, JY, IX, offset=10.0)
    js, ts = _pair(rng, NT, NZ, JY, IX, offset=10.0)
    ju, tu = _pair(rng, NZ, JY, IX, scale=0.1)
    jv, tv = _pair(rng, NZ, JY, IX, scale=0.1)
    _close(tbc.t3dbc(tt, ts, tu, tv, tg, tcfg, tb, pred_stage=pred_stage),
           jbc.t3dbc(jt, js, ju, jv, jg, cfg, jb, pred_stage=pred_stage))


@pytest.mark.parametrize("name", ["closed", "west_east", "no_mask",
                                  "south_north_ew_periodic"])
def test_closed_wall_wrappers(name):
    cfg, tcfg, jg, tg, _, _, rng = _setup(name)
    ju, tu = _pair(rng, NZ, JY, IX, scale=0.1)
    _close(tbc.u_momentum_bc(tu, tg, tcfg), jbc.u_momentum_bc(ju, jg, cfg))
    _close(tbc.v_momentum_bc(tu, tg, tcfg), jbc.v_momentum_bc(ju, jg, cfg))


def test_bc_inputs_untouched():
    """Every edge write lands in a clone: the arguments keep their
    values."""
    cfg, tcfg, jg, tg, jb, tb, rng = _setup("orlanski")
    t = [_pair(rng, NZ, JY, IX, scale=0.1)[1] for _ in range(4)]
    kept = [a.clone() for a in t]
    tbc.u3dbc(*t, tg, tcfg, tb, pred_stage=False)
    for a, b in zip(t, kept):
        assert torch.equal(a, b)


# ------------------------------------------------------------- (b) hmix
@pytest.mark.parametrize("sponge", [False, True])
@pytest.mark.parametrize("masking", [True, False])
def test_visc3d(masking, sponge):
    cfg, tcfg, jg, tg, _, _, rng = _setup("flather")
    cfg = cfg.replace(visc2=5.0, masking=masking)
    tcfg = port_cfg(cfg)
    ju, tu = _pair(rng, NZ, JY, IX, scale=0.1)
    jv, tv = _pair(rng, NZ, JY, IX, scale=0.1)
    jh, th = _pair(rng, NZ, JY, IX, scale=0.5, offset=5.0)
    kw_j, kw_t = {}, {}
    if sponge:
        for k in ("visc2_r", "visc2_p"):
            kw_j[k], kw_t[k] = _pair(rng, JY, IX, scale=0.5, offset=5.0)
    ref = jhmix.visc3d(ju, jv, jh, jg, cfg, **kw_j)
    got = thmix.visc3d(tu, tv, th, tg, tcfg, **kw_t)
    for a, b in zip(ref, got):
        _close(b, a)


@pytest.mark.parametrize("diff2", [False, True])
@pytest.mark.parametrize("masking", [True, False])
def test_t3dmix(masking, diff2):
    cfg, tcfg, jg, tg, _, _, rng = _setup("flather")
    cfg = cfg.replace(tnu2=1.0, masking=masking)
    tcfg = port_cfg(cfg)
    jt, tt = _pair(rng, NT, NZ, JY, IX, offset=10.0)
    jr, tr = _pair(rng, NT, NZ, JY, IX, offset=10.0)
    jh, th = _pair(rng, NZ, JY, IX, scale=0.5, offset=5.0)
    jd = td = None
    if diff2:
        jd, td = _pair(rng, NT, JY, IX, scale=0.1, offset=1.0)
    _close(thmix.t3dmix(tt, tr, th, tg, tcfg, diff2=td),
           jhmix.t3dmix(jt, jr, jh, jg, cfg, diff2=jd))


def test_config_round_trip():
    """bridge.config_from_dict rebuilds every field of a JAX config."""
    cfg = _cfg("orlanski")
    tcfg = port_cfg(cfg)
    assert dataclasses.asdict(tcfg).keys() == dataclasses.asdict(cfg).keys()
    for k, v in dataclasses.asdict(cfg).items():
        w = getattr(tcfg, k)
        assert (w.name == v.name) if hasattr(v, "name") else w == v, k
