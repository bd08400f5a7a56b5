"""The JAX package's nested parent/child workflow (the flow of
tests/test_nested_flow.py) in float64 on the CPU, returning its numbers.

tests/test_torch_nested_flow.py runs `flow` live and holds the port's flow
(roms_tpu_torch/cases/nested_basin.py) to it.  chip_smoke.py, which may
not import JAX, holds the port's flow on the card to the same numbers
kept in tests/data/nested_flow_jax.txt; the test checks that file against
the live flow too.  To write the file anew:

    JAX_PLATFORMS=cpu python tests/jax_nested_flow.py

The file holds, one value a line: the child's content change, its
integrated captured outward flux, the injected rate, the re-forced
parent's content before and after its 2 steps, then the tuned west
binding velocity ub_west point by point.
"""

import os
import sys
import tempfile

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
sys.path.insert(0, os.path.dirname(HERE))

import conftest  # noqa: E402,F401  (JAX on the CPU, float64)
import jax.numpy as jnp  # noqa: E402

from roms_tpu.cases import obc_basin  # noqa: E402
from roms_tpu.cdr import cdr_3d  # noqa: E402
from roms_tpu.driver import run  # noqa: E402
from roms_tpu.io.netcdf import open_dataset  # noqa: E402
from roms_tpu.pflx import calc_pflx, init_pflx  # noqa: E402
from roms_tpu.sponge_tune import (adjust_orlanski, init_sponge_tune,  # noqa: E402
                                  to_boundary)
from roms_tpu.state import zero_boundary  # noqa: E402
from test_nested_flow import (NC, NP, NSTEPS, _child_domain,  # noqa: E402
                              _parent_run)

DATA = os.path.join(HERE, "data", "nested_flow_jax.txt")
EDGES = ("west", "east", "south", "north")


def pad_edge(vals):
    out = np.empty(vals.shape[:-1] + (vals.shape[-1] + 4,))
    out[..., 2:-2] = vals
    out[..., :2] = vals[..., :1]
    out[..., -2:] = vals[..., -1:]
    return out


def flow(tmp_path):
    """tests/test_nested_flow.py's flow; returns (its numbers, as the
    file holds them, and the child's state after its run)."""
    p_cfg, _, _, extract_path, pflx_recs, edges = _parent_run(tmp_path)
    c_cfg, c_grid, c_st, c_frc = _child_domain()

    with open_dataset(extract_path) as ds:
        times = np.asarray(ds["ocean_time"][...])
        series = {e: {v: np.asarray(ds[f"{e}_{v}"][...])
                      for v in ("zeta", "ubar", "vbar", "temp")}
                  for e in edges}

    def bry_at(t):
        r = np.clip(np.searchsorted(times, t) - 1, 0, len(times) - 2)
        w = np.clip((t - times[r]) / max(times[r + 1] - times[r], 1e-30),
                    0.0, 1.0)
        kw = {}
        for e in edges:
            sv = {k: (1 - w) * a[r] + w * a[r + 1]
                  for k, a in series[e].items()}
            ub, vb = sv["ubar"], sv["vbar"]
            kw[f"zeta_{e}"] = jnp.asarray(pad_edge(sv["zeta"]))
            kw[f"ubar_{e}"] = jnp.asarray(pad_edge(ub))
            kw[f"vbar_{e}"] = jnp.asarray(pad_edge(vb))
            kw[f"u_{e}"] = jnp.broadcast_to(jnp.asarray(pad_edge(ub)),
                                            (c_cfg.nz, NC + 4))
            kw[f"v_{e}"] = jnp.broadcast_to(jnp.asarray(pad_edge(vb)),
                                            (c_cfg.nz, NC + 4))
            kw[f"t_{e}"] = jnp.broadcast_to(
                jnp.asarray(pad_edge(sv["temp"]))[None],
                (c_cfg.nt, c_cfg.nz, NC + 4))
        return zero_boundary(c_cfg).replace(**kw)

    tun = init_sponge_tune(c_cfg)
    c_cfg = c_cfg.replace(upscale_output=True)
    box = {"tun": tun, "pf": init_pflx(c_cfg), "net_flux": 0.0,
           "captured": None}

    def forcing_fn(t, base, st):
        return base.replace(bry=to_boundary(box["tun"], bry_at(t)))

    def hook(s, i):
        box["pf"], up, vp = calc_pflx(box["pf"], s, c_grid, c_cfg,
                                      timescale=4 * c_cfg.dt)
        rec = pflx_recs[min(i - 1, len(pflx_recs) - 1)]
        parent = {e: jnp.asarray(pad_edge(np.abs(rec[e]))) for e in rec}
        box["tun"] = adjust_orlanski(box["tun"], up, vp, parent, c_cfg,
                                     sp_timscale=20 * c_cfg.dt)
        tot = 0.0
        for e in EDGES:
            tot += float(jnp.sum(s.upscale[e][0][:, 2:-2]))
        box["net_flux"] += c_cfg.dt * tot
        box["captured"] = s.upscale

    def content(st, grid, interior):
        da = 1.0 / (np.asarray(grid.pm) * np.asarray(grid.pn))
        tz = np.asarray(st.t[0], np.float64) * np.asarray(st.hz, np.float64)
        tz = tz * da[None]
        return float((tz[:, 2:-2, 2:-2] if interior else tz).sum())

    c0 = content(c_st, c_grid, True)
    st_end, _ = run(c_grid, c_st, c_frc, c_cfg, nsteps=NSTEPS,
                    forcing_fn=forcing_fn, step_hook=hook)
    dc = content(st_end, c_grid, True) - c0

    jyp, ixp = p_cfg.ny + 4, p_cfg.nx + 4
    flx3 = np.zeros((p_cfg.nt, p_cfg.nz, jyp, ixp))
    i0 = NP // 4 + 2
    for e in ("west", "east"):
        strip = np.asarray(box["captured"][e][0])[:, 2:-2]
        pc = strip.reshape(p_cfg.nz, NC // 2, 2).sum(axis=2)
        ip = i0 if e == "west" else i0 + NP // 2 - 1
        flx3[0, :, i0:i0 + NP // 2, ip] += pc
    inj = float(flx3.sum())
    p_cfg2 = p_cfg.replace(ntimes=2)
    g2, s2, f2 = obc_basin.setup(p_cfg2)
    f2 = f2.replace(cdr=cdr_3d(p_cfg2, flx3))
    pc0 = content(s2, g2, False)
    s2b, _ = run(g2, s2, f2, p_cfg2, nsteps=2, collect_diag=False)
    pc1 = content(s2b, g2, False)
    return (np.concatenate([[dc, box["net_flux"], inj, pc0, pc1],
                            np.asarray(box["tun"].ub_west)]), st_end)


if __name__ == "__main__":
    from pathlib import Path
    with tempfile.TemporaryDirectory() as w:
        np.savetxt(DATA, flow(Path(w))[0], fmt="%.16E")
    print("written", DATA)
