"""Runtime configuration: `roms.in` parser + keyword registry (port of
roms_tpu/runconfig.py; reference: src/read_inp_mod.F:18-220 read_inp + kwread_* handlers,
src/keyword_registry.F register_keyword/lookup_keyword).

The reference's file format is kept verbatim so existing `roms.in` files
drive this framework unchanged: a keyword line `name: <comment>` followed
by whitespace-separated values on the next line(s).  Handlers update a
plain dict of ModelConfig overrides plus a `paths` dict (grid/initial/
forcing/climatology filenames and the output root).  New keywords register
via `@keyword("name")`, mirroring the reference's runtime-extensible
registry (reference: keyword_registry.F:23-61).
"""

from __future__ import annotations

import re
from typing import Callable, Dict, List

from roms_tpu_torch.config import ModelConfig

KEYWORDS: Dict[str, Callable] = {}


def keyword(name: str, required: bool = False):
    def deco(fn):
        KEYWORDS[name] = fn
        fn._required = required
        return fn
    return deco


def _floats(tokens: List[str]) -> List[float]:
    # Fortran double-precision literals: 1.D0, 6.0D0, 0.E-4
    return [float(re.sub(r"[dD]", "e", t)) for t in tokens]


@keyword("title")
def _title(vals, cfg, paths):
    paths["title"] = " ".join(" ".join(v) for v in vals).strip()


@keyword("time_stepping", required=True)
def _time_stepping(vals, cfg, paths):
    nt, dt, ndtfast, ninfo = _floats(vals[0][:4])
    cfg.update(ntimes=int(nt), dt=dt, ndtfast=int(ndtfast))
    paths["ninfo"] = int(ninfo)


@keyword("S-coord", required=True)
def _scoord(vals, cfg, paths):
    ts, tb, hc = _floats(vals[0][:3])
    cfg.update(theta_s=ts, theta_b=tb, hc=hc)


@keyword("rho0")
def _rho0(vals, cfg, paths):
    cfg.update(rho0=_floats(vals[0])[0])


@keyword("lin_rho_eos")
def _lin_rho_eos(vals, cfg, paths):
    v = _floats(vals[0][:4])
    cfg.update(nonlin_eos=False, tcoef=v[0], t0=v[1])
    if len(v) >= 4:
        cfg.update(scoef=v[2], s0=v[3])


@keyword("lateral_visc")
def _lateral_visc(vals, cfg, paths):
    cfg.update(visc2=_floats(vals[0])[0])


@keyword("gamma2")
def _gamma2(vals, cfg, paths):
    cfg.update(gamma2=_floats(vals[0])[0])


@keyword("tracer_diff2")
def _tracer_diff2(vals, cfg, paths):
    cfg.update(tnu2=_floats(vals[0])[0])


@keyword("bottom_drag")
def _bottom_drag(vals, cfg, paths):
    v = _floats(vals[0][:3])
    cfg.update(rdrg=v[0], rdrg2=v[1], zob=v[2])


@keyword("vertical_mixing")
def _vertical_mixing(vals, cfg, paths):
    v = _floats(vals[0])
    cfg.update(akv_bak=v[0], akt_bak=v[1] if len(v) > 1 else 0.0)


@keyword("ubind")
def _ubind(vals, cfg, paths):
    cfg.update(ubind=_floats(vals[0])[0])


@keyword("v_sponge")
def _v_sponge(vals, cfg, paths):
    cfg.update(v_sponge=_floats(vals[0])[0])


@keyword("grid", required=True)
def _grid(vals, cfg, paths):
    paths["grid"] = vals[0][0]


@keyword("initial", required=True)
def _initial(vals, cfg, paths):
    paths["nrrec"] = int(_floats(vals[0][:1])[0])
    paths["initial"] = vals[1][0] if len(vals) > 1 else "none"


@keyword("forcing")
def _forcing(vals, cfg, paths):
    paths["forcing"] = [t for row in vals for t in row]


@keyword("climatology")
def _climatology(vals, cfg, paths):
    paths["climatology"] = vals[0][0] if vals and vals[0] else "none"


@keyword("boundary")
def _boundary(vals, cfg, paths):
    paths["boundary"] = vals[0][0] if vals and vals[0] else "none"


@keyword("output_root_name", required=True)
def _output_root(vals, cfg, paths):
    paths["output_root"] = vals[0][0]


@keyword("MARBL_biogeochemistry")
def _marbl(vals, cfg, paths):
    paths["marbl_namelist"] = [t for row in vals for t in row]


class RunConfig:
    """Parsed runtime configuration."""

    def __init__(self, overrides: dict, paths: dict):
        self.overrides = overrides
        self.paths = paths

    def apply(self, cfg: ModelConfig) -> ModelConfig:
        """Overlay the runtime keywords onto a compile-time base config
        (the reference splits settings the same way: param.opt/cppdefs.opt
        at compile time, roms.in at run time)."""
        return cfg.replace(**self.overrides)


def read_inp(path: str, strict: bool = True) -> RunConfig:
    """Parse a `roms.in` file (reference: read_inp_mod.F:140-220).

    strict=True (default) errors on unrecognized keywords, like the
    reference's keyword registry which aborts on an unknown keyword
    (reference: read_inp_mod.F keyword lookup + error path) — a config
    must never silently run with half its settings ignored."""
    with open(path) as f:
        lines = f.readlines()

    overrides: dict = {}
    paths: dict = {}
    cfg_proxy = type("P", (), {"update": staticmethod(overrides.update)})

    i = 0
    n = len(lines)
    kw_re = re.compile(r"^([A-Za-z][\w\-]*):")
    while i < n:
        m = kw_re.match(lines[i])
        if not m:
            i += 1
            continue
        name = m.group(1)
        # collect the value block: subsequent non-empty, non-keyword lines
        vals: List[List[str]] = []
        j = i + 1
        while j < n and not kw_re.match(lines[j]):
            toks = lines[j].split("!")[0].split()
            if toks:
                vals.append(toks)
            elif vals:
                break  # blank line after data ends the block
            j += 1
        if name in KEYWORDS:
            KEYWORDS[name](vals, cfg_proxy, paths)
        else:
            paths.setdefault("unknown_keywords", []).append(name)
        i = j
    if strict and "unknown_keywords" in paths:
        raise ValueError(
            f"{path}: unrecognized keywords "
            f"{paths['unknown_keywords']} — registered keywords: "
            f"{sorted(KEYWORDS)} (reference: read_inp_mod.F aborts on "
            f"unknown keywords; pass strict=False to record instead)")
    return RunConfig(overrides, paths)
