"""Biogeochemistry coupling surface (port of roms_tpu/bgc/api.py;
reference: src/marbl_driver.F marbldrv_column_physics + surface-flux calls
at marbl_driver.F:1210-1329; src/bec2_driver.F ecosys_bec2_tile).

Both of the reference's BGC engines couple through one contract: given
the physical state of every column, produce (a) interior tracer
tendencies and (b) surface tracer fluxes, applied to the updated tracers
at the end of the tracer corrector (reference: step3d_t_ISO.F:1162-1164).
The contract is a tuple of functions on full fields (nz, jy, ix) of
tensors; implementations register by name (reference analog: the
BIOLOGY_BEC2 / MARBL compile switches).
"""

from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Optional, Sequence

import torch


class BGCContext(NamedTuple):
    """Physical inputs handed to the BGC model every corrector step."""
    temp: torch.Tensor      # (nz, jy, ix) potential temperature [degC]
    salt: Optional[torch.Tensor]  # (nz, jy, ix) or None
    z_r: torch.Tensor       # level depths [m, negative down]
    z_w: torch.Tensor
    hz: torch.Tensor        # layer thicknesses [m]
    srflx: torch.Tensor     # (jy, ix) kinematic solar flux [degC m/s]
    swr_frac: torch.Tensor  # (nz+1, jy, ix) shortwave penetration fraction
    rmask: torch.Tensor
    dt: float
    time: torch.Tensor


class BGCModel(NamedTuple):
    """A BGC engine: names + pure functions.

    interior_tendency(bgc_tracers, ctx, saved, forc=None) ->
        (dtracer/dt (nbgc, nz, jy, ix), new_saved)
    surface_flux(bgc_tracers, ctx, forc=None) ->
        (nbgc, jy, ix) kinematic surface fluxes [conc * m/s]
    forc: optional dict of atmospheric BGC forcing fields (dust, iron,
    pco2_air, wspd, ... — reference: src/bgc_forces.F) on the padded grid.
    """
    name: str
    tracer_names: Sequence[str]
    interior_tendency: Callable
    surface_flux: Callable
    init_tracers: Callable        # (cfg, z_r, dtype, device) -> (nbgc, ...)
    init_saved: Callable = lambda cfg, shape, dtype: None
    # diagnose(bgc_tracers, ctx, forc=None) -> {name: rate field}, the
    # registered diagnostic set for a bgc_io-style writer (reference:
    # src/bgc_io.F; None = the model registers no diagnostics)
    diagnose: Optional[Callable] = None

    @property
    def ntracers(self) -> int:
        return len(self.tracer_names)


BGC_MODELS: Dict[str, Callable[[], BGCModel]] = {}


def register(name: str):
    def deco(builder):
        BGC_MODELS[name] = builder
        return builder
    return deco


def get_model(name: str) -> BGCModel:
    if name not in BGC_MODELS:
        # import the built-ins lazily so registration happens on demand
        from bench_h100.reference.bgc import bec, npzd  # noqa: F401
    if name not in BGC_MODELS:
        raise KeyError(f"unknown BGC model {name!r}; "
                       f"registered: {sorted(BGC_MODELS)}")
    return BGC_MODELS[name]()
