"""The numbers that decide `correct`: how far the state that the timed
steps left lies from the plain reference's, one number per field.

- `zeta`, and every tracer of `t`: the largest pointwise gap over the
  whole padded array over the reference field's range (max - min); `t`
  reads its worst tracer, each over its own range, which puts T (a range
  of 14 degC about 10) and S (0.6 psu about 34.5) on one footing.
- `u`, `v`: the largest pointwise gap over the reference's largest
  speed of the 3D flow, max(|u|, |v|); `ubar`, `vbar` likewise over the
  largest barotropic speed.  A velocity component that starts at rest
  has a range set by its first steps, and its round-off would read large
  against it; against the flow's speed it reads what it costs.
- `akv`, `akt`, `hbls` (KPP's mixing coefficients and boundary layer
  depth): the root mean square of the gap over the reference's root mean
  square (`akt` its worst row), `akv` and `akt` over the W-points inside
  the reference's surface boundary layer (z_w >= -hbls).  They are
  ill-conditioned point by point (the Richardson number divides by the
  square of a vertical shear, convection switches on where N^2 < 0), so
  one point's flip between two branches would decide a largest gap; and
  below the boundary layer of the production configuration the deep
  water is so weakly stratified that float32's N^2 is round-off of
  either sign, which switches convective mixing (0.1 m^2/s) on at
  random deep points in every float32 run of the plain path as of the
  kernel's (a tenfold RMS against float64).

A value that is not finite reads infinity.
"""

from __future__ import annotations

import math

import torch

SPEEDS = {"u": ("u", "v"), "v": ("u", "v"), "ubar": ("ubar", "vbar"),
          "vbar": ("ubar", "vbar")}
RMS = ("akv", "akt", "hbls")
BOUNDARY_LAYER = ("akv", "akt")   # compared inside the surface layer
COMPONENTS = ("t", "akt")     # fields whose first axis is a component


def _f64(a, like):
    return a.to(device=like.device, dtype=torch.float64)


def _ratio(num: float, den: float) -> float:
    if den > 0.0:
        return num / den
    return 0.0 if num == 0.0 else math.inf


def _one(name: str, got, ref, speed: float, where=None) -> float:
    if not bool(torch.isfinite(got).all()):
        return math.inf
    diff = got - ref
    if name in RMS:
        if where is not None:
            diff, ref = diff[where], ref[where]
        return _ratio(float(diff.square().mean().sqrt()),
                      float(ref.square().mean().sqrt()))
    scale = speed if name in SPEEDS else float(ref.max() - ref.min())
    return _ratio(float(diff.abs().max()), scale)


def gap(name: str, got: torch.Tensor, ref_state) -> float:
    """The number `name` of a field `got` of the program's state against
    the reference state.  A field with components is read one component
    at a time, so no float64 array of all of them is made beside the
    reference's."""
    ref = getattr(ref_state, name)
    speed = 0.0
    if name in SPEEDS:
        speed = max(float(getattr(ref_state, f).abs().max())
                    for f in SPEEDS[name])
    where = None
    if name in BOUNDARY_LAYER:
        where = ref_state.z_w >= -ref_state.hbls
    if name in COMPONENTS:
        return max(_one(name, _f64(got[i], ref), ref[i].to(torch.float64),
                        speed, where)
                   for i in range(ref.shape[0]))
    ref = ref.to(torch.float64)
    return _one(name, _f64(got, ref), ref, speed, where)


def judge(outputs: dict, ref_state, limits: dict) -> tuple[bool, dict]:
    """(correct, {name: (reading, limit)}) of the program's `outputs`
    against the reference state, one number per limit."""
    readings = {name: (gap(name, outputs[name], ref_state), float(limit))
                for name, limit in limits.items()}
    ok = all(v <= lim for v, lim in readings.values())
    return ok, readings
