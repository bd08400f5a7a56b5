"""Shared helpers of tests/test_torch_*.py: carry configurations and
pytrees between the JAX package and the port."""

import dataclasses
from enum import Enum

import jax.numpy as jnp
import numpy as np
import torch

from roms_tpu.config import AdvScheme as JAdvScheme
from roms_tpu.config import ModelConfig as JModelConfig
from roms_tpu.ops.weights import set_weights as jset_weights
from roms_tpu.stepper import step as jstep

from roms_tpu_torch import bridge
from roms_tpu_torch.ops.weights import set_weights
from roms_tpu_torch.stepper import step as tstep

F64 = torch.float64


def port_cfg(jcfg):
    """The port's ModelConfig for a JAX package ModelConfig."""
    return bridge.config_from_dict(dataclasses.asdict(jcfg))


def jax_cfg(tcfg):
    """The JAX package's ModelConfig for a port ModelConfig."""
    return JModelConfig(**{k: JAdvScheme[v.name] if isinstance(v, Enum)
                           else v
                           for k, v in dataclasses.asdict(tcfg).items()})


def _np_dict(d):
    return {k: _np_dict(v) if isinstance(v, dict) else np.asarray(v)
            for k, v in d.items()}


def np_tree(x):
    """A JAX pytree dataclass as the dict of numpy arrays the bridge
    takes (a nested dataclass or dict becomes a nested dict)."""
    out = {}
    for f in dataclasses.fields(x):
        a = getattr(x, f.name)
        if a is None:
            out[f.name] = None
        elif dataclasses.is_dataclass(a):
            out[f.name] = np_tree(a)
        elif isinstance(a, dict):
            out[f.name] = _np_dict(a)
        else:
            out[f.name] = np.asarray(a)
    return out


def np_fields(x):
    """Fields of a pytree as numpy, absent ones left out."""
    return {k: v for k, v in np_tree(x).items() if v is not None}


def assert_fields_close(jax_tree, port_tree, tol):
    """Every field of a JAX pytree, nested dicts (forcing.bry) field by
    field, against the port's at rtol = atol = tol; both must hold the
    same fields."""
    jf, tf = np_fields(jax_tree), bridge.to_numpy(port_tree)
    assert set(jf) == {k for k, v in tf.items() if v is not None}
    for name, a in jf.items():
        pairs = a.items() if isinstance(a, dict) else [(None, a)]
        for sub, arr in pairs:
            if arr is None:
                continue
            b = tf[name] if sub is None else tf[name][sub]
            np.testing.assert_allclose(b, arr, rtol=tol, atol=tol,
                                       err_msg=f"{name} {sub or ''}")


def run_jax(cfg, grid, state, forcing, nsteps=3):
    """`nsteps` steps of the JAX package, the first a first step."""
    w1, w2, _ = jset_weights(cfg.ndtfast)
    for i in range(nsteps):
        state = jstep(state, forcing, grid, jnp.asarray(w1), jnp.asarray(w2),
                      cfg, first_step=(i == 0))
    return state


def run_port(cfg, grid, state, forcing, nsteps=3):
    """The same steps of the port in float64 on the CPU, from the JAX
    package's inputs; returns the state as a dict of numpy arrays."""
    tcfg = port_cfg(cfg)
    tg = bridge.grid_from_numpy(np_tree(grid), dtype=F64, device="cpu")
    tst = bridge.state_from_numpy(np_tree(state), dtype=F64, device="cpu")
    tfrc = bridge.forcing_from_numpy(np_tree(forcing), dtype=F64,
                                     device="cpu")
    w1, w2, _ = set_weights(cfg.ndtfast)
    for i in range(nsteps):
        tst = tstep(tst, tfrc, tg, w1, w2, tcfg, first_step=(i == 0))
    return bridge.to_numpy(tst)


def assert_tree_close(got, ref, tol, what=""):
    """An array, or dicts of them nested to any depth (the same keys on
    both sides), at atol tol * max(1, max|ref|) array by array."""
    if isinstance(ref, dict):
        assert set(got) == set(ref), what
        for k, a in ref.items():
            assert_tree_close(got[k], a, tol, f"{what} {k}")
        return
    scale = max(1.0, float(np.abs(ref).max()))
    np.testing.assert_allclose(got, ref, rtol=0, atol=tol * scale,
                               err_msg=what)


def assert_state_close(got, ref_state, tol, loose=None):
    """Every field of the reference state at atol tol * max(1, max|ref|),
    or at loose[name] instead of tol; the dict fields (upscale capture,
    budgets) term by term."""
    loose = loose or {}
    for name, a in np_fields(ref_state).items():
        assert_tree_close(got[name], a, loose.get(name, tol), name)


# global attributes that name the package or the commit that wrote a file
PACKAGE_ATTRS = ("type", "git_hash")


def assert_same_nc(port_path, jax_path, tol=None, skip_attrs=PACKAGE_ATTRS):
    """Two NetCDF files hold the same dimensions, global attributes (apart
    from `skip_attrs`), variables, variable dimensions and attributes, and
    data: bitwise, or within rtol = atol = tol * max(1, max|ref|) where
    `tol` is given (NaN where the reference has NaN)."""
    from roms_tpu_torch.io.netcdf import open_dataset
    with open_dataset(port_path) as a, open_dataset(jax_path) as b:
        assert a.dimensions == b.dimensions
        assert {k: v for k, v in a.attrs.items() if k not in skip_attrs} \
            == {k: v for k, v in b.attrs.items() if k not in skip_attrs}
        assert sorted(a.variables) == sorted(b.variables)
        for name in b.variables:
            va, vb = a[name], b[name]
            assert va.dims == vb.dims, name
            assert va.attrs == vb.attrs, name
            assert va.dtype == vb.dtype, name
            x, y = np.asarray(va[...]), np.asarray(vb[...])
            if tol is None:
                np.testing.assert_array_equal(x, y, err_msg=name)
            else:
                scale = max(1.0, float(np.nanmax(np.abs(y)))) \
                    if np.isfinite(y).any() else 1.0
                np.testing.assert_allclose(x, y, rtol=tol, atol=tol * scale,
                                           err_msg=name)
