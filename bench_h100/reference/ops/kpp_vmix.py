"""The vertical-mixing update (interior mixing + KPP boundary layers),
plain PyTorch (a frozen copy of `vmix_update_plain` from
roms_tpu_torch/ops/cuda_kpp.py; reference: main.F:408-410, :434-436)."""

from __future__ import annotations

from bench_h100.reference.config import ModelConfig
from bench_h100.reference.ops import kpp
from bench_h100.reference.ops.kpp import VmixOut


def vmix_update_plain(state, u, v, t, bvf, z_r, z_w, hz, forcing, grid,
                      cfg: ModelConfig, first_step: bool) -> VmixOut:
    """Plain PyTorch version of `vmix_update` (same arguments)."""
    kv, kt, ks = kpp.interior_mix(u, v, bvf, z_r, z_w, grid, cfg)
    return kpp.lmd_kpp(u, v, t, bvf, z_r, z_w, hz, kv, kt, ks, state.swrf,
                       forcing, state.hbls, state.hbbl, grid, cfg,
                       first_step)
