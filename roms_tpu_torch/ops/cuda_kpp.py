"""The vertical-mixing update (interior mixing + KPP boundary layers):
the CUDA kernel and its plain PyTorch version (counterpart of
roms_tpu/ops/pallas_kpp.py).

`vmix_update` launches `csrc/kpp_vmix.cu` for a CUDA tensor and calls
`vmix_update_plain` for a CPU tensor; any other device raises.  Its
`launches` counts the calls that launch the kernel and `last_bytes` holds
the compulsory bytes of the last one.  The
plain version composes the port's `kpp.interior_mix` and `kpp.lmd_kpp`,
as tests/test_pallas_kpp.py composes the JAX ones.

The kernel computes every point of the padded grid, the outermost ghost
lines included, with the roll semantics of the plain version (periodic
neighbours by index arithmetic), so it is compared with the plain version
on the whole array.  The TPU kernel is checked only on the [1:-1]
interior (tests/test_pallas_kpp.py:_compare), and that is where the port
is compared with it.  The hbls/hbbl physical-edge fill stays a plain 2D
step here, after the launch, as in the TPU kernel's epilogue.
"""

from __future__ import annotations

import ctypes

import torch

from roms_tpu_torch.config import ModelConfig
from roms_tpu_torch.ops import _build, kpp
from roms_tpu_torch.ops.kpp import VmixOut


def vmix_update(state, u, v, t, bvf, z_r, z_w, hz, forcing, grid,
                cfg: ModelConfig, first_step: bool) -> VmixOut:
    """lmd_vmix + lmd_kpp at one time level (reference: main.F:408-410,
    :434-436).  Reads state.swrf, state.hbls, state.hbbl; forcing.stflx,
    srflx, sustr, svstr; grid.f, the masks and the ownership flags."""
    if u.device.type == "cpu":
        return vmix_update_plain(state, u, v, t, bvf, z_r, z_w, hz, forcing,
                                 grid, cfg, first_step)
    if u.device.type != "cuda":
        raise ValueError(f"vmix_update: no kernel for {u.device}")
    nz, jy, ix = u.shape
    if nz < 2 or jy < 6 or ix < 6:
        raise ValueError("vmix_update: nz >= 2 and jy, ix >= 6 required")
    if cfg.pad_e or cfg.pad_n:
        raise ValueError("vmix_update: mesh padding is not supported")
    nt = t.shape[0]
    n_akt = cfg.i_t_and_s
    shapes = {"u": (u, (nz, jy, ix)), "v": (v, (nz, jy, ix)),
              "t": (t, (nt, nz, jy, ix)), "bvf": (bvf, (nz + 1, jy, ix)),
              "z_r": (z_r, (nz, jy, ix)), "z_w": (z_w, (nz + 1, jy, ix)),
              "hz": (hz, (nz, jy, ix)), "swrf": (state.swrf, (nz + 1, jy, ix)),
              "stflx": (forcing.stflx, (nt, jy, ix))}
    for name, src in (("srflx", forcing), ("sustr", forcing),
                      ("svstr", forcing), ("f", grid), ("hbls", state),
                      ("hbbl", state)):
        shapes[name] = (getattr(src, name), (jy, ix))
    if cfg.masking:
        for name in ("rmask", "umask", "vmask"):
            shapes[name] = (getattr(grid, name), (jy, ix))
    _build.check_inputs(shapes, u)

    akv = torch.empty((nz + 1, jy, ix), dtype=u.dtype, device=u.device)
    akt = torch.empty((n_akt, nz + 1, jy, ix), dtype=u.dtype, device=u.device)
    ghat = torch.empty_like(akv)
    hbl2 = torch.empty((2, jy, ix), dtype=u.dtype, device=u.device)
    scratch = torch.empty((3 * nz + 2, jy, ix), dtype=u.dtype,
                          device=u.device)
    sal = cfg.salinity
    masks = ((grid.rmask, grid.umask, grid.vmask) if cfg.masking
             else (None, None, None))
    inputs = (u, v, bvf, z_r, z_w, hz, state.swrf, t[cfg.itemp, nz - 1],
              t[cfg.isalt, nz - 1] if sal else None,
              forcing.stflx[cfg.itemp],
              forcing.stflx[cfg.isalt] if sal else None,
              forcing.srflx, forcing.sustr, forcing.svstr, grid.f, *masks,
              state.hbls, state.hbbl)
    outputs = (akv, akt[0], akt[1] if sal else None, ghat, hbl2)
    ptrs = [_build.ptr(x) for x in (*inputs, *outputs, scratch)]
    ints = [nz, jy, ix, int(cfg.masking), int(sal), int(cfg.nonlin_eos),
            int(cfg.ew_periodic), int(cfg.ns_periodic),
            *[1 if f is None else int(bool(f))        # None: single block
              for f in (grid.own_w, grid.own_e, grid.own_s, grid.own_n)],
            int(first_step)]
    cg, vtc = kpp.surface_constants(cfg)
    dbls = [cfg.g, cfg.rho0, cfg.von_karman, cfg.zob, cfg.akv_bak,
            cfg.akt_bak, abs(cfg.tcoef), abs(cfg.scoef), cg, vtc]
    lib = _build.library()
    fn = (lib.roms_kpp_vmix_f64 if u.dtype == torch.float64
          else lib.roms_kpp_vmix_f32)
    err = fn((ctypes.c_void_p * len(ptrs))(*ptrs),
             (ctypes.c_int * len(ints))(*ints),
             (ctypes.c_double * len(dbls))(*dbls),
             torch.cuda.current_stream(u.device).cuda_stream)
    _build.check(err, "kpp_vmix")
    vmix_update.launches += 1
    vmix_update.last_bytes = _build.compulsory_bytes(inputs, outputs)

    # VmixOut contract: hbls/hbbl carry the filled ghost lines
    # (reference: lmd_kpp.F:545-581)
    hbls = kpp._fill_phys_edges_2d(hbl2[0], cfg, grid)
    hbbl = kpp._fill_phys_edges_2d(hbl2[1], cfg, grid)
    return VmixOut(akv=akv, akt=akt, hbls=hbls, hbbl=hbbl, ghat=ghat)


vmix_update.launches = 0
vmix_update.last_bytes = 0


def vmix_update_plain(state, u, v, t, bvf, z_r, z_w, hz, forcing, grid,
                      cfg: ModelConfig, first_step: bool) -> VmixOut:
    """Plain PyTorch version of `vmix_update` (same arguments)."""
    kv, kt, ks = kpp.interior_mix(u, v, bvf, z_r, z_w, grid, cfg)
    return kpp.lmd_kpp(u, v, t, bvf, z_r, z_w, hz, kv, kt, ks, state.swrf,
                       forcing, state.hbls, state.hbbl, grid, cfg,
                       first_step)
