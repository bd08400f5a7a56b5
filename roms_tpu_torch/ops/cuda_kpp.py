"""The vertical-mixing update (interior mixing + KPP boundary layers):
the CUDA kernel and its plain PyTorch version (counterpart of
roms_tpu/ops/pallas_kpp.py).

`vmix_update` launches `csrc/kpp_vmix.cu` (two kernels) for a CUDA tensor
whose configuration `usable` admits (KPP without a mesh-divisibility pad,
as the JAX package gates its Pallas kernel) and calls `vmix_update_plain`
for a CPU tensor or a configuration `usable` refuses; any other device
raises (`_build.dispatch`).  The first kernel keeps the FC column of its
tile of columns in shared memory, which the launch sizes from nz, so nz
is capped at NZ_MAX, and a deeper column raises; `occupancy` reports both
kernels' launch configurations on the card.  The plain version composes
the port's `kpp.interior_mix` and `kpp.lmd_kpp`, as
tests/test_pallas_kpp.py composes the JAX ones.

The kernel computes every point of the padded grid, the outermost ghost
lines included, with the roll semantics of the plain version (periodic
neighbours by index arithmetic), so it is compared with the plain version
on the whole array.  The TPU kernel is checked only on the [1:-1]
interior (tests/test_pallas_kpp.py:_compare), and that is where the port
is compared with it.  The hbls/hbbl physical-edge fill is an index map in
the second kernel, which writes both outputs with their ghost lines
filled.
"""

from __future__ import annotations

import torch

from roms_tpu_torch.config import ModelConfig
from roms_tpu_torch.ops import _build, kpp
from roms_tpu_torch.ops.kpp import VmixOut

NZ_MAX = 160                 # deepest column the kernel takes


def launch_bytes(nz: int, jy: int, ix: int, elem: int, salinity: bool,
                 masking: bool) -> int:
    """Compulsory bytes of one call, each input read once and each output
    written once: u, v, z_r, hz (nz levels), bvf, z_w, swrf (nz + 1), the
    surface T (and S) and their fluxes, srflx, sustr, svstr, f, hbls,
    hbbl and the three masks; akv, Kt (and Ks), ghat (nz + 1) and the new
    hbls, hbbl."""
    s = int(salinity)
    planes = (4 * nz + 3 * (nz + 1) + 2 * (1 + s) + 6 + 3 * int(masking)
              + (3 + s) * (nz + 1) + 2)
    return planes * jy * ix * elem


def usable(cfg: ModelConfig) -> bool:
    """Whether the kernel covers this configuration's vmix update (as
    roms_tpu/ops/pallas_kpp.py:usable): KPP on a grid without the
    mesh-divisibility pad, whose shifted east/north edge fill the kernel
    does not index."""
    return cfg.lmd_kpp and cfg.pad_e == 0 and cfg.pad_n == 0


def vmix_update(state, u, v, t, bvf, z_r, z_w, hz, forcing, grid,
                cfg: ModelConfig, first_step: bool) -> VmixOut:
    """lmd_vmix + lmd_kpp at one time level (reference: main.F:408-410,
    :434-436).  Reads state.swrf, state.hbls, state.hbbl; forcing.stflx,
    srflx, sustr, svstr; grid.f, the masks and the ownership flags."""
    return _build.dispatch(
        "kpp_vmix", usable(cfg), vmix_update_plain, _launch, state, u, v, t,
        bvf, z_r, z_w, hz, forcing, grid, cfg, first_step, at=1)


def _launch(state, u, v, t, bvf, z_r, z_w, hz, forcing, grid,
            cfg: ModelConfig, first_step: bool) -> VmixOut:
    """The kernel's path of `vmix_update` (same arguments)."""
    nz, jy, ix = u.shape
    _build.check_nz("kpp_vmix", nz, NZ_MAX)
    if jy < 6 or ix < 6:
        raise ValueError("vmix_update: jy, ix >= 6 required")
    nt = t.shape[0]
    sal, masking = cfg.salinity, cfg.masking
    masks = (grid.rmask, grid.umask, grid.vmask) if masking else ()
    planes = (forcing.srflx, forcing.sustr, forcing.svstr, grid.f,
              state.hbls, state.hbbl, *masks)
    _build.check_groups(
        u, ((nz, jy, ix), "u v z_r hz", (u, v, z_r, hz)),
        ((nz + 1, jy, ix), "bvf z_w swrf", (bvf, z_w, state.swrf)),
        ((nt, nz, jy, ix), "t", (t,)), ((nt, jy, ix), "stflx",
                                        (forcing.stflx,)),
        ((jy, ix), "srflx sustr svstr f hbls hbbl rmask umask vmask",
         planes))

    dev, dtype = u.device, u.dtype
    akv = torch.empty((nz + 1, jy, ix), dtype=dtype, device=dev)
    akt = torch.empty((cfg.i_t_and_s, nz + 1, jy, ix), dtype=dtype,
                      device=dev)
    ghat = torch.empty((nz + 1, jy, ix), dtype=dtype, device=dev)
    hbls = torch.empty((jy, ix), dtype=dtype, device=dev)
    hbbl = torch.empty((jy, ix), dtype=dtype, device=dev)
    # the raw masked hbl/bbl that the first kernel hands the second
    hb = torch.empty((2, jy, ix), dtype=dtype, device=dev)
    cg, vtc = kpp.surface_constants(cfg)
    _build.launch(
        "kpp_vmix", u,
        [_build.ptr(x) for x in (u, v, bvf, z_r, z_w, hz, state.swrf, t,
                                 forcing.stflx, *planes[:4],
                                 *(masks or (None,) * 3), state.hbls,
                                 state.hbbl, akv, akt, ghat, hbls, hbbl,
                                 hb)],
        [nz, jy, ix, int(masking), int(sal), int(cfg.nonlin_eos),
         int(cfg.ew_periodic), int(cfg.ns_periodic),
         *map(_build.owned, (grid.own_w, grid.own_e, grid.own_s,
                             grid.own_n)),
         int(first_step), cfg.itemp, cfg.isalt if sal else 0],
        [cfg.g, cfg.rho0, cfg.von_karman, cfg.zob, cfg.akv_bak, cfg.akt_bak,
         abs(cfg.tcoef), abs(cfg.scoef), cg, vtc])

    # VmixOut contract: hbls/hbbl carry the filled ghost lines
    # (reference: lmd_kpp.F:545-581), written so by the kernel
    return VmixOut(akv=akv, akt=akt, hbls=hbls, hbbl=hbbl, ghat=ghat)


def occupancy(dtype: torch.dtype, nz: int) -> dict:
    """Both kernels' launch configurations for (dtype, nz) on the current
    card, as the library reports them: {"column": ..., "profile": ...},
    each with threads and shared memory per block, resident blocks and
    warps per SM (`cudaOccupancyMaxActiveBlocksPerMultiprocessor`),
    registers and stack bytes per thread."""
    _build.check_nz("kpp_vmix", nz, NZ_MAX)
    column, profile = _build.occupancy(
        "kpp_vmix", [int(dtype == torch.float64), nz], launches=2)
    return {"column": column, "profile": profile}


def vmix_update_plain(state, u, v, t, bvf, z_r, z_w, hz, forcing, grid,
                      cfg: ModelConfig, first_step: bool) -> VmixOut:
    """Plain PyTorch version of `vmix_update` (same arguments)."""
    kv, kt, ks = kpp.interior_mix(u, v, bvf, z_r, z_w, grid, cfg)
    return kpp.lmd_kpp(u, v, t, bvf, z_r, z_w, hz, kv, kt, ks, state.swrf,
                       forcing, state.hbls, state.hbbl, grid, cfg,
                       first_step)
