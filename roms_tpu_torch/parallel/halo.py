"""Halo (ghost-cell) management on one block (port of
roms_tpu/parallel/halo.py).

`shift` is a roll on the halo-padded array, exactly as in the JAX
package, so ghost-line values agree too.  Every fill returns a new tensor
(clone, then slice writes): a tensor passed in may still be held by the
previous state, and writing into it would corrupt `u_prev`/`t_prev`.
"""

from __future__ import annotations

from functools import partial

import torch


def shift(a: torch.Tensor, dj: int = 0, di: int = 0) -> torch.Tensor:
    """Return a tensor whose [.., j, i] element equals a[.., j+dj, i+di]
    (roll on the padded array; out-of-range entries wrap into ghosts)."""
    if dj == 0 and di == 0:
        return a
    return torch.roll(a, shifts=(-dj, -di), dims=(-2, -1))


def eset(a: torch.Tensor, idx, val, flag) -> torch.Tensor:
    """`a.at[idx].set(val)` gated by an edge-ownership flag; None or True
    means the block owns the edge, False leaves `a` unchanged, a bool
    tensor selects per call.  Returns a new tensor."""
    if flag is False:
        return a
    out = a.clone()
    if flag is None or flag is True:
        out[idx] = val
    else:
        out[idx] = torch.where(flag, val, a[idx])
    return out


def band(f1, f2):
    """AND of two optional ownership flags (None = owned)."""
    if f1 is None:
        return f2
    if f2 is None:
        return f1
    return f1 & f2


def periodic_fill(a: torch.Tensor, h: int = 2) -> torch.Tensor:
    """Refresh the ghosts of a doubly periodic single-block field: x sweep
    first, then y sweep including the x-ghost columns (corners right)."""
    out = a.clone()
    out[..., :, :h] = out[..., :, -2 * h:-h]
    out[..., :, -h:] = out[..., :, h:2 * h]
    out[..., :h, :] = out[..., -2 * h:-h, :]
    out[..., -h:, :] = out[..., h:2 * h, :]
    return out


def mixed_fill(a: torch.Tensor, h: int = 2, ew_periodic: bool = True,
               ns_periodic: bool = True) -> torch.Tensor:
    """Wrap the ghosts on periodic axes; on closed axes replicate the
    ring line (index h-1 / -h) outward into the deeper ghost lines."""
    out = a.clone()
    if ew_periodic:
        out[..., :, :h] = out[..., :, -2 * h:-h]
        out[..., :, -h:] = out[..., :, h:2 * h]
    else:
        out[..., :, :h - 1] = out[..., :, h - 1:h]
        out[..., :, -(h - 1):] = out[..., :, -h:-h + 1]
    if ns_periodic:
        out[..., :h, :] = out[..., -2 * h:-h, :]
        out[..., -h:, :] = out[..., h:2 * h, :]
    else:
        out[..., :h - 1, :] = out[..., h - 1:h, :]
        out[..., -(h - 1):, :] = out[..., -h:-h + 1, :]
    return out


def make_halo_fill(cfg):
    """The single-block halo refresh for this configuration."""
    if cfg.fully_periodic:
        return partial(periodic_fill, h=cfg.halo)
    return partial(mixed_fill, h=cfg.halo,
                   ew_periodic=cfg.ew_periodic, ns_periodic=cfg.ns_periodic)
