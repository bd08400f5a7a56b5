"""Halo (ghost-cell) management (port of roms_tpu/parallel/halo.py).

`shift` is a roll on the halo-padded array, exactly as in the JAX
package, so ghost-line values agree too.  Every fill returns a new tensor
(clone, then slice writes): a tensor passed in may still be held by the
previous state, and writing into it would corrupt `u_prev`/`t_prev`.

Two halo refreshes: the single-block fills (`periodic_fill`,
`mixed_fill`) and `HaloExchange` over a rank mesh, which exchanges the
ghost strips with the four edge neighbours in two sweeps (x first, then y
including the fresh x ghosts, so the corners come out right without the
reference's diagonal messages; reference: src/mpi_exchanges.F:672-800).
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


# message tags of one sweep: the strip bound for the high (east/north)
# neighbour, and the one bound for the low (west/south) neighbour
_TAG_HI, _TAG_LO = 0, 1


def _axis_slice(dim: int, start, stop):
    return ((Ellipsis, slice(None), slice(start, stop)) if dim == -1 else
            (Ellipsis, slice(start, stop), slice(None)))


class HaloExchange:
    """Ghost refresh of a block in block-halo layout over a rank mesh
    (`parallel.dist.Mesh`).

    Each sweep posts one batch of the two strips, the one bound east (or
    north) first, then the one bound west (or south), and their receives
    in the matching order: on a periodic axis 2 ranks wide both
    neighbours are one rank, NCCL matches messages to one peer by the
    order they were posted and gloo by tag.  On a closed axis the blocks
    at a physical edge send no wrap message: they keep the ring line
    h-1 / -h that the boundary conditions maintain and replicate it
    outward, as `mixed_fill` does (reference: src/mpi_exchanges.F
    west_msg_exch guards).  An axis of one block exchanges nothing: it
    wraps or ring-fills in the array, so a 1x1 mesh is `periodic_fill` /
    `mixed_fill` exactly.  `world_sum` adds a tensor over the ranks: a
    step that holds a HaloExchange runs on a mesh."""

    def __init__(self, mesh, h: int = 2, ew_periodic: bool = True,
                 ns_periodic: bool = True):
        self.mesh = mesh
        self.h = h
        self.ew_periodic = ew_periodic
        self.ns_periodic = ns_periodic

    def world_sum(self, t: torch.Tensor) -> torch.Tensor:
        """The sum of a small tensor over every rank of the mesh (the dot
        products of the non-hydrostatic projection's PCG)."""
        return self.mesh.all_reduce(t)

    def __call__(self, a: torch.Tensor) -> torch.Tensor:
        py, px = self.mesh.shape
        ranks = self.mesh.ranks
        iy, ix = self.mesh.iy, self.mesh.ix
        out = a.clone()
        self._sweep(out, -1, px, ix, ranks[iy, (ix - 1) % px],
                    ranks[iy, (ix + 1) % px], self.ew_periodic)
        self._sweep(out, -2, py, iy, ranks[(iy - 1) % py, ix],
                    ranks[(iy + 1) % py, ix], self.ns_periodic)
        return out

    def _sweep(self, out, dim, n, i, lo, hi, periodic):
        h = self.h

        def sl(start, stop):
            return _axis_slice(dim, start, stop)

        recv_lo = periodic or i > 0          # a neighbour on the low side
        recv_hi = periodic or i < n - 1
        if n == 1:
            got_lo = out[sl(-2 * h, -h)] if periodic else None
            got_hi = out[sl(h, 2 * h)] if periodic else None
        else:
            sends, recvs = [], []
            if recv_hi:
                sends.append((out[sl(-2 * h, -h)], hi, _TAG_HI))
            if recv_lo:
                sends.append((out[sl(h, 2 * h)], lo, _TAG_LO))
            if recv_lo:
                recvs.append((out[sl(0, h)], lo, _TAG_HI))
            if recv_hi:
                recvs.append((out[sl(-h, None)], hi, _TAG_LO))
            got = iter(self.mesh.p2p(sends, recvs))
            got_lo = next(got) if recv_lo else None
            got_hi = next(got) if recv_hi else None
        # a physical edge keeps its ring line and replicates it outward
        if got_lo is not None:
            out[sl(0, h)] = got_lo
        else:
            out[sl(0, h - 1)] = out[sl(h - 1, h)]
        if got_hi is not None:
            out[sl(-h, None)] = got_hi
        else:
            out[sl(-(h - 1), None)] = out[sl(-h, -h + 1)]


def halo_group(halo, *arrays):
    """One halo refresh for several fields sharing trailing (jy, ix):
    flatten the leading dims, concatenate, refresh once, split (the
    reference's exchange_xxx packing up to four arrays into one message
    round, src/mpi_exchanges.F:34-42); on a mesh, one message a
    direction instead of one per field."""
    if len(arrays) == 1:
        return (halo(arrays[0]),)
    jyix = tuple(arrays[0].shape[-2:])
    flats = [a.reshape((-1,) + jyix) for a in arrays]
    big = halo(torch.cat(flats, dim=0))
    out, o = [], 0
    for a, f in zip(arrays, flats):
        out.append(big[o:o + f.shape[0]].reshape(a.shape))
        o += f.shape[0]
    return tuple(out)


def make_halo_fill(cfg):
    """The single-block halo refresh for this configuration."""
    if cfg.fully_periodic:
        return partial(periodic_fill, h=cfg.halo)
    return partial(mixed_fill, h=cfg.halo,
                   ew_periodic=cfg.ew_periodic, ns_periodic=cfg.ns_periodic)
