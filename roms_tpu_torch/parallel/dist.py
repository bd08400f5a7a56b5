"""Distributed stepping over a 2D rank mesh (port of
roms_tpu/parallel/dist.py; reference: src/mpi_setup.F NP_XI x NP_ETA rank
grid, src/mpi_exchanges.F halo messages).

One process per rank, as the reference's MPI ranks are.  The JAX package
runs one SPMD program under `shard_map`; here every rank runs the port's
own `step_impl` on its block with `HaloExchange` as the halo refresh, and
`torch.distributed` carries the messages: NCCL where each rank has its
own GPU, gloo across CPU processes (the tests) or across processes that
share one card.  gloo takes host tensors only, so on a card every
message is staged through pinned host memory; that staging lives here
alone (`Mesh`), chosen by the backend the caller named.  No backend is
ever swapped for another.

Each rank holds its block in **block-halo layout**: its interior block of
the padded global array plus its own 2-deep ghost ring, like an MPI
rank's local array (reference: src/set_global_definitions.h:136-153).
Physical-edge ghost strips are kept on non-periodic axes, and the
boundary conditions apply only on blocks owning a physical edge through
the grid's `own_w/e/s/n` flags: Python bools fixed per rank at setup, as
are the block offsets `j0/i0` (reference: src/mpi_setup.F:115-155).
Grids that the mesh does not divide are padded with inert land beyond the
east/north ghost ring (`pad_for_mesh`).

Setup: `init_distributed` (torchrun's environment, or a store the caller
passes) returns the rank's `Mesh`; `launch` spawns ranks on one host and
returns what each rank's function returns.  `to_block` cuts a rank's
block out of a padded-global tree, `from_blocks` gathers every rank's
block back into a padded-global numpy tree.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import socket
import tempfile
import time
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from roms_tpu_torch.config import ModelConfig

# every process group's timeout: a rank left waiting in a collective
# fails instead of hanging
TIMEOUT = datetime.timedelta(seconds=600)
BACKENDS = ("nccl", "gloo")
NO_CARD = ("no CUDA device: the ranks run on the card unless the caller "
           "asks for the CPU (device='cpu')")


# ---------------------------------------------------------------------------
# Mesh layout
# ---------------------------------------------------------------------------

def mesh_shape(n: int) -> tuple[int, int]:
    """Factor a rank count into (py, px) as `make_mesh` does:
    py = floor(sqrt(n)), lowered until it divides n."""
    py = int(np.floor(np.sqrt(n)))
    while n % py:
        py -= 1
    return py, n // py


def rank_grid(n: int, nnodes: int = 1, dcn_axis: str = "y") -> np.ndarray:
    """The (py, px) grid of ranks.  On one node: `mesh_shape(n)`, ranks
    row-major.  On several (ranks numbered node by node, as torchrun
    does): the nodes stacked along `dcn_axis`, each node's ranks
    contiguous along the other axis, so only the block boundaries between
    nodes cross the slower link (the rule of `_multihost_mesh`)."""
    if nnodes == 1:
        return np.arange(n).reshape(mesh_shape(n))
    if n % nnodes:
        raise ValueError(f"{n} ranks do not split evenly over {nnodes} "
                         "nodes")
    if dcn_axis not in ("y", "x"):
        raise ValueError(f"dcn_axis must be 'y' or 'x', got {dcn_axis!r}")
    g = np.arange(n).reshape(nnodes, n // nnodes)
    return g if dcn_axis == "y" else g.T.copy()


@dataclass
class Mesh:
    """One rank's view of the (py, px) mesh: the rank grid, this rank and
    its device, and the process groups (`backend` None: a layout without
    a process group, enough for `to_block` and `pad_for_mesh`).  Row and
    column groups (ranks sharing iy, and sharing ix) carry the upscale
    strips' sums."""
    ranks: np.ndarray
    rank: int = 0
    device: torch.device = torch.device("cpu")
    backend: Optional[str] = None
    row_group: object = None
    col_group: object = None

    @property
    def shape(self) -> tuple[int, int]:
        return tuple(self.ranks.shape)

    @property
    def size(self) -> int:
        return int(self.ranks.size)

    @property
    def iy(self) -> int:
        return int(np.argwhere(self.ranks == self.rank)[0, 0])

    @property
    def ix(self) -> int:
        return int(np.argwhere(self.ranks == self.rank)[0, 1])

    def close(self):
        if self.backend is not None:
            dist.destroy_process_group()
            self.backend = None

    # -- the staging of messages, in one place ------------------------------
    def _send_buffer(self, t: torch.Tensor) -> torch.Tensor:
        """A contiguous tensor the backend can send: for gloo on a card, a
        pinned host copy."""
        if self.backend == "gloo" and t.is_cuda:
            buf = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            buf.copy_(t)
            return buf
        return t.contiguous()

    def _recv_buffer(self, like: torch.Tensor) -> torch.Tensor:
        if self.backend == "gloo" and like.is_cuda:
            return torch.empty(like.shape, dtype=like.dtype, pin_memory=True)
        return torch.empty(like.shape, dtype=like.dtype, device=like.device)

    @staticmethod
    def _back(buf: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
        if buf.device == like.device:
            return buf
        out = torch.empty(like.shape, dtype=like.dtype, device=like.device)
        out.copy_(buf)
        return out

    def p2p(self, sends, recvs):
        """Post the sends [(tensor, peer rank, tag)] and the receives
        [(tensor shaped like the message, peer rank, tag)] as one batch, in
        the order given (NCCL matches messages to one peer by that order,
        gloo by tag); returns the received tensors on the devices of the
        `like` tensors."""
        ops, bufs = [], []
        for t, peer, tag in sends:
            ops.append(dist.P2POp(dist.isend, self._send_buffer(t), int(peer),
                                  tag=tag))
        for like, peer, tag in recvs:
            b = self._recv_buffer(like)
            bufs.append((b, like))
            ops.append(dist.P2POp(dist.irecv, b, int(peer), tag=tag))
        for w in dist.batch_isend_irecv(ops):
            w.wait()
        return [self._back(b, like) for b, like in bufs]

    def all_gather(self, t: torch.Tensor) -> list:
        """Every rank's `t` (equal shapes), in rank order, on t's device."""
        if self.size == 1:
            return [t]
        s = self._send_buffer(t)
        outs = [torch.empty_like(s, device=s.device) for _ in
                range(self.size)]
        dist.all_gather(outs, s)
        return [self._back(o, t) for o in outs]

    def all_reduce(self, t: torch.Tensor, axis: Optional[str] = None):
        """Sum of `t` over the world, or over this rank's row (`axis`
        "x": the ranks along x) or column ("y"); a new tensor."""
        group = {None: None, "x": self.row_group, "y": self.col_group}[axis]
        n = {None: self.size, "x": self.shape[1], "y": self.shape[0]}[axis]
        if n == 1:
            return t
        s = self._send_buffer(t)
        if s is t:
            s = t.clone()
        dist.all_reduce(s, group=group)
        return self._back(s, t)


def _rank_device(device, local_rank: int) -> torch.device:
    """The rank's device: the card of this rank's local index by default
    (None or 'cuda'), a card by index (every rank on that one card), or
    'cpu' when the caller asks for it."""
    d = torch.device("cuda" if device is None else device)
    if d.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(NO_CARD)
        if d.index is None:
            d = torch.device("cuda", local_rank)
        if d.index >= torch.cuda.device_count():
            raise ValueError(f"{d} does not exist "
                             f"({torch.cuda.device_count()} cards)")
    return d


def init_distributed(backend: str, init_method=None, *, rank=None,
                     world_size=None, device=None, nnodes=None,
                     dcn_axis: str = "y", timeout=TIMEOUT) -> Mesh:
    """Join the process group and return this rank's Mesh (the role of
    `init_multihost`; reference: src/main.F:26 MPI_Init + mpi_setup.F).

    backend: 'nccl' (one card a rank) or 'gloo' (CPU tensors, or cards
    shared by several ranks, the messages staged through the host); the
    caller always names it.  device: the rank's card by default
    (cuda:LOCAL_RANK), a card by index, or 'cpu' when asked.
    init_method: a `torch.distributed.Store` (the tests pass a
    FileStore), a 'file://' or 'tcp://' URL, or None for torchrun's
    environment (RANK, WORLD_SIZE, LOCAL_RANK, LOCAL_WORLD_SIZE,
    MASTER_ADDR, MASTER_PORT).  Several nodes (world
    size over LOCAL_WORLD_SIZE, or `nnodes`) take the multi-node layout
    of `rank_grid`."""
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got "
                         f"{backend!r}")
    env = os.environ
    if rank is None:
        rank, world_size = int(env["RANK"]), int(env["WORLD_SIZE"])
    local_rank = int(env.get("LOCAL_RANK", rank))
    if nnodes is None:
        nnodes = world_size // int(env.get("LOCAL_WORLD_SIZE", world_size))
    dev = _rank_device(device, local_rank)
    if backend == "nccl" and dev.type != "cuda":
        raise ValueError(f"NCCL needs a CUDA device, got {dev}")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    store = _store(init_method, rank, world_size, timeout)
    if backend == "nccl":
        _refuse_shared_cards(store, rank, world_size, dev)
    dist.init_process_group(backend, store=store, rank=rank,
                            world_size=world_size, timeout=timeout)
    grid = rank_grid(world_size, nnodes, dcn_axis)
    mesh = Mesh(ranks=grid, rank=rank, device=dev, backend=backend)
    # every rank creates every group, in one order
    for iy in range(grid.shape[0]):
        g = dist.new_group(grid[iy].tolist(), timeout=timeout)
        if rank in grid[iy]:
            mesh.row_group = g
    for ix in range(grid.shape[1]):
        g = dist.new_group(grid[:, ix].tolist(), timeout=timeout)
        if rank in grid[:, ix]:
            mesh.col_group = g
    return mesh


def _store(init_method, rank: int, world_size: int, timeout):
    """The rendezvous store: the caller's, or torch's rendezvous of a
    'file://', 'tcp://' or 'env://' URL (None: env://)."""
    if isinstance(init_method, dist.Store):
        return init_method
    store, _, _ = next(dist.rendezvous(init_method or "env://", rank=rank,
                                       world_size=world_size,
                                       timeout=timeout))
    return store


def _refuse_shared_cards(store, rank: int, world_size: int,
                         dev: torch.device):
    """NCCL refuses two ranks of one communicator on one GPU ("Duplicate
    GPU detected", ncclInvalidUsage): find that before NCCL does, through
    the store, and say so on every rank."""
    me = f"{socket.gethostname()}:{dev}"
    store.set(f"roms_rank_device/{rank}", me)
    seen = {}
    for r in range(world_size):
        where = store.get(f"roms_rank_device/{r}").decode()
        if where in seen:
            raise ValueError(
                f"NCCL refuses two ranks of one communicator on the same "
                f"GPU: ranks {seen[where]} and {r} both on {where}; give "
                f"each rank its own card, or use backend='gloo' to share "
                f"one")
        seen[where] = r


# ---------------------------------------------------------------------------
# Ranks on one host
# ---------------------------------------------------------------------------

def launch(fn, nprocs: int, backend: str, device="cuda", args=(),
           timeout: float = 600.0, store_dir: Optional[str] = None):
    """Run `fn(mesh, *args)` on `nprocs` ranks spawned on this host (never
    forked: the caller may hold a CUDA context) and return each rank's
    value, in rank order.  `fn` must be importable by name; what it
    returns comes back through a pipe, its tensors as numpy arrays.
    device: 'cuda' (rank r on card r), a card by index (every rank on
    it), or 'cpu' when asked.

    The ranks meet through a FileStore in `store_dir` (a temporary
    directory by default).  A rank's exception reaches the caller
    (`torch.multiprocessing.ProcessRaisedException`) and stops the other
    ranks; a run past `timeout` seconds is killed and raises
    TimeoutError.  Build the CUDA kernels before launching ranks on a
    card (`ops._build.build()`), so that they do not compile side by
    side."""
    import torch.multiprocessing as tmp

    d = torch.device(device)
    if backend == "nccl":
        if d.type != "cuda":
            raise ValueError(f"NCCL needs CUDA devices, got {device}")
        if d.index is not None and nprocs > 1:
            raise ValueError(
                f"NCCL needs one card a rank: {nprocs} ranks on {device}; "
                "NCCL refuses two ranks of one communicator on the same "
                "GPU, so use backend='gloo' to share one card")
    if d.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(NO_CARD)
        if d.index is None and nprocs > torch.cuda.device_count():
            raise ValueError(
                f"'cuda' puts rank r on card r: {nprocs} ranks, "
                f"{torch.cuda.device_count()} cards (name one card, e.g. "
                "'cuda:0', to share it over gloo)")
    ctx = tmp.get_context("spawn")
    q = ctx.SimpleQueue()
    with tempfile.TemporaryDirectory(prefix="roms_ranks_",
                                     dir=store_dir) as d:
        pc = tmp.start_processes(
            _rank_main, args=(nprocs, backend, str(device),
                              os.path.join(d, "store"), fn, args, q),
            nprocs=nprocs, join=False, start_method="spawn")
        out = {}
        deadline = time.monotonic() + timeout
        try:
            while True:
                # drain before joining: a rank blocks on a full pipe
                while not q.empty():
                    r, v = q.get()
                    out[r] = v
                if pc.join(timeout=0.05):
                    break
                if time.monotonic() > deadline:
                    raise TimeoutError(f"launch: {nprocs} {backend} ranks "
                                       f"still running after {timeout} s")
        finally:
            for p in pc.processes:
                if p.is_alive():
                    p.kill()
                p.join()
        while not q.empty():
            r, v = q.get()
            out[r] = v
    missing = sorted(set(range(nprocs)) - set(out))
    if missing:
        raise RuntimeError(f"launch: ranks {missing} returned nothing")
    return [out[r] for r in range(nprocs)]


def _rank_main(rank, nprocs, backend, device, store_path, fn, args, q):
    if torch.device(device).type == "cpu":
        torch.set_num_threads(1)
    mesh = init_distributed(backend, dist.FileStore(store_path, nprocs),
                            rank=rank, world_size=nprocs, device=device,
                            nnodes=1)
    value = _map(lambda _, a: host(a), fn(mesh, *args))
    q.put((rank, value))
    mesh.close()


# ---------------------------------------------------------------------------
# Trees of tensors (the port's dataclasses and dicts), leaves by name
# ---------------------------------------------------------------------------

def _map(fn, tree, *rest, name: str = ""):
    """fn(name, leaf, *leaves of `rest` at the same place) over every
    array leaf of a tree of dataclasses, dicts, lists and tuples; None
    and other values pass through.  A leaf's name is its field name or
    dict key."""
    if tree is None:
        return None
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{
            f.name: _map(fn, getattr(tree, f.name),
                         *(getattr(r, f.name) for r in rest), name=f.name)
            for f in dataclasses.fields(tree)})
    if isinstance(tree, dict):
        return {k: _map(fn, v, *(r[k] for r in rest), name=str(k))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        items = [_map(fn, v, *(r[i] for r in rest), name=name)
                 for i, v in enumerate(tree)]
        return type(tree)(*items) if hasattr(tree, "_fields") \
            else type(tree)(items)
    if isinstance(tree, (torch.Tensor, np.ndarray)):
        return fn(name, tree, *rest)
    return tree


def host(a):
    """A tensor as a numpy array (anything else as it is)."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return a


# non-spatial array fields of Grid / Forcing / CdrForcing / OceanState
_REPLICATED = {
    "cs_w", "cs_r", "area", "volume", "iic", "time",
    "riv_vol", "riv_trc", "pipe_prf", "pipe_trc",
    "iloc", "jloc", "icdr", "prf", "flx",
    "own_w", "own_e", "own_s", "own_n", "j0", "i0",
}


def _leaf_kind(name: str, leaf) -> str:
    """'spatial' | 'edge_y' | 'edge_x' | 'replicated' for one leaf, by its
    name (shapes are ambiguous: riv_trc is (nriv, nt), the boundary
    fields (nz, edge)).  '_west' suffix for state and boundary leaves,
    exact bare names for the upscale strips."""
    if name in _REPLICATED:
        return "replicated"
    if name.endswith("_west") or name.endswith("_east") or name in (
            "west", "east"):
        return "edge_y"
    if name.endswith("_south") or name.endswith("_north") or name in (
            "south", "north"):
        return "edge_x"
    if leaf.ndim >= 2:
        return "spatial"
    return "replicated"


# ---------------------------------------------------------------------------
# Mesh-divisibility padding (the reverse of the reference's edge-rank
# remainder absorption, reference: src/mpi_setup.F:115-155)
# ---------------------------------------------------------------------------

# spatial leaves padded with ZEROS (masks gate physics; point-source face
# and index fields must not copy sources into the pad)
_PAD_ZERO = {"rmask", "umask", "vmask", "pmask", "riv_uflx", "riv_vflx",
             "pipe_idx"}


def pad_for_mesh(cfg: ModelConfig, mesh: Mesh) -> ModelConfig:
    """Padded config for this mesh (the same config when it divides):
    inert cells appended beyond the east/north ghost ring so every block
    is equal, masks zero there, the kernels' east/north edge indices
    shifted by pad_e / pad_n."""
    py, px = mesh.shape
    pn = (-cfg.ny) % py
    pe = (-cfg.nx) % px
    if pe == 0 and pn == 0:
        return cfg
    if not cfg.masking:
        raise ValueError(
            "non-mesh-divisible grids require cfg.masking=True (padded "
            "cells are carried as inert land)")
    return cfg.replace(nx=cfg.nx + pe, ny=cfg.ny + pn, pad_e=pe, pad_n=pn)


def _pad_last(a: torch.Tensor, n: int, dim: int, zero: bool):
    if n == 0:
        return a
    edge = a.narrow(dim, a.shape[dim] - 1, 1)
    shape = list(a.shape)
    shape[dim] = n
    tail = torch.zeros(shape, dtype=a.dtype, device=a.device) if zero \
        else edge.expand(shape)
    return torch.cat([a, tail], dim=dim)


def _pad_leaf(a: torch.Tensor, kind: str, name: str, pe: int, pn: int):
    """Append the inert pad to one padded-global leaf: zeros for the
    `_PAD_ZERO` fields, the last line repeated for the others."""
    zero = name in _PAD_ZERO
    if kind == "spatial":
        return _pad_last(_pad_last(a, pn, a.ndim - 2, zero), pe, a.ndim - 1,
                         zero)
    if kind == "edge_y":
        return _pad_last(a, pn, a.ndim - 1, zero)
    if kind == "edge_x":
        return _pad_last(a, pe, a.ndim - 1, zero)
    return a


def _crop_leaf(a: np.ndarray, kind: str, pe: int, pn: int):
    if kind == "spatial":
        return a[..., :a.shape[-2] - pn or None, :a.shape[-1] - pe or None]
    if kind == "edge_y":
        return a[..., :a.shape[-1] - pn or None]
    if kind == "edge_x":
        return a[..., :a.shape[-1] - pe or None]
    return a


# ---------------------------------------------------------------------------
# Block-halo layout (the analog of the reference's partit / ncjoin)
# ---------------------------------------------------------------------------

def _block(a: torch.Tensor, n_blocks: int, b: int, h: int, dim: int):
    """Block b of n along one padded axis (interior + 2h): its interior
    share plus the h-deep ring on both sides."""
    m = (a.shape[dim] - 2 * h) // n_blocks
    return a.narrow(dim, b * m, m + 2 * h)


def to_block(tree, mesh: Mesh, h: int, pads: tuple = (0, 0)):
    """This rank's block-halo block of a padded-global tree (tensors or
    numpy arrays), copied onto the rank's device; pads = (pad_n, pad_e)
    appends the mesh-divisibility pad first (`pad_for_mesh`).  Replicated
    leaves are copied whole.  A tensor on another kind of device than the
    rank's raises: a run is never moved between the card and the CPU."""
    py, px = mesh.shape
    iy, ix = mesh.iy, mesh.ix
    pn, pe = pads

    def cut(name, a):
        if isinstance(a, torch.Tensor) and a.device.type != mesh.device.type:
            raise ValueError(f"{name} is on {a.device}, this rank runs on "
                             f"{mesh.device}")
        a = torch.as_tensor(a)
        kind = _leaf_kind(name, a)
        a = _pad_leaf(a, kind, name, pe, pn)
        if kind == "spatial":
            a = _block(_block(a, py, iy, h, a.ndim - 2), px, ix, h,
                       a.ndim - 1)
        elif kind == "edge_y":
            a = _block(a, py, iy, h, a.ndim - 1)
        elif kind == "edge_x":
            a = _block(a, px, ix, h, a.ndim - 1)
        return a.to(mesh.device, copy=True).contiguous()

    return _map(cut, tree)


def _unblock_axis(a, n_blocks: int, h: int, axis: int):
    """Reassemble one padded global axis from n overlapping blocks of
    (interior/n + 2h) concatenated along it: interiors from every block,
    the outer ghost strips from the two edge blocks."""
    a = np.asarray(a)
    mb = a.shape[axis] // n_blocks        # m + 2h
    m = mb - 2 * h
    sh = list(a.shape)
    sh[axis] = n_blocks * m + 2 * h
    out = np.zeros(sh, a.dtype)

    def sl(arr, start, stop):
        s = [slice(None)] * arr.ndim
        s[axis] = slice(start, stop)
        return tuple(s)

    for b in range(n_blocks):
        src = a[sl(a, b * mb, (b + 1) * mb)]
        lo = 0 if b == 0 else h
        hi = mb if b == n_blocks - 1 else mb - h
        out[sl(out, b * m + lo, b * m + hi)] = src[sl(src, lo, hi)]
    return out


def _join_leaf(name: str, blocks, ranks: np.ndarray, h: int, pads):
    """One padded-global numpy leaf from every rank's block (rank order):
    the blocks laid side by side as on the mesh, then `_unblock_axis`
    along x and y, the pad cropped."""
    kind = _leaf_kind(name, blocks[0])
    if kind == "replicated":
        return blocks[0]
    py, px = ranks.shape
    if kind == "spatial":
        a = np.concatenate([np.concatenate([blocks[r] for r in row], axis=-1)
                            for row in ranks], axis=-2)
        a = _unblock_axis(_unblock_axis(a, px, h, a.ndim - 1), py, h,
                          a.ndim - 2)
    elif kind == "edge_y":
        a = _unblock_axis(np.concatenate([blocks[r] for r in ranks[:, 0]],
                                         axis=-1), py, h, blocks[0].ndim - 1)
    else:
        a = _unblock_axis(np.concatenate([blocks[r] for r in ranks[0]],
                                         axis=-1), px, h, blocks[0].ndim - 1)
    return _crop_leaf(a, kind, pads[1], pads[0])


def join_blocks(trees, ranks: np.ndarray, h: int, pads: tuple = (0, 0)):
    """The padded-global numpy tree from every rank's block tree (a list
    in rank order) on the rank grid `ranks`; crops the pad."""
    return _map(lambda name, *bs: _join_leaf(name, [host(b) for b in bs],
                                             ranks, h, pads), *trees)


def from_blocks(tree, mesh: Mesh, h: int, pads: tuple = (0, 0)):
    """Gather every rank's block of `tree` and rebuild the padded-global
    numpy tree on every rank (a collective: every rank calls it)."""
    def gather(name, a):
        if _leaf_kind(name, a) == "replicated":
            return [host(a)] * mesh.size
        return [host(b) for b in mesh.all_gather(a.contiguous())]

    return _map(lambda name, a: _join_leaf(name, gather(name, a),
                                           mesh.ranks, h, pads), tree)


# ---------------------------------------------------------------------------
# The distributed step
# ---------------------------------------------------------------------------

def _with_ownership(grid, cfg: ModelConfig, mesh: Mesh):
    """The block's grid with its physical-edge ownership (Python bools)
    and its offsets in the padded interior (reference:
    src/mpi_setup.F:115-155 edge-rank logic); cfg is the padded config."""
    py, px = mesh.shape
    iy, ix = mesh.iy, mesh.ix
    return grid.replace(own_w=ix == 0, own_e=ix == px - 1,
                        own_s=iy == 0, own_n=iy == py - 1,
                        j0=iy * (cfg.ny // py), i0=ix * (cfg.nx // px))


def _assemble_locals(out, grid, mesh: Mesh):
    """The upscale strips hold valid values only on blocks owning their
    edge: zero elsewhere, summed over the ranks of the normal axis, so
    every rank of a row (west/east) or column (south/north) holds the
    strip of its stretch of the edge, exactly (reference:
    upscale_output.F records on boundary ranks only).  The budgets stay
    spatial blocks."""
    if out.upscale is None:
        return out
    up = {}
    for e, own, axis in (("west", grid.own_w, "x"), ("east", grid.own_e, "x"),
                         ("south", grid.own_s, "y"),
                         ("north", grid.own_n, "y")):
        if e in out.upscale:
            s = out.upscale[e]
            up[e] = mesh.all_reduce(s if own else torch.zeros_like(s), axis)
    return out.replace(upscale=up)


def make_distributed_step(cfg: ModelConfig, mesh: Mesh):
    """This rank's step: (state, forcing, grid, w1, w2, first_step) ->
    state, all in block-halo layout; `step_impl` on the block with
    `HaloExchange` as the halo refresh (its world sum adds the
    non-hydrostatic projection's dot products over the ranks), the block's
    grid given its edge ownership and offsets here (`_with_ownership`).
    cfg is the unpadded config."""
    from roms_tpu_torch.parallel.halo import HaloExchange
    from roms_tpu_torch.stepper import step_impl

    py, px = mesh.shape
    cfg = pad_for_mesh(cfg, mesh)
    if cfg.ny // py < 4 or cfg.nx // px < 4:
        raise ValueError("blocks must be at least 4 points wide")
    halo = HaloExchange(mesh, cfg.halo, cfg.ew_periodic, cfg.ns_periodic)

    def dstep(state, forcing, grid, w1, w2, first_step: bool):
        grid = _with_ownership(grid, cfg, mesh)
        out = step_impl(state, forcing, grid, w1, w2, cfg, first_step, halo)
        return _assemble_locals(out, grid, mesh)

    return dstep


# ---------------------------------------------------------------------------
# Dry run (the analog of __graft_entry__.py:dryrun_multichip)
# ---------------------------------------------------------------------------

def dryrun_multichip(n: int, device="cuda", backend: str = "nccl",
                     timeout: float = 900.0) -> None:
    """Step the production-shaped physics (cases/bench_production: split
    nonlinear EOS, KPP, salinity, passive tracers, a masked coastline,
    4-side open boundaries) twice in float32 on an n-rank mesh, 16x16
    interior points a block, nz=32, nt=8, and check every rank's state is
    finite.  With
    `device` 'cuda' and NCCL every rank takes its own card; with gloo and
    'cuda:0' the ranks share one; 'cpu' runs gloo ranks on the CPU."""
    if device != "cpu" and torch.device(device).type == "cuda":
        from roms_tpu_torch.ops import _build
        _build.build()
    finite = launch(_dryrun_rank, n, backend, device, args=(n,),
                    timeout=timeout)
    bad = [r for r, f in enumerate(finite) if not f]
    if bad:
        raise AssertionError(f"dryrun_multichip({n}): non-finite zeta on "
                             f"ranks {bad}")


def _dryrun_rank(mesh: Mesh, n: int) -> bool:
    from roms_tpu_torch.cases import bench_production
    from roms_tpu_torch.ops.weights import set_weights

    # refuse a smaller mesh than asked: a dry run of fewer ranks checks
    # nothing of what it is meant to
    if mesh.size != n:
        raise AssertionError(f"dryrun_multichip({n}) got a {mesh.shape} "
                             "mesh")
    py, px = mesh.shape
    cfg = bench_production.config(nx=16 * px, ny=16 * py, nz=32, nt=8)
    # barotropic CFL: bench_production's DX=2500 m, HMAX=4000 m; the
    # case's ndtfast keeps sqrt(gH) dtfast / DX near 0.47 an axis
    if (9.81 * 4000.0) ** 0.5 * (cfg.dt / cfg.ndtfast) / 2500.0 > 0.7:
        raise AssertionError("dryrun config violates the barotropic CFL "
                             "bound")
    grid, state, forcing = bench_production.setup(cfg, dtype=torch.float32,
                                                  device=mesh.device)
    w1, w2, _ = set_weights(cfg.ndtfast)
    h = cfg.halo
    st = to_block(state, mesh, h)
    frc = to_block(forcing, mesh, h)
    gr = to_block(grid, mesh, h)
    step = make_distributed_step(cfg, mesh)
    st = step(st, frc, gr, w1, w2, first_step=True)
    st = step(st, frc, gr, w1, w2, first_step=False)
    return bool(torch.isfinite(st.zeta).all())
