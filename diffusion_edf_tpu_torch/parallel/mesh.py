"""Named axes over the ranks of the process group, blocks of a leading axis
and the collectives the sharded paths use (counterpart of the JAX
package's ``parallel/mesh.py``).

A :class:`Mesh` lays the ranks of the initialised process group out on
named axes, e.g. ``("data", "model")``, and holds one process group for
every set of its axes (a rank's group along ``"model"`` holds the ranks
that share its ``"data"`` coordinate).  It keeps process groups and not a
``torch.distributed.device_mesh.DeviceMesh``: the sharded paths need only
the groups, including one over several axes at once, and nothing here
picks a device.  "Replicated" means every rank holds the same tensor;
"sharded over ``data``" means each rank holds a contiguous block of a
tensor's axis, the axis padded to a multiple of the axis size by repeating
its last entry (:func:`pad_to_multiple`, as ``pad_seeds_to_multiple``
pads).  Without an initialised process group, :func:`make_mesh` gives the
one-rank mesh, on which every collective is the identity.

Models built with an axis name (``scene_axis_name``, ``query_shard_axes``)
resolve it in the mesh of the innermost ``with use_mesh(mesh):``, as the
JAX modules resolve theirs in the active ``Mesh``.  Inside ``with
pose_block(...):`` a model scores one block of a batch of poses, and every
dropout over its per-pose rows draws the mask of the whole batch and keeps
the block's rows (``nn/layers.py::keep_mask``), so a data-parallel step
draws one process's masks.

The collectives are autograd functions with the backward that a
replicated loss needs: :func:`reduce_from_shards` sums per-shard partial
results (backward: the identity, since every rank holds the same
downstream gradient), :func:`copy_to_shards` marks a replicated tensor
that enters per-shard work (backward: the sum of the per-shard gradients),
:func:`gather_blocks` gathers blocks (backward: this rank's block of the
gradient).  ``torch.distributed.nn.functional.all_reduce`` sums the
gradient again in its backward, which counts a replicated loss once per
rank.  None of them reads a device value on the host, so each can run
inside a CUDA graph (``graphs.Program``) over NCCL groups
(:meth:`Mesh.capturable`); a gloo group carries CUDA tensors through the
host and cannot.
"""
from __future__ import annotations

import contextlib
import itertools
from typing import Dict, Iterator, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist

__all__ = [
    "Mesh", "make_mesh", "use_mesh", "current_mesh", "pad_to_multiple", "shard_batch",
    "gather_batch", "replicate", "reduce_from_shards", "copy_to_shards", "gather_blocks", "all_reduce_max",
    "all_reduce_sum", "require_capturable", "pose_block", "current_pose_block",
]

Axes = Union[str, Sequence[str]]


class Mesh:
    """The ranks ``0 .. size - 1`` of the process group in a C-ordered array
    of ``shape`` with named axes; ``shape[name]`` is an axis' size."""

    def __init__(self, shape: Tuple[int, ...], axis_names: Tuple[str, ...]):
        assert len(shape) == len(axis_names), (shape, axis_names)
        self.axis_names = tuple(axis_names)
        self.shape: Dict[str, int] = dict(zip(axis_names, shape))
        self.ranks = np.arange(int(np.prod(shape))).reshape(shape)
        self.size = self.ranks.size
        world = dist.get_world_size() if dist.is_initialized() else 1
        self.rank = dist.get_rank() if dist.is_initialized() else 0
        if self.size > world:
            raise ValueError(f"a mesh of {self.size} ranks needs as many processes, the group has {world}")
        self.coords = {n: int(c) for n, c in zip(axis_names, np.argwhere(self.ranks == self.rank)[0])} \
            if self.rank < self.size else None
        # one group per set of axes; every rank creates every group, in one order
        self._groups: Dict[Tuple[str, ...], Optional[dist.ProcessGroup]] = {}
        for k in range(1, len(axis_names) + 1):
            for axes in itertools.combinations(axis_names, k):
                self._groups[axes] = self._make_groups(axes) if world > 1 else None

    def _make_groups(self, axes: Tuple[str, ...]):
        dims = [self.axis_names.index(a) for a in axes]
        rest = [d for d in range(len(self.axis_names)) if d not in dims]
        moved = np.transpose(self.ranks, rest + dims).reshape(-1, int(np.prod([self.ranks.shape[d] for d in dims])))
        mine = None
        for ranks in moved:
            g = dist.new_group([int(r) for r in ranks])
            if self.rank in ranks:
                mine = g
        return mine

    def _axes(self, axes: Axes) -> Tuple[str, ...]:
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        unknown = set(axes) - set(self.axis_names)
        if unknown:
            raise KeyError(f"axes {sorted(unknown)} are not in the mesh's {self.axis_names}")
        return tuple(a for a in self.axis_names if a in axes)

    def axis_size(self, axes: Axes) -> int:
        """The number of ranks along ``axes`` (one name or several)."""
        return int(np.prod([self.shape[a] for a in self._axes(axes)]))

    def index(self, axes: Axes) -> int:
        """This rank's index along ``axes``, several axes flattened in mesh order."""
        idx = 0
        for a in self._axes(axes):
            idx = idx * self.shape[a] + self.coords[a]
        return idx

    def group(self, axes: Axes) -> Optional[dist.ProcessGroup]:
        """The process group of this rank along ``axes``; None on one rank."""
        return self._groups[self._axes(axes)] if self.axis_size(axes) > 1 else None

    def backends(self) -> List[str]:
        """The backend of every process group the mesh holds (none on one
        process)."""
        return sorted({str(dist.get_backend(g)) for g in self._groups.values() if g is not None})

    def capturable(self, device: Union[str, torch.device]) -> bool:
        """Whether the mesh's collectives can run inside a ``graphs.Program``
        on ``device``: on the CPU, where a program runs eagerly, always; on
        CUDA when every group it holds is NCCL (or it holds none)."""
        if torch.device(device).type != "cuda":
            return True
        return all(b == "nccl" or "cuda:nccl" in b.split(",") for b in self.backends())

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, rank={self.rank})"


def make_mesh(n_devices: Optional[int] = None, axis_names: Tuple[str, ...] = ("data",),
              shape: Optional[Tuple[int, ...]] = None) -> Mesh:
    """A mesh over the first ``n_devices`` ranks (default: all of them), by
    default every rank along the first axis.  Every rank of the process
    group calls it (group creation is collective)."""
    n = n_devices or (dist.get_world_size() if dist.is_initialized() else 1)
    if shape is None:
        shape = (n,) + (1,) * (len(axis_names) - 1)
    assert int(np.prod(shape)) == n, (shape, n)
    return Mesh(tuple(shape), tuple(axis_names))


_ACTIVE: List[Mesh] = []


@contextlib.contextmanager
def use_mesh(mesh: Mesh) -> Iterator[Mesh]:
    """Resolve axis names in ``mesh`` inside the block."""
    _ACTIVE.append(mesh)
    try:
        yield mesh
    finally:
        _ACTIVE.pop()


def current_mesh() -> Mesh:
    if not _ACTIVE:
        raise RuntimeError("a model built with a mesh axis name runs inside `with use_mesh(mesh):`")
    return _ACTIVE[-1]


def require_capturable(mesh: Optional[Mesh], device: Union[str, torch.device], what: str) -> None:
    """Raise unless ``mesh``'s collectives can be captured on ``device``
    (:meth:`Mesh.capturable`); ``what`` names the caller."""
    if mesh is not None and not mesh.capturable(device):
        raise RuntimeError(f"{what}: the mesh's {'/'.join(mesh.backends())} process groups carry CUDA tensors "
                           "through the host and cannot run inside a CUDA graph; use NCCL groups, or "
                           "use_runtime=False to run eagerly")


_POSE_BLOCKS: List[Tuple[int, int, int, int]] = []


@contextlib.contextmanager
def pose_block(requests: int, n: int, start: int, size: int) -> Iterator[None]:
    """Inside the block, a model scores the poses ``start:start + size`` of
    an ``n``-pose batch of each of ``requests`` requests (axis 1 of its
    ``(requests, poses, 7)`` input): a dropout mask over its per-pose rows
    is drawn for all ``n`` poses and this block's rows kept
    (``nn/layers.py::keep_mask``)."""
    _POSE_BLOCKS.append((requests, n, start, size))
    try:
        yield
    finally:
        _POSE_BLOCKS.pop()


def current_pose_block() -> Optional[Tuple[int, int, int, int]]:
    """``(requests, n, start, size)`` of the innermost :func:`pose_block`,
    or None."""
    return _POSE_BLOCKS[-1] if _POSE_BLOCKS else None


# --------------------------------------------------------------------------- #
# blocks of a leading axis
# --------------------------------------------------------------------------- #
def pad_to_multiple(x: torch.Tensor, n: int, dim: int = 0) -> Tuple[torch.Tensor, int]:
    """``x`` padded along ``dim`` to a multiple of ``n`` by repeating its
    last entry; returns (padded, original length)."""
    length = x.shape[dim]
    rem = (-length) % n
    if rem:
        shape = list(x.shape)
        shape[dim] = rem
        x = torch.cat([x, x.narrow(dim, length - 1, 1).expand(shape)], dim=dim)
    return x, length


def shard_batch(mesh: Mesh, x: torch.Tensor, axes: Axes = "data", dim: int = 0) -> Tuple[torch.Tensor, int]:
    """This rank's block of ``x`` along ``dim`` over ``axes``, ``x`` padded
    first; returns (block, original length)."""
    m = mesh.axis_size(axes)
    x, n = pad_to_multiple(x, m, dim)
    blk = x.shape[dim] // m
    return x.narrow(dim, mesh.index(axes) * blk, blk), n


def gather_batch(mesh: Mesh, x: torch.Tensor, n: int, axes: Axes = "data", dim: int = 0) -> torch.Tensor:
    """The blocks of :func:`shard_batch` gathered along ``dim``, the padding
    dropped (``n`` entries)."""
    return gather_blocks(x, mesh.group(axes), dim).narrow(dim, 0, n)


def replicate(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """``x`` made equal on every rank of the mesh: rank 0's, in place."""
    g = mesh.group(mesh.axis_names)
    if g is not None:
        dist.broadcast(x, src=0, group=g)
    return x


# --------------------------------------------------------------------------- #
# collectives
# --------------------------------------------------------------------------- #
class _ReduceFromShards(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        y = x.clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        return g, None


class _CopyToShards(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _GatherBlocks(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.dim, ctx.n = dim, x.shape[dim]
        ctx.rank = dist.get_rank(group)
        block = x.movedim(dim, 0).contiguous()  # the gathered axis in front: each rank's block is one span
        out = block.new_empty((dist.get_world_size(group) * block.shape[0],) + tuple(block.shape[1:]))
        dist.all_gather_into_tensor(out, block, group=group)
        return out if dim == 0 else out.movedim(0, dim).contiguous()

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.dim, ctx.rank * ctx.n, ctx.n), None, None


def reduce_from_shards(x: torch.Tensor, group: Optional[dist.ProcessGroup]) -> torch.Tensor:
    """The sum of ``x`` over the group's ranks (per-shard partials of a
    replicated result); its gradient passes unchanged."""
    return x if group is None else _ReduceFromShards.apply(x, group)


def copy_to_shards(x: torch.Tensor, group: Optional[dist.ProcessGroup]) -> torch.Tensor:
    """``x`` itself, a replicated tensor entering per-shard work; its
    gradient is summed over the group's ranks."""
    return x if group is None else _CopyToShards.apply(x, group)


def gather_blocks(x: torch.Tensor, group: Optional[dist.ProcessGroup], dim: int = 0) -> torch.Tensor:
    """Every rank's equal block of ``x`` concatenated along ``dim`` in rank
    order; the gradient of this rank's block is its block of the gradient."""
    return x if group is None else _GatherBlocks.apply(x, group, dim % x.ndim)


def all_reduce_max(x: torch.Tensor, group: Optional[dist.ProcessGroup]) -> torch.Tensor:
    """The elementwise max of ``x`` over the group (detached)."""
    x = x.detach()
    if group is None:
        return x
    y = x.clone()
    dist.all_reduce(y, op=dist.ReduceOp.MAX, group=group)
    return y


def all_reduce_sum(tensors: Sequence[torch.Tensor], group: Optional[dist.ProcessGroup]) -> List[torch.Tensor]:
    """Every tensor summed over the group, in one all-reduce of their
    concatenation (the data-parallel step's gradients)."""
    if group is None:
        return list(tensors)
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat, group=group)
    return [f.view_as(t) for f, t in zip(flat.split([t.numel() for t in tensors]), tensors)]
