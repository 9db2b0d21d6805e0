"""The gather of a constant table along the last axis and its transpose: two
linear autograd Functions, each the other's backward, and the wrapper of
the hand-written CUDA kernel of the transpose (``csrc/gather.cu``).

* :func:`gather_last` ``(x, table)`` is ``torch.index_select(x, -1,
  table.idx)``, the same op and kernels as ever;
* :func:`gather_last_t` ``(g, table)`` is its transpose:
  ``out[..., i]`` is the sum of ``g[..., lanes[k]]`` over ``k`` in
  ``ptr[i] .. ptr[i + 1]``, in that order.

``table`` holds the index and its CSR inverse (:func:`csr`): the positions
of ``idx`` grouped by the column they read, in ascending order within each
column, built at the first transpose that needs it.  Autograd's own
backward of ``index_select`` is ``zeros`` + ``index_add_``, a float atomic
scatter whose order changes from run to run; for a constant table the
transpose is a fixed sum that needs no atomics.
Because each Function's backward calls the other Function, gradients of
any order go through the same pair.

A table may leave positions out of its CSR (``keep``; ``partial`` is then
set): the transpose then does not sum them, and the two Functions are no
longer each other's adjoint.  ``gather_last``'s backward drops the
gradient at the left-out positions, and ``gather_last_t``'s backward (the
full gather) is not 0 where its true derivative is.  That is right only
where the caller knows the gradient at those positions to be 0, or
discards the gradient of the columns they read: ``tp.apply_dtp_cm``'s
missing terms, which multiply A's zero column (so x1's gradient there is
0) and read it (so the column's gradient is discarded by pad's backward),
and ``layers.IrrepsLinear``'s dense entries that read the zero element
appended to its parameters (no parameter: cat's backward discards its
gradient).  ``tp.cm_tables`` and ``IrrepsLinear._gather`` hold that
invariant, and ``tests/test_torch_gather.py`` checks it for every program
and every linear layer the shipped models build.  Any other caller builds
full tables.

The transpose of a CUDA tensor launches the kernel (float32 or float64),
built at first use, or raises; that of a CPU tensor runs
:func:`gather_last_t_plain`, the same CSR sum in PyTorch.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Callable, Hashable, NamedTuple, Optional, Tuple

import numpy as np
import torch

from .cuda_build import load_library
from .util import constant

__all__ = ["GatherTable", "csr", "gather_table", "gather_last", "gather_last_t", "gather_last_t_plain", "launches"]

# Kernel launches since import (or the last reset by a caller); one per
# launch of the CUDA kernel, none for the plain version.  A CUDA-graph
# capture bumps it as an eager call does; a replay does not.
launches = 0


class GatherTable(NamedTuple):
    idx: torch.Tensor  # (P,) int64: the column each position reads
    width: int  # columns of the gathered tensor
    partial: bool  # the CSR leaves positions out: not an adjoint pair (module docstring)
    inverse: Callable[[], Tuple[torch.Tensor, torch.Tensor]]  # (ptr, lanes), built at the first call

    @property
    def ptr(self) -> torch.Tensor:  # (width + 1,) int32: column i's positions are lanes[ptr[i]:ptr[i + 1]]
        return self.inverse()[0]

    @property
    def lanes(self) -> torch.Tensor:  # (nnz,) int32: positions, by column, ascending within a column
        return self.inverse()[1]


def csr(idx: np.ndarray, width: int, keep: Optional[np.ndarray] = None) -> Tuple[np.ndarray, np.ndarray]:
    """``(ptr, lanes)``, int32: the positions of ``idx`` grouped by the
    column they read, ascending within a column; only those where the bool
    mask ``keep`` is set, where given."""
    idx = np.asarray(idx, dtype=np.int64).reshape(-1)
    lanes = np.argsort(idx, kind="stable")
    if keep is not None:
        lanes = lanes[np.asarray(keep, dtype=bool).reshape(-1)[lanes]]
    ptr = np.zeros(width + 1, dtype=np.int64)
    ptr[1:] = np.cumsum(np.bincount(idx[lanes], minlength=width))
    return ptr.astype(np.int32), lanes.astype(np.int32)


def gather_table(key: Hashable, make: Callable[[], np.ndarray], width: int, like: torch.Tensor,
                 keep: Optional[Callable[[], np.ndarray]] = None) -> GatherTable:
    """The table of the index ``make()`` over ``width`` columns, its CSR over
    the positions ``keep()`` holds (all without it), on ``like``'s device,
    uploaded once per key through :func:`util.constant`: the index now, the
    CSR at the first transpose, so a gather that autograd never
    differentiates (serving's) builds none.  With ``keep`` the table is
    ``partial``: see the module docstring for what its caller must
    guarantee."""
    idx = constant(("gather_idx", key), lambda: np.asarray(make()).reshape(-1), like, dtype=torch.long)

    def inverse():  # on idx's device: the table keeps no reference to like
        host = functools.lru_cache(maxsize=None)(lambda: csr(make(), width, None if keep is None else keep()))
        return (constant(("gather_ptr", key), lambda: host()[0], idx, dtype=torch.int32),
                constant(("gather_lanes", key), lambda: host()[1], idx, dtype=torch.int32))

    return GatherTable(idx, width, keep is not None, inverse)


def gather_last_t_plain(g: torch.Tensor, table: GatherTable) -> torch.Tensor:
    """The plain PyTorch version of the kernel: each column's segment summed
    in order (``torch.segment_reduce``); an empty segment gives 0."""
    lead = g.shape[:-1]
    ptr, lanes = table.inverse()
    rows = g.reshape(-1, g.shape[-1]).index_select(-1, lanes.long())
    lengths = (ptr[1:] - ptr[:-1]).to(torch.long).expand(rows.shape[0], table.width)
    return torch.segment_reduce(rows, "sum", lengths=lengths, axis=1).reshape(*lead, table.width)


def bind(lib):
    """Declare the C launcher's signature on a loaded library of ``csrc/gather.cu``."""
    fn = lib.gather_last_t_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    return lib


@functools.lru_cache(maxsize=None)
def _library():
    return bind(load_library("gather"))


def _launch(g: torch.Tensor, table: GatherTable) -> torch.Tensor:
    global launches
    if g.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"gather_last_t: the CUDA kernel takes float32 or float64, not {g.dtype}")
    ptr, lanes = table.inverse()
    if not (ptr.device == g.device and lanes.device == g.device):
        raise ValueError("gather_last_t: the table lies on another device than the gradient")
    g = g.contiguous()
    out = torch.empty(*g.shape[:-1], table.width, dtype=g.dtype, device=g.device)  # every element written
    if g.numel() == 0:
        return out.zero_()
    P = g.shape[-1]
    rows = g.numel() // P
    stream = torch.cuda.current_stream(g.device).cuda_stream
    with torch.cuda.device(g.device):  # the C launcher uses the current device
        err = _library().gather_last_t_launch(g.data_ptr(), ptr.data_ptr(), lanes.data_ptr(),
                                              out.data_ptr(), rows, P, table.width, g.element_size(), stream)
    if err != 0:
        raise RuntimeError(f"gather_last_t: launch failed with cudaError {err}")
    launches += 1
    return out


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, table):
        ctx.table = table
        return torch.index_select(x, -1, table.idx)

    @staticmethod
    def backward(ctx, grad):
        return (gather_last_t(grad, ctx.table) if ctx.needs_input_grad[0] else None), None


class _GatherT(torch.autograd.Function):
    @staticmethod
    def forward(ctx, g, table):
        ctx.table = table
        return _launch(g, table) if g.is_cuda else gather_last_t_plain(g, table)

    @staticmethod
    def backward(ctx, grad):
        return (gather_last(grad, ctx.table) if ctx.needs_input_grad[0] else None), None


def gather_last(x: torch.Tensor, table: GatherTable) -> torch.Tensor:
    """``(..., P)``: ``x (..., width)`` read at ``table.idx`` along the last
    axis; its backward is :func:`gather_last_t`, which for a ``partial``
    table drops the gradient at the left-out positions."""
    if x.shape[-1] != table.width:
        raise ValueError(f"gather_last: {x.shape[-1]} columns, the table has {table.width}")
    return _Gather.apply(x, table)


def gather_last_t(g: torch.Tensor, table: GatherTable) -> torch.Tensor:
    """``(..., width)``: the transpose of :func:`gather_last` applied to
    ``g (..., P)`` (for a ``partial`` table, to ``g`` with its left-out
    positions set to 0); its backward is :func:`gather_last`."""
    if g.shape[-1] != table.idx.shape[0]:
        raise ValueError(f"gather_last_t: {g.shape[-1]} positions, the table has {table.idx.shape[0]}")
    return _GatherT.apply(g, table)
