"""Fused edge attention of ``GraphAttention``: the per-edge segment, the
masked softmax over the K neighbour slots and the head-expanded weighted sum
as one function; its plain PyTorch version and the wrapper of the
hand-written CUDA kernel (``csrc/fused_attention.cu``).  It is the
counterpart of the JAX package's ``nn/fused_attention.py`` (``core_math``
and its Pallas dispatch ``_pallas_core``).

Per destination row ``n`` with slots ``k``:

    logits (K, H), val (K, attn_dim) = the edge segment of ``nn/edge_kernel.py``
    l     = where(mask, logits + pre, -1e30);  m = max(max_k l, -0.5e30)
    ea    = where(mask, exp(l - m), 0)
    alpha = ea / max(sum_k ea, 0.5) * post
    out[n, f] = sum_k alpha[k, h(f)] * val[k, f]

A masked slot contributes exactly 0 and a row whose slots are all masked
gives 0.  Unlike the JAX function, which takes the per-edge radial weights
``w_rad`` as an input, this one takes the raw edge scalars and the packed
radial MLP as the edge kernel does, so ``w_rad`` never exists; the plain
version runs the same radial MLP first.  Everything is float32.

:func:`fused_attention` is the wrapper: on a CPU tensor it runs
:func:`fused_attention_plain`; on a CUDA tensor it launches the kernel, built
at first use, or raises.  The kernel computes only the slots the mask keeps:
a first small kernel lists the valid slots in order (:func:`compact_plain` is
its plain version) and the main kernel takes the list in tiles of 64 slots,
whatever destination rows they belong to (:func:`tile_segments`); both
products of the segment run on the tensor cores as 3xTF32.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import numpy as np
import torch

from .cuda_build import load_library
from .edge_kernel import EdgePlan, edge_core_plain, mma_segment_operands, raise_launch_error
from .util import constant, records_grad, sigmoid_norm, silu_norm, smooth_leaky_relu_norm

__all__ = ["fused_attention", "fused_attention_plain", "compact_plain", "tile_segments", "tile_stats", "bind",
           "launches"]

# Kernel launches since import (or the last reset by a caller); one per
# launch of the CUDA kernel, none for the plain version.
# A CUDA-graph capture bumps them without running anything and a replay does not;
# ``graphs.Program`` takes a capture's count back and adds it at every replay.
launches = 0

_TILE = 64  # valid slots a block takes through the edge segment
_MAX_HEADS = 8  # heads the kernel's softmax state is sized for


def fused_attention_plain(
    plan: EdgePlan,
    head_of_col: Tuple[int, ...],
    message: torch.Tensor,  # (Nd, K, dim_in) i-major
    edge_attr: torch.Tensor,  # (Nd, K, dim_sh)
    edge_scalars: torch.Tensor,  # (Nd, K, S)
    mask: torch.Tensor,  # (Nd, K) bool
    pre_logit: Optional[torch.Tensor],  # (Nd, K)
    post_attn: Optional[torch.Tensor],  # (Nd, K)
    weights,
    rad,
) -> torch.Tensor:
    """The plain PyTorch version of the kernel; returns (Nd, attn_dim)."""
    nd, nk = message.shape[:2]
    logits, val = edge_core_plain(
        plan, message.reshape(nd * nk, -1), edge_attr.reshape(nd * nk, -1),
        edge_scalars.reshape(nd * nk, -1), weights, rad,
    )
    logits = logits.reshape(nd, nk, plan.H)
    if pre_logit is not None:
        logits = logits + pre_logit[..., None]
    valid = mask[..., None]
    logits = torch.where(valid, logits, torch.full_like(logits, -1e30))
    m = torch.clamp(logits.amax(dim=1, keepdim=True), min=-0.5e30)
    ea = torch.where(valid, torch.exp(logits - m), torch.zeros_like(logits))
    # floor 0.5: a row with a valid slot has a denominator >= 1, so the floor
    # only engages on all-masked rows (alpha = 0 there)
    alpha = ea / torch.clamp(ea.sum(dim=1, keepdim=True), min=0.5)
    if post_attn is not None:
        alpha = alpha * post_attn[..., None]
    hoc = constant(("head_of_col", head_of_col), lambda: np.asarray(head_of_col), message, dtype=torch.long)
    return (alpha[..., hoc] * val.reshape(nd, nk, -1)).sum(dim=1)


def compact_plain(mask: torch.Tensor):
    """The plain version of the kernel's compaction: ``(slots, rowptr)`` with
    ``slots`` the flat indices of the valid slots of ``mask`` (Nd, K) in
    order and ``rowptr[n]`` the number of valid slots before destination row
    ``n`` (``rowptr[Nd]`` is their number)."""
    flat = mask.reshape(-1)
    slots = torch.nonzero(flat).reshape(-1).to(torch.int32)
    rowptr = torch.zeros(mask.shape[0] + 1, dtype=torch.int32, device=mask.device)
    rowptr[1:] = torch.cumsum(mask.sum(dim=1), dim=0)
    return slots, rowptr


def tile_segments(slots, rowptr, K: int, tile: int = _TILE):
    """How the kernel cuts the list of valid slots: per tile of ``tile``
    consecutive entries, its segments ``(destination row, first tile row, end
    tile row, tiles the row spans, part)``.  A row that spans one tile is
    written by that tile; else each of its tiles publishes one part, ``part``
    0 when the row began in an earlier tile and 1 when it begins in this one
    (None for a row in one tile)."""
    slots, rowptr = [np.asarray(a.cpu() if isinstance(a, torch.Tensor) else a) for a in (slots, rowptr)]
    tiles = []
    for pos0 in range(0, len(slots), tile):
        rows = slots[pos0 : pos0 + tile] // K
        segs = []
        for r, n in enumerate(rows):
            if r == 0 or n != rows[r - 1]:
                spans = (rowptr[n + 1] - 1) // tile - rowptr[n] // tile + 1
                segs.append([int(n), r, r + 1, int(spans), None if spans == 1 else int(rowptr[n] >= pos0)])
            else:
                segs[-1][2] = r + 1
        tiles.append([tuple(s) for s in segs])
    return tiles


def tile_stats(mask: torch.Tensor, tile: int = _TILE):
    """``(valid slots, tiles that do work, mean fill of those tiles)`` of one call."""
    valid = int(mask.sum())
    tiles = -(-valid // tile)
    return valid, tiles, (valid / (tiles * tile) if tiles else 0.0)


def bind(lib):
    """Declare the C launcher's signature on a loaded library of ``csrc/fused_attention.cu``."""
    fn = lib.fused_attention_launch
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] + [ctypes.c_float] * 3 + [ctypes.c_int] * 2
                   + [ctypes.c_void_p] * 24)
    return lib


@functools.lru_cache(maxsize=None)
def _library():
    return bind(load_library("fused_attention"))


def _launch(plan, head_of_col, message, edge_attr, edge_scalars, mask, pre_logit, post_attn, weights, rad):
    global launches
    nd, nk = message.shape[:2]
    dev = message.device
    mixed, cfg, tensors = mma_segment_operands(
        "fused_attention", plan, message.reshape(nd * nk, -1), edge_attr.reshape(nd * nk, -1),
        edge_scalars.reshape(nd * nk, -1), weights, rad,
    )
    if mixed:
        raise TypeError("fused_attention: float32 only")
    if plan.H > _MAX_HEADS:
        raise ValueError(f"fused_attention: {plan.H} heads exceed {_MAX_HEADS}")
    if len(head_of_col) != plan.attn_dim:
        raise ValueError(f"fused_attention: head_of_col has {len(head_of_col)} entries, expected {plan.attn_dim}")
    if not (mask.dtype == torch.bool and mask.device == dev and tuple(mask.shape) == (nd, nk)):
        raise ValueError("fused_attention: mask must be a (Nd, K) bool tensor on the message's device")
    for name, t in (("pre_logit", pre_logit), ("post_attn", post_attn)):
        if t is not None and not (t.dtype == torch.float32 and t.device == dev and tuple(t.shape) == (nd, nk)):
            raise ValueError(f"fused_attention: {name} must be a (Nd, K) float32 tensor on the message's device")
    out = torch.empty(nd, plan.attn_dim, dtype=torch.float32, device=dev)
    # scratch, all written by the kernels before it is read: the list of valid slots, the
    # position at which every row starts in it, a counter per row; two parts per tile
    ints = torch.empty(nd * nk + 2 * nd + 1, dtype=torch.int32, device=dev)
    slots, rowptr, counters = ints[: nd * nk], ints[nd * nk : nd * nk + nd + 1], ints[nd * nk + nd + 1 :]
    part = torch.empty(-(-nd * nk // _TILE) * 2 * (2 * plan.H + plan.attn_dim), dtype=torch.float32, device=dev)
    hoc = constant(("head_of_col", head_of_col), lambda: np.asarray(head_of_col), message, dtype=torch.int32)
    x1, attr, es = tensors[:3]
    mask_c = mask.contiguous()
    pre_c = pre_logit.contiguous() if pre_logit is not None else None
    post_c = post_attn.contiguous() if post_attn is not None else None
    ptrs = (x1, attr, es, mask_c, pre_c, post_c) + tensors[3:] + (hoc, out, slots, rowptr, counters, part)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):  # the C launcher uses the current device
        err = _library().fused_attention_launch(
            cfg.ctypes.data, smooth_leaky_relu_norm(), silu_norm(), sigmoid_norm(), nd, nk,
            *[None if t is None else t.data_ptr() for t in ptrs], stream,
        )
    raise_launch_error("fused_attention", err)
    launches += 1
    return out


def fused_attention(plan, head_of_col, message, edge_attr, edge_scalars, mask, pre_logit, post_attn, weights, rad):
    """``(Nd, attn_dim)`` attention output before the projection.
    ``message`` i-major (Nd, K, dim_in), ``edge_attr`` (Nd, K, dim_sh),
    ``edge_scalars`` (Nd, K, S), ``mask`` (Nd, K) bool, ``pre_logit`` and
    ``post_attn`` (Nd, K) or None; ``weights`` from ``prepare_weights``,
    ``rad`` from ``pack_radial``; ``head_of_col[f]`` is the head of output
    lane ``f``.  CPU tensors take :func:`fused_attention_plain`; CUDA tensors
    launch the kernel, which has no backward: a CUDA call that autograd would
    record (grad enabled, an operand requiring grad) raises ``RuntimeError``."""
    args = (plan, head_of_col, message, edge_attr, edge_scalars, mask, pre_logit, post_attn, weights, rad)
    if message.is_cuda and records_grad(*args[2:]):
        raise RuntimeError("fused_attention: the CUDA kernel has no backward; call it under torch.no_grad() "
                           "(GraphAttention routes autograd to edge_impl='plain')")
    if message.shape[0] == 0 or message.shape[1] == 0:  # no row, or no slot to attend
        return message.new_zeros(message.shape[0], plan.attn_dim)
    if message.is_cuda:
        return _launch(*args)
    return fused_attention_plain(*args)
