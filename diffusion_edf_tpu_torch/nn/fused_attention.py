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
at first use, or raises.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import numpy as np
import torch

from .cuda_build import load_library
from .edge_kernel import EdgePlan, edge_core_plain, segment_operands
from .util import constant, sigmoid_norm, silu_norm, smooth_leaky_relu_norm

__all__ = ["fused_attention", "fused_attention_plain", "launches"]

# Kernel launches since import (or the last reset by a caller); one per
# launch of the CUDA kernel, none for the plain version.
launches = 0

_TILE = 32  # slots a block takes through the edge segment at a time
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


@functools.lru_cache(maxsize=None)
def _library():
    lib = load_library("fused_attention")
    fn = lib.fused_attention_launch
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] + [ctypes.c_float] * 3 + [ctypes.c_int] * 3
                   + [ctypes.c_void_p] * 20)
    return lib


def _launch(plan, head_of_col, message, edge_attr, edge_scalars, mask, pre_logit, post_attn, weights, rad):
    global launches
    nd, nk = message.shape[:2]
    dev = message.device
    mixed, cfg, tensors = segment_operands(
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
    # few destination rows: deal the K tiles of a row to several blocks, up to
    # about four blocks an SM in all (two are resident, so the tail stays short)
    n_tiles = -(-nk // _TILE)
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    nsplit = max(1, min(n_tiles, -(-4 * n_sm // nd)))
    part = counters = None
    if nsplit > 1:
        part = torch.empty(nd * nsplit * (2 * plan.H + plan.attn_dim), dtype=torch.float32, device=dev)
        counters = torch.zeros(nd, dtype=torch.int32, device=dev)
    hoc = constant(("head_of_col", head_of_col), lambda: np.asarray(head_of_col), message, dtype=torch.int32)
    x1, attr, es = tensors[:3]
    mask_c = mask.contiguous()
    pre_c = pre_logit.contiguous() if pre_logit is not None else None
    post_c = post_attn.contiguous() if post_attn is not None else None
    ptrs = (x1, attr, es, mask_c, pre_c, post_c) + tensors[3:] + (hoc, out, part, counters)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):  # the C launcher uses the current device
        err = _library().fused_attention_launch(
            cfg.ctypes.data, smooth_leaky_relu_norm(), silu_norm(), sigmoid_norm(), nd, nk, nsplit,
            *[None if t is None else t.data_ptr() for t in ptrs], stream,
        )
    if err != 0:
        raise RuntimeError(f"fused_attention: launch failed with cudaError {err}")
    launches += 1
    return out


def fused_attention(plan, head_of_col, message, edge_attr, edge_scalars, mask, pre_logit, post_attn, weights, rad):
    """``(Nd, attn_dim)`` attention output before the projection.
    ``message`` i-major (Nd, K, dim_in), ``edge_attr`` (Nd, K, dim_sh),
    ``edge_scalars`` (Nd, K, S), ``mask`` (Nd, K) bool, ``pre_logit`` and
    ``post_attn`` (Nd, K) or None; ``weights`` from ``prepare_weights``,
    ``rad`` from ``pack_radial``; ``head_of_col[f]`` is the head of output
    lane ``f``.  CPU tensors take :func:`fused_attention_plain`; CUDA tensors
    launch the kernel."""
    args = (plan, head_of_col, message, edge_attr, edge_scalars, mask, pre_logit, post_attn, weights, rad)
    if message.shape[0] == 0 or message.shape[1] == 0:  # no row, or no slot to attend
        return message.new_zeros(message.shape[0], plan.attn_dim)
    if message.is_cuda:
        return _launch(*args)
    return fused_attention_plain(*args)
