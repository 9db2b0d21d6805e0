"""Fused per-edge segment of ``GraphAttention``: plan, weight folding, the
plain PyTorch version and the wrapper of the hand-written CUDA kernel
(``csrc/edge_kernel.cu``).

Per edge row the segment computes

    radial MLP -> DTP1 (per-edge radial weights) -> merged alpha/value linear
    -> GATv2 logits -> gate -> DTP2 (shared weights folded into the value
    linear) -> value linear

and returns ``logits (rows, H)`` and ``val (rows, attn_dim)``; the masked
softmax over K stays outside.  It is the counterpart of the JAX package's
``nn/edge_kernel.py`` (``edge_kernel_call`` with its ``_core``, and
``_call_transposed`` with its ``_core_t``).

Two precisions, chosen by the dtypes of the operands and by nothing else:

* every operand float32: everything runs in float32;
* ``x1`` and ``W_av`` bfloat16, every other operand float32: the selective
  mixed precision of the JAX package's transposed kernel.  The message
  lanes, ``A1 = attr @ C1`` after its product, every DTP1 piece (each product
  and each sum rounded to bfloat16, the radial weight rounded before its
  product) and ``W_av`` are bfloat16; the ``Y1 @ W_av`` product accumulates in
  float32 and everything after it is float32.  ``logits`` come back float32,
  ``val`` bfloat16.

Any other combination raises.

:func:`edge_kernel` is the wrapper: on a CPU tensor it runs
:func:`edge_core_plain`; on a CUDA tensor it launches the kernel, built at
first use with ``nvcc`` into ``build/`` at the repository root, or raises.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..geom.irreps import Irreps
from .cuda_build import load_library
from .layers import irreps2gate, norm_sigmoid, scalar_silu
from .tp import TPProgram, _cm_meta, im_perm
from .util import constant, sigmoid_norm, silu_norm, smooth_leaky_relu, smooth_leaky_relu_norm

__all__ = [
    "EdgePlan",
    "build_edge_plan",
    "prepare_weights",
    "pack_radial",
    "weights_bf16",
    "edge_core_plain",
    "edge_kernel",
    "segment_operands",
    "launches",
    "launches_bf16",
]

# Kernel launches since import (or the last reset by a caller), float32 and
# mixed bfloat16; one per launch of the CUDA kernel, none for the plain version.
launches = 0
launches_bf16 = 0

_MAX_PIECE = 64  # widest DTP piece the kernel's piece buffer holds
_MAX_COLS = 384  # widest product output (12 columns per lane x 32 lanes)


@dataclasses.dataclass(frozen=True, eq=False)
class _DtpPlan:
    """Slice/FMA schedule of one component-major DTP, pieces grouped by
    descending width.  Per piece: (x1 entry lane offset, mul1, ((i, A
    column), ...), radial-weight block start, output lane)."""

    pieces: Tuple[Tuple[int, int, Tuple[Tuple[int, int], ...], int, int], ...]
    n_lanes: int
    cm_src: Tuple[int, ...]  # kernel lane -> canonical output lane
    C_all: np.ndarray  # (dim2, nA)


def _plan_dtp(prog: TPProgram) -> _DtpPlan:
    terms, C_all, cm_src_raw = _cm_meta(prog)
    raw = []
    cm_lane = 0
    for t in terms:
        for iks in t["k_terms"]:
            raw.append((t["e1_off"], t["mul1"], tuple(iks), t["w_start"], cm_lane))
            cm_lane += t["mul1"]
    order = sorted(range(len(raw)), key=lambda i: -raw[i][1])
    pieces = []
    lane = 0
    cm_src: List[int] = []
    for i in order:
        off, mul1, iks, ws, raw_lane = raw[i]
        pieces.append((off, mul1, iks, ws, lane))
        cm_src.extend(cm_src_raw[raw_lane : raw_lane + mul1])
        lane += mul1
    return _DtpPlan(tuple(pieces), lane, tuple(cm_src), C_all)


@dataclasses.dataclass(frozen=True, eq=False)
class EdgePlan:
    prog1: TPProgram
    prog2: TPProgram
    dtp1: _DtpPlan
    dtp2: _DtpPlan
    mul_alpha: int
    H: int
    sd: int  # gate scalars dim
    gd: int  # gate count
    td: int  # gated dim
    dim_in: int
    dim_sh: int
    attn_dim: int
    R_gate_im: np.ndarray  # (gd, td) i-major gate expansion


@functools.lru_cache(maxsize=None)
def build_edge_plan(
    prog1: TPProgram,
    prog2: TPProgram,
    irreps_mid: Irreps,
    H: int,
    mul_alpha: int,
    irreps_attn: Optional[Irreps] = None,
) -> EdgePlan:
    irreps_mid = Irreps(irreps_mid)
    s, g, t = irreps2gate(irreps_mid)
    sd, gd, td = s.dim, g.num_irreps, t.dim
    R = np.zeros((max(gd, 1), td))
    gi = ci = 0
    for mul, ir in t:
        for u in range(mul):
            R[gi + u, ci + u : ci + mul * ir.dim : mul] = 1.0
        gi += mul
        ci += mul * ir.dim
    return EdgePlan(
        prog1=prog1,
        prog2=prog2,
        dtp1=_plan_dtp(prog1),
        dtp2=_plan_dtp(prog2),
        mul_alpha=mul_alpha,
        H=H,
        sd=sd,
        gd=gd,
        td=td,
        dim_in=prog1.irreps_in1.dim,
        dim_sh=prog1.irreps_in2.dim,
        # the value linear's target width (irreps_attn), not the DTP2 output
        attn_dim=Irreps(irreps_attn).dim if irreps_attn is not None else Irreps(prog2.irreps_out).dim,
        R_gate_im=R,
    )


def _val_out_irreps(plan: EdgePlan) -> Irreps:
    irreps_mid = Irreps(plan.prog2.irreps_in1)
    s, g, t = irreps2gate(irreps_mid)
    return irreps_mid if g.dim == 0 else (s + g + t).simplify()


def prepare_weights(plan: EdgePlan, W_av, b_av, Dmat, w2, W_lin2, b_lin2):
    """Fold the layout permutations and DTP2's shared weights into dense
    matrices: ``W_av`` rows follow the kernel's DTP1 lane order and its
    columns ``[alpha | i-major value]``; ``W2`` rows follow the DTP2 lane
    order, scaled by the shared weight of each lane."""
    col_perm = np.concatenate(
        [np.arange(plan.mul_alpha), plan.mul_alpha + np.asarray(im_perm(_val_out_irreps(plan)))]
    )
    W_av_k = W_av[list(plan.dtp1.cm_src)][:, col_perm]
    b_av_k = b_av[col_perm][None, :]
    w2_lane = np.zeros(plan.dtp2.n_lanes, dtype=np.int64)
    for _off, mul1, _iks, ws, lane in plan.dtp2.pieces:
        w2_lane[lane : lane + mul1] = np.arange(ws, ws + mul1)
    W2_k = W_lin2[list(plan.dtp2.cm_src)] * w2[w2_lane][:, None]
    return (W_av_k.contiguous(), b_av_k.contiguous(), Dmat.contiguous(),
            W2_k.contiguous(), b_lin2[None, :].contiguous())


def pack_radial(rad_layers, rad_off):
    """Flatten ``RadialProfile.materialize()`` into (spec, arrays): spec is
    per-layer ``(has_bias, has_ln)``; arrays are ``[W, b?, ln_scale?,
    ln_bias?]*`` then the offset row."""
    spec = []
    arrays = []
    for W, b, s, bb in rad_layers:
        spec.append((b is not None, s is not None))
        arrays.append(W)
        if b is not None:
            arrays.append(b)
        if s is not None:
            arrays.extend([s, bb])
    arrays.append(rad_off)
    return tuple(spec), arrays


def _radial_fwd(spec, x, arrays):
    """Radial MLP from packed arrays; LayerNorm with the fast variance
    ``mean(x^2) - mean(x)^2`` and eps 1e-5."""
    ai = 0
    h = x
    n = len(spec)
    for li, (has_bias, has_ln) in enumerate(spec):
        h = h @ arrays[ai]
        ai += 1
        if has_bias:
            h = h + arrays[ai]
            ai += 1
        if li < n - 1:
            if has_ln:
                scale, bias = arrays[ai], arrays[ai + 1]
                ai += 2
                mu = h.mean(dim=-1, keepdim=True)
                var = (h * h).mean(dim=-1, keepdim=True) - mu * mu
                h = (h - mu) * torch.rsqrt(var + 1e-5) * scale + bias
            h = torch.nn.functional.silu(h)
    return h + arrays[ai]


def weights_bf16(weights):
    """``prepare_weights``' tuple with ``W_av`` cast to bfloat16: the operand
    set of the mixed-precision mode."""
    return (weights[0].to(torch.bfloat16),) + tuple(weights[1:])


def _is_mixed(x1, W_av, f32_operands) -> bool:
    """False for the float32 mode, True for the mixed bfloat16 mode; raises on
    any other combination of dtypes (a silently promoted operand would change
    what is rounded where)."""
    dts = (x1.dtype, W_av.dtype)
    if dts not in ((torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16)):
        raise TypeError(f"edge_kernel: x1 and W_av must both be float32 or both bfloat16, got {dts}")
    for t in f32_operands:
        if t.dtype != torch.float32:
            raise TypeError(f"edge_kernel: every operand but x1 and W_av must be float32, got {t.dtype}")
    return dts[0] == torch.bfloat16


def _consts(plan: EdgePlan, like: torch.Tensor):
    """``C1``, ``C2`` and the gate expansion in float32 on ``like``'s device."""
    f32 = torch.float32
    return (
        constant(("edge_C1", id(plan)), lambda: plan.dtp1.C_all, like, dtype=f32),
        constant(("edge_C2", id(plan)), lambda: plan.dtp2.C_all, like, dtype=f32),
        constant(("edge_Rg", id(plan)), lambda: plan.R_gate_im, like, dtype=f32),
    )


def edge_core_plain(plan: EdgePlan, x1, attr, edge_scalars, weights, rad):
    """The plain PyTorch version of the kernel: the same function, assembled
    from lane slices and dense products.  ``x1`` is i-major (rows, dim_in);
    ``rad = (spec, arrays)`` from :func:`pack_radial`.  In the mixed mode
    (bfloat16 ``x1`` and ``W_av``) it rounds where the kernel rounds."""
    W_av, b_av, Dmat, W2, b2 = weights
    mixed = _is_mixed(x1, W_av, (attr, edge_scalars, b_av, Dmat, W2, b2) + tuple(rad[1]))
    C1, C2, Rg = _consts(plan, attr)
    w_rad = _radial_fwd(rad[0], edge_scalars, rad[1])

    A1 = attr @ C1
    if mixed:
        A1, w_rad = A1.to(torch.bfloat16), w_rad.to(torch.bfloat16)
    pieces = []
    for off, mul1, iks, ws, _lane in plan.dtp1.pieces:
        acc = None
        for i, c in iks:
            term = x1[:, off + i * mul1 : off + (i + 1) * mul1] * A1[:, c : c + 1]
            acc = term if acc is None else acc + term
        pieces.append(x1.new_zeros(x1.shape[0], mul1) if acc is None else acc * w_rad[:, ws : ws + mul1])
    Y1 = torch.cat(pieces, dim=-1)
    # mixed: bfloat16 operands, float32 accumulation (their products are exact in float32)
    comb = (Y1.float() @ W_av.float() if mixed else Y1 @ W_av) + b_av

    ma, sd, gd = plan.mul_alpha, plan.sd, plan.gd
    la = smooth_leaky_relu(comb[:, :ma]) * smooth_leaky_relu_norm()
    logits = la @ Dmat
    scalars = scalar_silu(comb[:, ma : ma + sd])
    if gd:
        gated = comb[:, ma + sd + gd :] * (norm_sigmoid(comb[:, ma + sd : ma + sd + gd]) @ Rg)
    else:
        gated = comb[:, ma + sd :]
    mid = torch.cat([scalars, gated], dim=-1)  # i-major irreps_mid

    A2 = attr @ C2
    pieces = []
    for off, mul1, iks, _ws, _lane in plan.dtp2.pieces:
        acc = None
        for i, c in iks:
            term = mid[:, off + i * mul1 : off + (i + 1) * mul1] * A2[:, c : c + 1]
            acc = term if acc is None else acc + term
        pieces.append(mid.new_zeros(mid.shape[0], mul1) if acc is None else acc)
    val = torch.cat(pieces, dim=-1) @ W2 + b2
    return logits, (val.to(torch.bfloat16) if mixed else val)


# --------------------------------------------------------------------------- #
# CUDA kernel: tables, launch
# --------------------------------------------------------------------------- #
_N_PTRS = 15  # pointer arguments of the C launchers after cfg and the three norms


@functools.lru_cache(maxsize=None)
def _library():
    lib = load_library("edge_kernel")
    for fn in (lib.edge_kernel_launch, lib.edge_kernel_bf16_launch):
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] + [ctypes.c_float] * 3 + [ctypes.c_void_p] * _N_PTRS
    return lib


@functools.lru_cache(maxsize=None)
def _tables(plan: EdgePlan, spec: Tuple[Tuple[bool, bool], ...], rad_dims: Tuple[int, ...]) -> np.ndarray:
    """int32 tables the kernel walks: per DTP the pieces ``(off, mul1,
    term start, term count, weight start, lane)`` and terms ``(i, A col)``;
    the gate index of every gated lane; the radial layer widths."""
    out: List[int] = []
    for dp in (plan.dtp1, plan.dtp2):
        pieces, terms = [], []
        for off, mul1, iks, ws, lane in dp.pieces:
            assert mul1 <= _MAX_PIECE, mul1
            pieces.append((off, mul1, len(terms), len(iks), ws, lane))
            terms.extend(iks)
        out += [v for p in pieces for v in p] + [v for t in terms for v in t]
    if plan.gd:
        R = plan.R_gate_im
        assert np.all(R.sum(axis=0) == 1.0)
        out += list(np.argmax(R, axis=0))
    hidden = spec[:-1]
    assert all(b and ln for b, ln in hidden) and spec[-1] == (False, False), (
        "kernel radial MLP: hidden layers with bias + LayerNorm, last layer with offset"
    )
    out += list(rad_dims)
    return np.asarray(out, dtype=np.int32)


_DEVICE_TABLES: Dict[tuple, torch.Tensor] = {}


def _rad_dims(spec, arrays) -> Tuple[int, ...]:
    """Radial MLP widths ``(in, h1, ..., out)`` from packed arrays."""
    dims = [arrays[0].shape[0]]
    ai = 0
    for has_bias, has_ln in spec:
        dims.append(arrays[ai].shape[1])
        ai += 1 + int(has_bias) + 2 * int(has_ln)
    return tuple(dims)


def segment_operands(name: str, plan: EdgePlan, x1, attr, edge_scalars, weights, rad):
    """Check the operands of one launch of the edge segment (device, dtypes,
    shapes, contiguity; raises on what the kernels do not take) and return
    ``(mixed, cfg, tensors)``: the int32 config the C launchers read and the
    tensors ``(x1, attr, es, meta, rad_flat, W_av, b_av, Dmat, W2, b2, C1,
    C2)`` in the launchers' order.  ``x1``, ``attr`` and ``edge_scalars``
    are flat (rows, .)."""
    W_av, b_av, Dmat, W2, b2 = weights
    spec, arrays = rad
    rad_dims = _rad_dims(spec, arrays)
    others = (attr, edge_scalars, b_av, Dmat, W2, b2) + tuple(arrays)
    mixed = _is_mixed(x1, W_av, others)
    for t in (x1, W_av) + others:
        if not (t.is_cuda and t.device == x1.device):
            raise ValueError(f"{name}: every operand must be on x1's CUDA device")
    for t in (W_av, b_av, Dmat, W2, b2):
        if not t.is_contiguous():
            raise ValueError(f"{name}: the folded weights must be contiguous (see prepare_weights)")
    rows = x1.shape[0]
    S = edge_scalars.shape[1]
    n_comb, attn = W_av.shape[1], W2.shape[1]
    ma, sd, gd, td, H = plan.mul_alpha, plan.sd, plan.gd, plan.td, plan.H
    numel1 = rad_dims[-1]
    nA1, nA2 = plan.dtp1.C_all.shape[1], plan.dtp2.C_all.shape[1]
    expect = {
        "x1": (x1.shape, (rows, plan.dim_in)),
        "attr": (attr.shape, (rows, plan.dim_sh)),
        "edge_scalars": (edge_scalars.shape, (rows, rad_dims[0])),
        "W_av": (W_av.shape, (plan.dtp1.n_lanes, ma + sd + gd + td)),
        "b_av": (b_av.shape, (1, ma + sd + gd + td)),
        "W2": (W2.shape, (plan.dtp2.n_lanes, plan.attn_dim)),
        "b2": (b2.shape, (1, plan.attn_dim)),
        "Dmat": (Dmat.shape, (ma, H)),
    }
    for op, (got, want) in expect.items():
        if tuple(got) != tuple(want):
            raise ValueError(f"{name}: {op} has shape {tuple(got)}, expected {want}")
    if n_comb > _MAX_COLS or attn > _MAX_COLS:
        raise ValueError(f"{name}: product widths {n_comb}, {attn} exceed {_MAX_COLS}")
    tab = _tables(plan, spec, rad_dims)
    key = (id(plan), spec, rad_dims, x1.device)
    meta = _DEVICE_TABLES.get(key)
    if meta is None:
        meta = _DEVICE_TABLES[key] = torch.as_tensor(tab, device=x1.device)
    C1, C2, _ = _consts(plan, attr)
    rad_flat = torch.cat([a.reshape(-1) for a in arrays]).contiguous()
    max_hidden = max(rad_dims[1:-1]) if len(rad_dims) > 2 else 0
    cfg = np.asarray(
        [rows, plan.dim_in, plan.dim_sh, S, numel1, nA1, nA2,
         len(plan.dtp1.pieces), sum(len(p[2]) for p in plan.dtp1.pieces),
         len(plan.dtp2.pieces), sum(len(p[2]) for p in plan.dtp2.pieces),
         n_comb, ma, sd, gd, td, H, attn, len(spec), max_hidden, sd + td],
        dtype=np.int32,
    )
    tensors = (x1.contiguous(), attr.contiguous(), edge_scalars.contiguous(), meta, rad_flat,
               W_av, b_av, Dmat, W2, b2, C1, C2)
    return mixed, cfg, tensors


def _launch(plan: EdgePlan, x1, attr, edge_scalars, weights, rad):
    global launches, launches_bf16
    mixed, cfg, tensors = segment_operands("edge_kernel", plan, x1, attr, edge_scalars, weights, rad)
    rows, H, attn = x1.shape[0], plan.H, weights[3].shape[1]
    logits = torch.empty(rows, H, dtype=torch.float32, device=x1.device)
    val = torch.empty(rows, attn, dtype=x1.dtype, device=x1.device)
    if rows == 0:
        return logits, val
    lib = _library()
    fn = lib.edge_kernel_bf16_launch if mixed else lib.edge_kernel_launch
    stream = torch.cuda.current_stream(x1.device).cuda_stream
    with torch.cuda.device(x1.device):  # the C launcher uses the current device
        err = fn(cfg.ctypes.data, smooth_leaky_relu_norm(), silu_norm(), sigmoid_norm(),
                 *[t.data_ptr() for t in tensors + (logits, val)], stream)
    if err != 0:
        raise RuntimeError(f"edge_kernel: launch failed with cudaError {err}")
    if mixed:
        launches_bf16 += 1
    else:
        launches += 1
    return logits, val


def edge_kernel(plan: EdgePlan, x1, attr, edge_scalars, weights, rad):
    """``(logits (rows, H), val (rows, attn_dim))`` of the fused edge
    segment.  ``x1`` i-major (rows, dim_in), ``attr`` (rows, dim_sh),
    ``edge_scalars`` (rows, S) feed the in-kernel radial MLP; ``weights``
    come from :func:`prepare_weights` (through :func:`weights_bf16` for a
    bfloat16 ``x1``), ``rad`` from :func:`pack_radial`.  CPU tensors take
    :func:`edge_core_plain`; CUDA tensors launch the kernel."""
    if x1.is_cuda:
        return _launch(plan, x1, attr, edge_scalars, weights, rad)
    return edge_core_plain(plan, x1, attr, edge_scalars, weights, rad)
