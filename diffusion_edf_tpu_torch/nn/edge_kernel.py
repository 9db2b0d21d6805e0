"""Fused per-edge segment of ``GraphAttention``: plan, weight folding, the
plain PyTorch version and the wrapper of the hand-written CUDA kernel
(``csrc/edge_kernel.cu``).

Per edge row the segment computes

    radial MLP -> DTP1 (per-edge radial weights) -> merged alpha/value linear
    -> GATv2 logits -> gate -> DTP2 (shared weights folded into the value
    linear) -> value linear

and returns ``logits (rows, H)`` and ``val (rows, attn_dim)``; the masked
softmax over K stays outside.  Given a ``mask`` (rows,), the rows it drops
come back as exact zeros in both (the softmax tail multiplies them by 0, so
they must not be NaN), and the kernel computes only the rows it keeps.  It
is the counterpart of the JAX package's ``nn/edge_kernel.py``
(``edge_kernel_call`` with its ``_core``, and ``_call_transposed`` with its
``_core_t``).

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
Both kernels, and the fused attention kernel of ``nn/fused_attention.py``,
run both folded products on the tensor cores (``csrc/edge_segment_mma.cuh``)
and read the weights in another form, built once per set of weights by
:func:`mma_operands`: transposed, split into TF32 ``hi + lo`` parts where
the product is float32, padded, and cut into the chunks of 16 lanes that the
kernel stages through shared memory (:func:`chunk_schedule`).  They take the
widths of three instantiations, ``(n_comb, attn)`` padded to multiples of 32
as (352, 256), (192, 128) and (64, 32): every attention of the pick and
place models runs on one of them (the place models' keypoint fields, like
their key fields, on (352, 256), with a radial MLP of 64 -> 32 -> 32, a
runtime width); any other width raises ``ValueError``.  The mixed mode takes
no mask.
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
from .util import constant, records_grad, sigmoid_norm, silu_norm, smooth_leaky_relu, smooth_leaky_relu_norm

__all__ = [
    "EdgePlan",
    "build_edge_plan",
    "prepare_weights",
    "pack_radial",
    "weights_bf16",
    "EdgeWeights",
    "chunk_schedule",
    "group_records",
    "split_tf32",
    "chunk_images",
    "mma_operands",
    "edge_core_plain",
    "edge_kernel",
    "mma_segment_operands",
    "raise_launch_error",
    "bind",
    "launches",
    "launches_bf16",
]

# Kernel launches since import (or the last reset by a caller), float32 and
# mixed bfloat16; one per launch of the CUDA kernel, none for the plain version.
# A CUDA-graph capture bumps them without running anything and a replay does not;
# ``graphs.Program`` takes a capture's count back and adds it at every replay.
launches = 0
launches_bf16 = 0


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


class EdgeWeights(tuple):
    """The folded weights ``(W_av, b_av, Dmat, W2, b2)`` of one
    ``GraphAttention``.  A plain 5-tuple to its readers; it also keeps the
    device operands of the tensor-core kernels (:func:`mma_operands`), which
    are built once per radial MLP it is used with."""

    def __new__(cls, items):
        self = super().__new__(cls, items)
        self._mma = {}
        return self


def prepare_weights(plan: EdgePlan, W_av, b_av, Dmat, w2, W_lin2, b_lin2) -> EdgeWeights:
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
    return EdgeWeights((W_av_k.contiguous(), b_av_k.contiguous(), Dmat.contiguous(),
                        W2_k.contiguous(), b_lin2[None, :].contiguous()))


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
    return EdgeWeights((weights[0].to(torch.bfloat16),) + tuple(weights[1:]))


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


def _check_mask(name: str, mask, x1, mixed: bool) -> None:
    if mask is None:
        return
    if mixed:
        raise ValueError(f"{name}: the mixed bfloat16 mode takes no mask")
    if not (mask.dtype == torch.bool and mask.device == x1.device and tuple(mask.shape) == (x1.shape[0],)):
        raise ValueError(f"{name}: mask must be a (rows,) bool tensor on x1's device")


def edge_core_plain(plan: EdgePlan, x1, attr, edge_scalars, weights, rad, mask=None):
    """The plain PyTorch version of the kernel: the same function, assembled
    from lane slices and dense products.  ``x1`` is i-major (rows, dim_in);
    ``rad = (spec, arrays)`` from :func:`pack_radial`.  In the mixed mode
    (bfloat16 ``x1`` and ``W_av``) it rounds where the kernel rounds.  It
    computes every row; ``mask`` then zeroes the rows it drops."""
    W_av, b_av, Dmat, W2, b2 = weights
    mixed = _is_mixed(x1, W_av, (attr, edge_scalars, b_av, Dmat, W2, b2) + tuple(rad[1]))
    _check_mask("edge_core_plain", mask, x1, mixed)
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
    if mask is not None:
        keep = mask[:, None]
        logits, val = torch.where(keep, logits, 0.0), torch.where(keep, val, 0.0)
    return logits, (val.to(torch.bfloat16) if mixed else val)


# --------------------------------------------------------------------------- #
# CUDA kernels: tables, operands, launch
# --------------------------------------------------------------------------- #
_N_PTRS_F32 = 19  # pointer arguments of the float32 launcher after cfg and the three norms
_N_PTRS_BF16 = 17  # those of the mixed launcher
_CHUNK = 16  # Y lanes per staged chunk of the tensor-core kernels
_GROUP = 8  # lanes that share one piece: every piece is padded to a multiple of it
_W_BLOCK = 64  # columns of the radial MLP's last layer the tensor-core kernels compute at a time
_NO_FIT = -1  # the C launchers' code for "no instantiation for these widths, or over the shared memory"


def bind(lib):
    """Declare the C launchers' signatures on a loaded library of ``csrc/edge_kernel.cu``."""
    for fn, n in ((lib.edge_kernel_f32_launch, _N_PTRS_F32), (lib.edge_kernel_bf16_launch, _N_PTRS_BF16)):
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] + [ctypes.c_float] * 3 + [ctypes.c_void_p] * n
    return lib


@functools.lru_cache(maxsize=None)
def _library():
    return bind(load_library("edge_kernel"))


def _check_radial(spec) -> None:
    assert all(b and ln for b, ln in spec[:-1]) and spec[-1] == (False, False), (
        "kernel radial MLP: hidden layers with bias + LayerNorm, last layer with offset"
    )


def _gate_index(plan: EdgePlan) -> List[int]:
    """The gate of every gated lane (empty without gates)."""
    if not plan.gd:
        return []
    R = plan.R_gate_im
    assert np.all(R.sum(axis=0) == 1.0)
    return list(np.argmax(R, axis=0))


def chunk_schedule(dtp: _DtpPlan):
    """The K-chunk schedule of one DTP for the tensor-core kernels: its
    pieces laid end to end, each padded to a multiple of 8 lanes, the whole
    padded to a multiple of 16, cut into chunks of 16 lanes.  Returns
    ``(lane_src, lane0, group_piece)``: for every padded lane the DTP lane it
    holds (-1 for padding); for every piece its first padded lane; for every
    group of 8 padded lanes its piece (-1 for padding).  Chunk ``c`` is padded
    lanes ``16 c .. 16 c + 15``, groups ``2 c`` and ``2 c + 1``."""
    lane_src: List[int] = []
    lane0: List[int] = []
    group_piece: List[int] = []
    for p, (_off, mul1, _iks, _ws, lane) in enumerate(dtp.pieces):
        lane0.append(len(lane_src))
        width = -(-mul1 // _GROUP) * _GROUP
        lane_src += list(range(lane, lane + mul1)) + [-1] * (width - mul1)
        group_piece += [p] * (width // _GROUP)
    pad = -len(lane_src) % _CHUNK
    lane_src += [-1] * pad
    group_piece += [-1] * (pad // _GROUP)
    return np.asarray(lane_src), np.asarray(lane0), np.asarray(group_piece)


_GROUP_RECORD = 16  # ints per group record of the tensor-core kernels
_MAX_TERMS = _GROUP_RECORD - 5


def group_records(dtp: _DtpPlan, weighted: bool) -> np.ndarray:
    """One record of 16 ints per group of 8 padded lanes of
    :func:`chunk_schedule`, everything a thread of the tensor-core kernels
    needs to build the group's lanes: ``[0]`` the x lane of the group's first
    element for ``i = 0``; ``[1]`` how many of its 8 lanes are real (0 for
    padding); ``[2]`` the number of terms; ``[3]`` the radial-weight column of
    its first element (-1 when not ``weighted``); ``[4]`` the last block of 64
    radial-weight columns its chunk of 16 lanes reads (0 when not
    ``weighted``); ``[5:]`` per term ``(i * mul1) << 16 | A column`` (unused
    slots repeat the first term, so their loads stay in range).  The kernels
    read lanes in pairs, so multiplicities and lane offsets must be even."""
    _, lane0, group_piece = chunk_schedule(dtp)
    out = np.zeros((len(group_piece), _GROUP_RECORD), dtype=np.int64)
    out[:, 3] = -1
    for gi, p in enumerate(group_piece):
        if p < 0:
            continue
        off, mul1, iks, ws, _lane = dtp.pieces[p]
        u0 = gi * _GROUP - lane0[p]
        if len(iks) > _MAX_TERMS or off + mul1 * (max([i for i, _ in iks], default=0) + 1) >= 1 << 15:
            raise ValueError(f"tensor-core edge kernels: a piece with {len(iks)} terms or lanes past 2^15")
        if mul1 % 2 or off % 2 or ws % 2:
            raise ValueError(f"tensor-core edge kernels: odd multiplicity {mul1} or lane offset {off}")
        terms = [(i * mul1) << 16 | c for i, c in iks]
        out[gi, :4] = off + u0, min(_GROUP, mul1 - u0), len(iks), ws + u0 if weighted else -1
        out[gi, 5:] = (terms + terms[:1] * _MAX_TERMS)[:_MAX_TERMS] if terms else 0
    if weighted:  # the radial blocks come in order: a chunk reads up to the largest seen so far
        last = 0
        for c in range(len(out) // 2):
            last = max([last] + [int(w) // _W_BLOCK for w in out[2 * c : 2 * c + 2, 3] if w >= 0])
            out[2 * c : 2 * c + 2, 4] = last
    return out


@functools.lru_cache(maxsize=None)
def _mma_tables(plan: EdgePlan, spec: Tuple[Tuple[bool, bool], ...], rad_dims: Tuple[int, ...]) -> np.ndarray:
    """int32 tables the tensor-core kernels walk: the group records of DTP1
    and of DTP2; the gate index of every gated lane; the radial layer widths.
    The kernels compute the radial weights block by block as the chunks
    advance, so DTP1's pieces must come in the order of their weight starts
    and none may straddle two blocks."""
    starts = [ws for _off, _mul1, _iks, ws, _lane in plan.dtp1.pieces]
    if starts != sorted(starts) or any(ws % _W_BLOCK + mul1 > _W_BLOCK for _, mul1, _, ws, _ in plan.dtp1.pieces):
        raise ValueError("tensor-core edge kernels: DTP1's pieces must be ordered by weight start and "
                         f"lie within blocks of {_W_BLOCK} weight columns")
    if plan.dim_in % 2:
        raise ValueError(f"tensor-core edge kernels: odd message width {plan.dim_in}")
    _check_radial(spec)
    if any(d % 4 for d in rad_dims[1:-1]):
        raise ValueError(f"tensor-core edge kernels: hidden radial widths must be multiples of 4, got {rad_dims}")
    g1, g2 = group_records(plan.dtp1, True), group_records(plan.dtp2, False)
    out = list(g1.reshape(-1)) + list(g2.reshape(-1)) + _gate_index(plan) + list(rad_dims)
    return np.asarray(out, dtype=np.int32)


_DEVICE_TABLES: Dict[tuple, torch.Tensor] = {}


def _device_tables(plan, spec, rad_dims, device) -> torch.Tensor:
    key = (id(plan), spec, rad_dims, device)
    meta = _DEVICE_TABLES.get(key)
    if meta is None:
        meta = _DEVICE_TABLES[key] = torch.as_tensor(_mma_tables(plan, spec, rad_dims), device=device)
    return meta


def _rad_dims(spec, arrays) -> Tuple[int, ...]:
    """Radial MLP widths ``(in, h1, ..., out)`` from packed arrays."""
    dims = [arrays[0].shape[0]]
    ai = 0
    for has_bias, has_ln in spec:
        dims.append(arrays[ai].shape[1])
        ai += 1 + int(has_bias) + 2 * int(has_ln)
    return tuple(dims)


def _tf32_round(w: torch.Tensor) -> torch.Tensor:
    """float32 rounded to the nearest value with TF32's 10-bit mantissa."""
    bits = w.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def split_tf32(w: torch.Tensor):
    """``(hi, lo)`` with ``hi`` the TF32 rounding of ``w`` and ``lo`` the TF32
    rounding of the rest: ``hi + lo`` is ``w`` to 2^-22 relative, and both are
    read exactly by a TF32 tensor-core product."""
    hi = _tf32_round(w)
    return hi, _tf32_round(w - hi)


def chunk_images(Wt: torch.Tensor, depth_per_16_bytes: int) -> torch.Tensor:
    """``Wt`` (n, K) with depth K a multiple of 16, cut into chunks of 16 of
    depth, each in the shared-memory image ``wgmma`` reads (K-major, no
    swizzle: ``[16 / T][n][T]`` with T elements per 16 bytes).  Returns
    ``(K / 16, 16 / T, n, T)``."""
    n, K = Wt.shape
    T = depth_per_16_bytes
    return Wt.reshape(n, K // _CHUNK, _CHUNK // T, T).permute(1, 2, 0, 3).contiguous()


def _padded_transposed(W: torch.Tensor, lane_src: np.ndarray, n_pad: int) -> torch.Tensor:
    """``W`` (lanes, n) with its rows moved to their padded lanes, zero rows
    for padding, zero columns up to ``n_pad``, transposed: (n_pad, K_pad)."""
    out = W.new_zeros(n_pad, len(lane_src))
    keep = torch.as_tensor(np.flatnonzero(lane_src >= 0), device=W.device)
    out[: W.shape[1], keep] = W.t()
    return out


def _tf32_images(Wt: torch.Tensor) -> torch.Tensor:
    """Chunk images of the TF32 ``hi`` and ``lo`` parts: ``(chunks, 2, 4, n, 4)``."""
    return torch.stack([chunk_images(part, 4) for part in split_tf32(Wt)], dim=1).contiguous()


def mma_operands(plan: EdgePlan, weights, rad) -> Dict[str, torch.Tensor]:
    """The weight operands of the tensor-core kernels, from
    :func:`prepare_weights`' tuple (``W_av`` bfloat16 for the mixed kernel)
    and :func:`pack_radial`'s arrays, on the weights' device:

    * ``W1``: ``W_av`` transposed to (n_pad, K_pad) along :func:`chunk_schedule`
      (n_pad: the columns padded to a multiple of 32), as chunk images; TF32
      ``hi`` and ``lo`` parts when float32, one image when bfloat16;
    * ``W2``: the same for ``W2``, always TF32 ``hi`` and ``lo``;
    * ``Rw``, ``Rb``: the radial MLP's last layer and its offset, their
      columns padded to a multiple of 64;
    * ``radh``: the hidden radial layers, flat.

    Kept on ``weights`` when that is an :class:`EdgeWeights`."""
    spec, arrays = rad
    cache = getattr(weights, "_mma", None)
    key = tuple((id(a), a._version) for a in arrays)  # the radial MLP's tensors, as they stand
    if cache is not None and key in cache:
        return cache[key][1]
    W_av, _, _, W2, _ = weights
    src1, _, _ = chunk_schedule(plan.dtp1)
    src2, _, _ = chunk_schedule(plan.dtp2)
    n_pad1, n_pad2 = -(-W_av.shape[1] // 32) * 32, -(-W2.shape[1] // 32) * 32
    Wt1 = _padded_transposed(W_av, src1, n_pad1)
    W_last, off = arrays[-2], arrays[-1].reshape(-1)
    w_pad = -W_last.shape[1] % _W_BLOCK
    hidden = arrays[:-2]
    ops = dict(
        W1=chunk_images(Wt1, 8) if W_av.dtype == torch.bfloat16 else _tf32_images(Wt1),
        W2=_tf32_images(_padded_transposed(W2, src2, n_pad2)),
        Rw=torch.nn.functional.pad(W_last, (0, w_pad)).contiguous(),
        Rb=torch.nn.functional.pad(off, (0, w_pad)).contiguous(),
        radh=(torch.cat([a.reshape(-1) for a in hidden]) if hidden else off.new_zeros(1)).contiguous(),
    )
    if cache is not None:
        cache.clear()
        cache[key] = (list(arrays), ops)  # the tensors are kept, so their ids stay theirs
    return ops


def _check_operands(name: str, plan: EdgePlan, x1, attr, edge_scalars, weights, rad):
    """Check the operands of one launch of the edge segment (device, dtypes,
    shapes, contiguity; raises on what the kernels do not take); returns
    ``(mixed, rad_dims)``.  ``x1``, ``attr`` and ``edge_scalars`` are flat
    (rows, .)."""
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
    ma, sd, gd, td, H = plan.mul_alpha, plan.sd, plan.gd, plan.td, plan.H
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
    return mixed, rad_dims


def mma_segment_operands(name: str, plan: EdgePlan, x1, attr, edge_scalars, weights, rad):
    """The operands of one launch of a tensor-core kernel, checked:
    ``(mixed, cfg, tensors)``, the int32 config the C launchers read and the
    tensors ``(x1, attr, es, meta, radh, Rw, Rb, W1, b_av, Dmat, W2 images,
    b2, C1, C2)`` in their order."""
    mixed, rad_dims = _check_operands(name, plan, x1, attr, edge_scalars, weights, rad)
    _, b_av, Dmat, _, b2 = weights
    spec, _ = rad
    ops = mma_operands(plan, weights, rad)
    meta = _device_tables(plan, spec, rad_dims, x1.device)
    C1, C2, _ = _consts(plan, attr)
    cfg = np.asarray(
        [x1.shape[0], plan.dim_in, plan.dim_sh, rad_dims[0], C1.shape[1], C2.shape[1],
         ops["W1"].shape[0], ops["W2"].shape[0], b_av.shape[1], plan.mul_alpha, plan.sd, plan.gd, plan.td, plan.H, b2.shape[1], len(spec), rad_dims[-2],
         max(rad_dims[:-1]), plan.sd + plan.td, ops["Rw"].shape[1]],
        dtype=np.int32,
    )
    tensors = (x1.contiguous(), attr.contiguous(), edge_scalars.contiguous(), meta, ops["radh"], ops["Rw"],
               ops["Rb"], ops["W1"], b_av, Dmat, ops["W2"], b2, C1, C2)
    return mixed, cfg, tensors


def raise_launch_error(name: str, err: int) -> None:
    """Turn a C launcher's return code into an exception."""
    if err == _NO_FIT:
        raise ValueError(f"{name}: no kernel for these widths, or its tile exceeds the shared memory of an SM")
    if err != 0:
        raise RuntimeError(f"{name}: launch failed with cudaError {err}")


def _launch(plan: EdgePlan, x1, attr, edge_scalars, weights, rad, mask):
    global launches, launches_bf16
    mixed, cfg, tensors = mma_segment_operands("edge_kernel", plan, x1, attr, edge_scalars, weights, rad)
    _check_mask("edge_kernel", mask, x1, mixed)
    rows, dev = x1.shape[0], x1.device
    logits = torch.empty(rows, plan.H, dtype=torch.float32, device=dev)
    val = torch.empty(rows, weights[3].shape[1], dtype=x1.dtype, device=dev)
    if rows == 0:
        return logits, val
    lib = _library()
    norms = (smooth_leaky_relu_norm(), silu_norm(), sigmoid_norm())
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):  # the C launchers use the current device
        if mixed:
            err = lib.edge_kernel_bf16_launch(cfg.ctypes.data, *norms,
                                              *[t.data_ptr() for t in tensors + (logits, val)], stream)
        else:
            # the list of kept rows and the compaction's counts, written by the kernels before they are read
            scratch = torch.empty(rows + 3, dtype=torch.int32, device=dev) if mask is not None else None
            mask_c = None if mask is None else mask.contiguous()
            err = lib.edge_kernel_f32_launch(cfg.ctypes.data, *norms, *[t.data_ptr() for t in tensors[:3]],
                                             None if mask_c is None else mask_c.data_ptr(),
                                             *[t.data_ptr() for t in tensors[3:] + (logits, val)],
                                             None if scratch is None else scratch.data_ptr(), stream)
    raise_launch_error("edge_kernel", err)
    if mixed:
        launches_bf16 += 1
    else:
        launches += 1
    return logits, val


def edge_kernel(plan: EdgePlan, x1, attr, edge_scalars, weights, rad, mask=None):
    """``(logits (rows, H), val (rows, attn_dim))`` of the fused edge
    segment.  ``x1`` i-major (rows, dim_in), ``attr`` (rows, dim_sh),
    ``edge_scalars`` (rows, S) feed the in-kernel radial MLP; ``weights``
    come from :func:`prepare_weights` (through :func:`weights_bf16` for a
    bfloat16 ``x1``), ``rad`` from :func:`pack_radial`.  ``mask`` (rows,)
    bool or None: the rows it drops come back as exact zeros, and the kernel
    computes only the rows it keeps (float32 only; the mixed mode raises
    ``ValueError`` on a mask).  CPU tensors take :func:`edge_core_plain`;
    CUDA tensors launch the kernel, which has no backward: a CUDA call that
    autograd would record (grad enabled, an operand requiring grad) raises
    ``RuntimeError``."""
    if x1.is_cuda:
        if records_grad(x1, attr, edge_scalars, mask, weights, rad):
            raise RuntimeError("edge_kernel: the CUDA kernel has no backward; call it under torch.no_grad() "
                               "(GraphAttention routes autograd to edge_impl='plain')")
        return _launch(plan, x1, attr, edge_scalars, weights, rad, mask)
    return edge_core_plain(plan, x1, attr, edge_scalars, weights, rad, mask)
