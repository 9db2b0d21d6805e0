"""Fused per-edge segment of ``GraphAttention``: plan, weight folding, the
plain PyTorch version and the wrapper of the hand-written CUDA kernel
(``csrc/edge_kernel.cu``).

Per edge row the segment computes

    radial MLP -> DTP1 (per-edge radial weights) -> merged alpha/value linear
    -> GATv2 logits -> gate -> DTP2 (shared weights folded into the value
    linear) -> value linear

and returns ``logits (rows, H)`` and ``val (rows, attn_dim)``; the masked
softmax over K stays outside.  It is the counterpart of the JAX package's
``nn/edge_kernel.py`` (``edge_kernel_call`` and its ``_core``).

:func:`edge_kernel` is the wrapper: on a CPU tensor it runs
:func:`edge_core_plain`; on a CUDA tensor it launches the kernel, built at
first use with ``nvcc`` into ``build/`` at the repository root, or raises.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..geom.irreps import Irreps
from .layers import irreps2gate, norm_sigmoid, scalar_silu
from .tp import TPProgram, _cm_meta, im_perm
from .util import constant, sigmoid_norm, silu_norm, smooth_leaky_relu, smooth_leaky_relu_norm

__all__ = [
    "EdgePlan",
    "build_edge_plan",
    "prepare_weights",
    "pack_radial",
    "edge_core_plain",
    "edge_kernel",
    "build_library",
    "launches",
]

# Kernel launches since import (or the last reset by a caller); one per
# launch of the CUDA kernel, none for the plain version.
launches = 0

_SRC = Path(__file__).resolve().parent.parent / "csrc" / "edge_kernel.cu"
_BUILD_DIR = Path(__file__).resolve().parents[2] / "build"
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


def _consts(plan: EdgePlan, like: torch.Tensor):
    return (
        constant(("edge_C1", id(plan)), lambda: plan.dtp1.C_all, like),
        constant(("edge_C2", id(plan)), lambda: plan.dtp2.C_all, like),
        constant(("edge_Rg", id(plan)), lambda: plan.R_gate_im, like),
    )


def edge_core_plain(plan: EdgePlan, x1, attr, edge_scalars, weights, rad):
    """The plain PyTorch version of the kernel: the same function, assembled
    from lane slices and dense products.  ``x1`` is i-major (rows, dim_in);
    ``rad = (spec, arrays)`` from :func:`pack_radial`."""
    W_av, b_av, Dmat, W2, b2 = weights
    C1, C2, Rg = _consts(plan, x1)
    w_rad = _radial_fwd(rad[0], edge_scalars, rad[1])

    A1 = attr @ C1
    pieces = []
    for off, mul1, iks, ws, _lane in plan.dtp1.pieces:
        acc = None
        for i, c in iks:
            term = x1[:, off + i * mul1 : off + (i + 1) * mul1] * A1[:, c : c + 1]
            acc = term if acc is None else acc + term
        pieces.append(x1.new_zeros(x1.shape[0], mul1) if acc is None else acc * w_rad[:, ws : ws + mul1])
    comb = torch.cat(pieces, dim=-1) @ W_av + b_av

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
    return logits, val


# --------------------------------------------------------------------------- #
# CUDA kernel: build, tables, launch
# --------------------------------------------------------------------------- #
_LIB = None
build_log = ""


def build_library() -> float:
    """Compile ``csrc/edge_kernel.cu`` for sm_90a (once per source hash) and
    load it; returns the seconds spent."""
    global _LIB, build_log
    t0 = time.perf_counter()
    if _LIB is not None:
        return 0.0
    digest = hashlib.sha256(_SRC.read_bytes()).hexdigest()[:12]
    so = _BUILD_DIR / f"edge_kernel_{digest}.so"
    if not so.exists():
        nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
        _BUILD_DIR.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD_DIR)
        os.close(fd)
        cmd = [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
               "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-o", tmp, str(_SRC)]
        res = subprocess.run(cmd, capture_output=True, text=True)
        build_log = res.stdout + res.stderr
        if res.returncode != 0:
            os.unlink(tmp)
            raise RuntimeError(f"nvcc failed ({res.returncode}):\n{build_log}")
        os.replace(tmp, so)
    lib = ctypes.CDLL(str(so))
    lib.edge_kernel_launch.restype = ctypes.c_int
    lib.edge_kernel_launch.argtypes = [ctypes.c_void_p] + [ctypes.c_float] * 3 + [ctypes.c_void_p] * 15
    _LIB = lib
    return time.perf_counter() - t0


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


def _launch(plan: EdgePlan, x1, attr, edge_scalars, weights, rad):
    global launches
    W_av, b_av, Dmat, W2, b2 = weights
    spec, arrays = rad
    rad_dims = _rad_dims(spec, arrays)
    tensors = (x1, attr, edge_scalars, W_av, b_av, Dmat, W2, b2) + tuple(arrays)
    for t in tensors:
        if not (t.is_cuda and t.dtype == torch.float32 and t.device == x1.device):
            raise ValueError("edge_kernel: every operand must be float32 on x1's CUDA device")
    for t in (W_av, b_av, Dmat, W2, b2):
        if not t.is_contiguous():
            raise ValueError("edge_kernel: the folded weights must be contiguous (see prepare_weights)")
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
    for name, (got, want) in expect.items():
        if tuple(got) != tuple(want):
            raise ValueError(f"edge_kernel: {name} has shape {tuple(got)}, expected {want}")
    if n_comb > _MAX_COLS or attn > _MAX_COLS:
        raise ValueError(f"edge_kernel: product widths {n_comb}, {attn} exceed {_MAX_COLS}")
    if rows == 0:
        return x1.new_empty(0, H), x1.new_empty(0, attn)
    x1, attr, edge_scalars = x1.contiguous(), attr.contiguous(), edge_scalars.contiguous()

    build_library()
    tab = _tables(plan, spec, rad_dims)
    key = (id(plan), spec, rad_dims, x1.device)
    meta = _DEVICE_TABLES.get(key)
    if meta is None:
        meta = _DEVICE_TABLES[key] = torch.as_tensor(tab, device=x1.device)
    C1, C2, _ = _consts(plan, x1)
    rad_flat = torch.cat([a.reshape(-1) for a in arrays]).contiguous()
    max_hidden = max(rad_dims[1:-1]) if len(rad_dims) > 2 else 0
    cfg = np.asarray(
        [rows, plan.dim_in, plan.dim_sh, S, numel1, nA1, nA2,
         len(plan.dtp1.pieces), sum(len(p[2]) for p in plan.dtp1.pieces),
         len(plan.dtp2.pieces), sum(len(p[2]) for p in plan.dtp2.pieces),
         n_comb, ma, sd, gd, td, H, attn, len(spec), max_hidden, sd + td],
        dtype=np.int32,
    )
    logits = torch.empty(rows, H, dtype=torch.float32, device=x1.device)
    val = torch.empty(rows, attn, dtype=torch.float32, device=x1.device)
    stream = torch.cuda.current_stream(x1.device).cuda_stream
    ptrs = [x1, attr, edge_scalars, meta, rad_flat, W_av, b_av, Dmat, W2, b2, C1, C2, logits, val]
    with torch.cuda.device(x1.device):  # the C launcher uses the current device
        err = _LIB.edge_kernel_launch(
            cfg.ctypes.data, smooth_leaky_relu_norm(), silu_norm(), sigmoid_norm(),
            *[t.data_ptr() for t in ptrs], stream,
        )
    if err != 0:
        raise RuntimeError(f"edge_kernel: launch failed with cudaError {err}")
    launches += 1
    return logits, val


def edge_kernel(plan: EdgePlan, x1, attr, edge_scalars, weights, rad):
    """``(logits (rows, H), val (rows, attn_dim))`` of the fused edge
    segment.  ``x1`` i-major (rows, dim_in), ``attr`` (rows, dim_sh),
    ``edge_scalars`` (rows, S) feed the in-kernel radial MLP; ``weights``
    come from :func:`prepare_weights`, ``rad`` from :func:`pack_radial`.
    CPU tensors take :func:`edge_core_plain`; CUDA tensors launch the kernel."""
    if x1.is_cuda:
        return _launch(plan, x1, attr, edge_scalars, weights, rad)
    return edge_core_plain(plan, x1, attr, edge_scalars, weights, rad)
