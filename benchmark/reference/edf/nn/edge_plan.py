"""The edge segment's plan and folded weights (the plain parts of the
program's ``nn/edge_kernel.py``, copied): what ``work.py`` counts a
``GraphAttention``'s operations and bytes from.  No kernel."""
from __future__ import annotations

import dataclasses
import functools
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..geom.irreps import Irreps
from .layers import irreps2gate
from .tp import TPProgram, _cm_meta, im_perm

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


def _rad_dims(spec, arrays) -> Tuple[int, ...]:
    """Radial MLP widths ``(in, h1, ..., out)`` from packed arrays."""
    dims = [arrays[0].shape[0]]
    ai = 0
    for has_bias, has_ln in spec:
        dims.append(arrays[ai].shape[1])
        ai += 1 + int(has_bias) + 2 * int(has_ln)
    return tuple(dims)


