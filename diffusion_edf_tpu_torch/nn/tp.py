"""Clebsch-Gordan tensor products: the trace-time planners (numpy, copied
from the JAX package's ``nn/tp.py``) and their PyTorch application.

* ``dtp_instructions`` — depthwise 'uvu' product against edge attributes;
* ``fctp_instructions`` — fully-connected 'uvw' product.

w3j tensors have unit Frobenius norm, are scaled by ``sqrt(2*l3+1)``
(component normalization), and each output slice carries a ``1/sqrt(fan_in)``
rescale applied in the forward pass.

``apply_dtp_cm`` is the component-major form used on edges: one
``attr @ C_all`` product gives every per-edge CG coefficient, then each
(path, output component k) is a sum of lane slices times those coefficients.
Its output lanes are per-path k-major; consumers fold ``cm_input_perm`` into
the next linear's weight rows.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..geom.cg import w3j
from ..geom.irreps import Irrep, Irreps, sort_irreps_even_first
from .gather import GatherTable, gather_last, gather_table
from .util import constant

__all__ = [
    "Instruction",
    "TPProgram",
    "dtp_instructions",
    "fctp_instructions",
    "apply_dtp",
    "apply_dtp_cm",
    "apply_fctp",
    "cm_eligible",
    "cm_tables",
    "cm_input_perm",
    "im_perm",
]


@dataclasses.dataclass(frozen=True)
class Instruction:
    i_in1: int
    i_in2: int
    i_out: int
    mode: str  # 'uvu' | 'uvw'
    w_start: int  # weight block location in the flat weight vector
    w_shape: Tuple[int, ...]


@dataclasses.dataclass(frozen=True)
class TPProgram:
    irreps_in1: Irreps
    irreps_in2: Irreps
    irreps_out: Irreps
    instructions: Tuple[Instruction, ...]
    weight_numel: int
    alpha: Tuple[float, ...]  # per-output-slice rescale 1/sqrt(fan_in)

    def w3j_for(self, ins: Instruction) -> np.ndarray:
        l1 = self.irreps_in1[ins.i_in1][1].l
        l2 = self.irreps_in2[ins.i_in2][1].l
        l3 = self.irreps_out[ins.i_out][1].l
        return np.asarray(w3j(l1, l2, l3)) * np.sqrt(2 * l3 + 1)


@functools.lru_cache(maxsize=None)
def dtp_instructions(irreps_in1: Irreps, irreps_in2: Irreps, irreps_out_target: Irreps) -> TPProgram:
    """Depthwise ('uvu') TP: every product irrep that appears in the target
    (or is the even scalar) is kept, sorted even-first."""
    irreps_in1, irreps_in2 = Irreps(irreps_in1), Irreps(irreps_in2)
    target = Irreps(irreps_out_target)
    out_entries: List[Tuple[int, Irrep]] = []
    raw_ins: List[Tuple[int, int, int]] = []
    for i, (mul, ir1) in enumerate(irreps_in1):
        for j, (_, ir2) in enumerate(irreps_in2):
            for ir_out in ir1 * ir2:
                if any(ir_out == ir for _, ir in target) or ir_out == Irrep(0, 1):
                    k = len(out_entries)
                    out_entries.append((mul, ir_out))
                    raw_ins.append((i, j, k))
    irreps_out, perm, _ = sort_irreps_even_first(Irreps(out_entries))
    instructions = []
    w_off = 0
    fan_in = [0.0] * len(irreps_out)
    for (i, j, k) in raw_ins:
        k_new = perm[k]
        mul1 = irreps_in1[i][0]
        mul2 = irreps_in2[j][0]
        instructions.append(Instruction(i, j, k_new, "uvu", w_off, (mul1, mul2)))
        w_off += mul1 * mul2
        fan_in[k_new] += mul2
    alpha = tuple(1.0 / np.sqrt(f) if f > 0 else 1.0 for f in fan_in)
    return TPProgram(irreps_in1, irreps_in2, irreps_out, tuple(instructions), w_off, alpha)


@functools.lru_cache(maxsize=None)
def fctp_instructions(irreps_in1: Irreps, irreps_in2: Irreps, irreps_out: Irreps) -> TPProgram:
    """Fully-connected ('uvw') TP."""
    irreps_in1, irreps_in2, irreps_out = Irreps(irreps_in1), Irreps(irreps_in2), Irreps(irreps_out)
    instructions = []
    w_off = 0
    fan_in = [0.0] * len(irreps_out)
    for i, (mul1, ir1) in enumerate(irreps_in1):
        for j, (mul2, ir2) in enumerate(irreps_in2):
            for k, (mul3, ir3) in enumerate(irreps_out):
                if ir3 in ir1 * ir2:
                    instructions.append(Instruction(i, j, k, "uvw", w_off, (mul1, mul2, mul3)))
                    w_off += mul1 * mul2 * mul3
                    fan_in[k] += mul1 * mul2
    alpha = tuple(1.0 / np.sqrt(f) if f > 0 else 1.0 for f in fan_in)
    return TPProgram(irreps_in1, irreps_in2, irreps_out, tuple(instructions), w_off, alpha)


def cm_eligible(prog: TPProgram) -> bool:
    """The component-major path needs every in2 entry to have multiplicity 1
    (true for spherical-harmonic edge attributes)."""
    return all(mul == 1 for mul, _ in prog.irreps_in2)


@functools.lru_cache(maxsize=None)
def _cm_meta(prog: TPProgram):
    """``(terms, C_all, cm_src)`` for :func:`apply_dtp_cm`:

    * ``C_all (dim2, nA)`` — one column per nonzero ``(path, i, k)`` CG slot
      with the w3j scale, normalization and fan-in rescale folded in;
    * ``terms`` — per instruction: input-entry lane offset, multiplicity,
      radial-weight block start and, per output component k, the
      ``(i, column)`` FMA terms;
    * ``cm_src`` — canonical output lane of each component-major lane.
    """
    assert cm_eligible(prog)
    in1_slices = prog.irreps_in1.slices()
    in2_offsets = [s.start for s in prog.irreps_in2.slices()]
    out_slices = prog.irreps_out.slices()
    dim2 = prog.irreps_in2.dim
    cols: List[np.ndarray] = []
    terms = []
    cm_src: List[int] = []
    for ins in prog.instructions:
        mul1, ir1 = prog.irreps_in1[ins.i_in1]
        d1 = ir1.dim
        d3 = prog.irreps_out[ins.i_out][1].dim
        W3 = np.asarray(prog.w3j_for(ins)) * prog.alpha[ins.i_out]  # (d1, d2, d3)
        j0 = in2_offsets[ins.i_in2]
        d2 = prog.irreps_in2[ins.i_in2][1].dim
        k_terms = []
        for k in range(d3):
            iks = []
            for i in range(d1):
                vals = W3[i, :, k]
                # threshold kills f64 w3j recursion noise (~1e-16 entries)
                if np.any(np.abs(vals) > 1e-9):
                    col = np.zeros((dim2,))
                    col[j0 : j0 + d2] = vals
                    iks.append((i, len(cols)))
                    cols.append(col)
            k_terms.append(tuple(iks))
        can_off = out_slices[ins.i_out].start
        for k in range(d3):
            for u in range(mul1):
                cm_src.append(can_off + u * d3 + k)
        terms.append(
            dict(
                e1_off=in1_slices[ins.i_in1].start,
                mul1=mul1,
                d1=d1,
                d3=d3,
                w_start=ins.w_start,
                k_terms=tuple(k_terms),
            )
        )
    C_all = np.stack(cols, axis=1) if cols else np.zeros((dim2, 0))
    return tuple(terms), C_all, tuple(cm_src)


def cm_input_perm(prog: TPProgram) -> Tuple[int, ...]:
    """Canonical-layout index of each component-major output lane."""
    return _cm_meta(prog)[2]


@functools.lru_cache(maxsize=None)
def im_perm(irreps: Irreps) -> Tuple[int, ...]:
    """Canonical-layout index of each *i-major* lane: per entry, components
    outer, multiplicities inner (``lane(e, i, u) -> off_e + u*d + i``)."""
    irreps = Irreps(irreps)
    perm: List[int] = []
    off = 0
    for mul, ir in irreps:
        d = ir.dim
        for i in range(d):
            for u in range(mul):
                perm.append(off + u * d + i)
        off += mul * d
    return tuple(perm)


@functools.lru_cache(maxsize=None)
def _cm_gather(prog: TPProgram, x1_component_major: bool):
    """Gather tables of :func:`apply_dtp_cm`, one column per output lane:
    ``X (n, L)`` the x1 lane and ``C (n, L)`` the column of ``A`` of each of
    the lane's up to ``n`` FMA terms, in the order of ``_cm_meta``'s terms
    (missing terms read the zero column ``nA`` appended to ``A``), and
    ``W (L,)`` the weight lane."""
    terms, C_all, _ = _cm_meta(prog)
    nA = C_all.shape[1]
    lanes = []
    for t in terms:
        off, mul1, d1 = t["e1_off"], t["mul1"], t["d1"]
        for iks in t["k_terms"]:
            for u in range(mul1):
                src = [(off + i * mul1 + u if x1_component_major else off + u * d1 + i, c) for i, c in iks]
                lanes.append((src, t["w_start"] + u))
    n = max([1] + [len(src) for src, _ in lanes])
    X = np.zeros((n, len(lanes)), dtype=np.int64)
    C = np.full((n, len(lanes)), nA, dtype=np.int64)
    for lane, (src, _) in enumerate(lanes):
        for j, (x, c) in enumerate(src):
            X[j, lane], C[j, lane] = x, c
    return X, C, np.asarray([w for _, w in lanes], dtype=np.int64)


def cm_tables(prog: TPProgram, x1_component_major: bool, like: torch.Tensor) -> Tuple[GatherTable, ...]:
    """The tables of :func:`_cm_gather` as :mod:`.gather` tables on ``like``'s
    device: ``X`` over x1's lanes, ``C`` over the columns of ``A`` and its
    zero column ``nA``, ``W`` over the weight lanes.  The positions of the
    missing terms (x1's lane 0 times the zero column) are left out of the
    transposes of ``X`` and ``C``: the gradient they carry to x1 is a
    product with the zero column, 0, and the zero column's own gradient is
    discarded by pad's backward.  They are some 60 % of the positions, and
    kept in, they would make lane 0's and the zero column's segments over
    a hundred times as long as the others.  So ``X`` and ``C`` are
    ``partial`` tables (:mod:`.gather`), right only where A's last column
    is that zero column and pad's backward discards its gradient, as in
    :func:`apply_dtp_cm`; ``W`` is full."""
    key = (prog, x1_component_major)
    nA = _cm_meta(prog)[1].shape[1]

    def present():
        return _cm_gather(*key)[1] != nA

    spec = (("X", prog.irreps_in1.dim, present), ("C", nA + 1, present), ("W", prog.weight_numel, None))
    return tuple(gather_table(("cm_gather", name) + key, lambda i=i: _cm_gather(*key)[i], width, like, keep)
                 for i, (name, width, keep) in enumerate(spec))


def apply_dtp_cm(
    prog: TPProgram,
    x1: torch.Tensor,
    x2: torch.Tensor,
    weight: torch.Tensor,
    x1_component_major: bool = False,
) -> torch.Tensor:
    """uvu TP in the component-major output layout (``lane = k*mul1 + u``
    per instruction; map back with :func:`cm_input_perm`).

    ``x1_component_major``: x1 lanes are in :func:`im_perm` order (else
    canonical).  Every output lane sums its FMA terms ``x1[lane_i] *
    A[col]`` in a fixed order and is scaled by its weight lane; the j-th
    terms of all lanes are gathered at once, so the op count does not grow
    with the number of paths (it matters under autograd, where every op has
    a backward)."""
    X, C, W = cm_tables(prog, x1_component_major, x1)
    n = X.idx.shape[0] // W.idx.shape[0]
    A = x2 @ constant(("cm_C_all", prog), lambda: _cm_meta(prog)[1], x2)  # (..., nA)
    A = torch.nn.functional.pad(A, (0, 1))  # the zero column of missing terms
    # index_select forward; the backward sums each column's readers over the table's CSR (nn/gather.py), not
    # index_select's own atomic index_add
    prod = gather_last(x1, X) * gather_last(A, C)  # (..., n * L), term-major
    terms = prod.reshape(*prod.shape[:-1], n, W.idx.shape[0]).unbind(-2)
    acc = terms[0]
    for term in terms[1:]:
        acc = acc + term
    return acc * gather_last(weight, W)


def _blocks(irreps: Irreps, f: torch.Tensor) -> List[torch.Tensor]:
    out = []
    i = 0
    for mul, ir in irreps:
        out.append(f[..., i : i + mul * ir.dim].reshape(*f.shape[:-1], mul, ir.dim))
        i += mul * ir.dim
    return out


def _assemble(irreps: Irreps, blocks: List[Optional[torch.Tensor]], batch_shape, like: torch.Tensor) -> torch.Tensor:
    outs = []
    for (mul, ir), blk in zip(irreps, blocks):
        if blk is None:
            outs.append(like.new_zeros(batch_shape + (mul * ir.dim,)))
        else:
            outs.append(blk.reshape(*batch_shape, mul * ir.dim))
    return torch.cat(outs, dim=-1)


def apply_dtp(prog: TPProgram, x1: torch.Tensor, x2: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """uvu TP with per-row or shared (1-D) weights, canonical output layout
    (node-level products such as the score head's, where in2 has mul > 1)."""
    b1 = _blocks(prog.irreps_in1, x1)
    b2 = _blocks(prog.irreps_in2, x2)
    batch = torch.broadcast_shapes(
        x1.shape[:-1], x2.shape[:-1], weight.shape[:-1] if weight.ndim > 1 else ()
    )
    acc: List[Optional[torch.Tensor]] = [None] * len(prog.irreps_out)
    for ins in prog.instructions:
        C = constant(("w3j_for", prog, ins), lambda ins=ins: prog.w3j_for(ins), x1)
        mul1, mul2 = ins.w_shape
        w = weight[..., ins.w_start : ins.w_start + mul1 * mul2]
        w = w.reshape(*w.shape[:-1], mul1, mul2)
        if weight.ndim == 1:
            # contract the shared weight with in2 first: (..., u, j)
            y = torch.einsum("uv,...vj->...uj", w, b2[ins.i_in2])
            term = torch.einsum("...ui,...uj,ijk->...uk", b1[ins.i_in1], y, C)
        else:
            term = torch.einsum("...ui,...vj,ijk,...uv->...uk", b1[ins.i_in1], b2[ins.i_in2], C, w)
        term = term * prog.alpha[ins.i_out]
        acc[ins.i_out] = term if acc[ins.i_out] is None else acc[ins.i_out] + term
    return _assemble(prog.irreps_out, acc, batch, x1)


def apply_fctp(prog: TPProgram, x1: torch.Tensor, x2: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """uvw TP with shared weights (flat vector of length ``weight_numel``)."""
    b1 = _blocks(prog.irreps_in1, x1)
    b2 = _blocks(prog.irreps_in2, x2)
    batch = torch.broadcast_shapes(x1.shape[:-1], x2.shape[:-1])
    acc: List[Optional[torch.Tensor]] = [None] * len(prog.irreps_out)
    for ins in prog.instructions:
        C = constant(("w3j_for", prog, ins), lambda ins=ins: prog.w3j_for(ins), x1)
        mul1, mul2, mul3 = ins.w_shape
        w = weight[ins.w_start : ins.w_start + mul1 * mul2 * mul3].reshape(mul1, mul2, mul3)
        term = torch.einsum("...ui,...vj,ijk,uvw->...wk", b1[ins.i_in1], b2[ins.i_in2], C, w)
        term = term * prog.alpha[ins.i_out]
        acc[ins.i_out] = term if acc[ins.i_out] is None else acc[ins.i_out] + term
    return _assemble(prog.irreps_out, acc, batch, x1)
