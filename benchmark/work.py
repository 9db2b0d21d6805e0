"""The work of the edge kernel K1 and the chip's peaks: the yardstick of the
per-layer roofline and utilisation metrics.

The arithmetic is the program's ``chip_smoke.py`` (``segment_work``,
``edge_work``, ``attention_work``), copied and read off the reference's
``GraphAttention`` (its edge plan and folded weights), so that it counts the
same work whatever implements it.  Peaks: one NVIDIA H100 SXM, dense rates
(NVIDIA's data sheet): TF32 495 TFLOP/s, the highest rate at which the card
multiplies float32 inputs, and HBM3 3.35 TB/s.
"""
from __future__ import annotations

from typing import Optional, Tuple

PEAK_TF32_FLOPS = 495e12
PEAK_BYTES = 3.35e12

__all__ = ["PEAK_TF32_FLOPS", "PEAK_BYTES", "segment_work", "edge_work", "attention_work", "least_seconds"]


def segment_work(ga, mixed: bool = False) -> Tuple[int, int, int, int]:
    """(flops per edge row, those of them in the ``Y1 @ W_av`` product, those
    in the ``Y2 @ W2`` product, weight bytes) of the edge segment of one
    ``GraphAttention`` (the reference's).  ``mixed``: ``W_av`` counts 2
    bytes an element."""
    from .reference.edf.nn.edge_plan import _rad_dims

    plan = ga.plan
    (W_av, _, Dmat, W2, _), (spec, arrays) = ga._kernel_weights()
    dims = _rad_dims(spec, arrays)
    per_row = 2 * sum(a * b for a, b in zip(dims[:-1], dims[1:]))  # radial MLP
    for dtp, W in ((plan.dtp1, W_av), (plan.dtp2, W2)):
        per_row += 2 * plan.dim_sh * dtp.C_all.shape[1]  # attr @ C
        per_row += sum(2 * len(iks) * mul for _, mul, iks, _, _ in dtp.pieces)  # DTP pieces
        per_row += 2 * W.shape[0] * W.shape[1]  # folded product
    per_row += 2 * Dmat.shape[0] * Dmat.shape[1]
    weight_bytes = 4 * (sum(a.numel() for a in arrays) + W2.numel() + Dmat.numel()
                        + plan.dtp1.C_all.size + plan.dtp2.C_all.size) + (2 if mixed else 4) * W_av.numel()
    return per_row, 2 * W_av.shape[0] * W_av.shape[1], 2 * W2.shape[0] * W2.shape[1], weight_bytes


def edge_work(ga, rows: int, S: int, mixed: bool = False, valid: Optional[int] = None, seg=None):
    """(flops, those of them in the first and in the second folded product,
    bytes) of one edge-kernel call: the products this call does and each
    input read once, each output written once.  ``mixed``: the message and
    ``val`` count 2 bytes an element.  ``valid``: the rows a mask keeps, the
    only ones computed and the only ones whose inputs are read; every row's
    outputs are written, and the mask adds a byte a row.  ``seg``: the
    layer's :func:`segment_work`, if already known."""
    plan = ga.plan
    per_row, p1, p2, weight_bytes = seg if seg is not None else segment_work(ga, mixed)
    wide = 2 if mixed else 4
    in_bytes = wide * plan.dim_in + 4 * (plan.dim_sh + S)
    out_bytes = wide * plan.attn_dim + 4 * plan.H
    n = rows if valid is None else valid
    return per_row * n, p1 * n, p2 * n, in_bytes * n + out_bytes * rows + weight_bytes + (0 if valid is None else rows)


def attention_work(ga, nd: int, k: int, S: int, n_valid: int, use_pre: bool, use_post: bool):
    """(flops, those of them in the two folded products, bytes) of one
    fused-attention call: the segment on ``n_valid`` slots plus their softmax
    and weighted sum; the valid slots' inputs and the whole mask read once,
    the (Nd, attn) output written once."""
    plan = ga.plan
    per_row, p1, p2, weight_bytes = segment_work(ga)
    per_row += 4 * plan.H + 2 * plan.attn_dim  # exp / scale per head, weighted sum per lane
    slot_bytes = 4 * (plan.dim_in + plan.dim_sh + S + int(use_pre) + int(use_post))
    nbytes = slot_bytes * n_valid + nd * k + weight_bytes + 4 * nd * plan.attn_dim
    return per_row * n_valid, (p1 + p2) * n_valid, nbytes


def least_seconds(flops: float, nbytes: float) -> float:
    """The least time the chip could take: operations at the TF32 rate or
    bytes at the memory's bandwidth, whichever is longer."""
    return max(flops / PEAK_TF32_FLOPS, nbytes / PEAK_BYTES)
