"""Static-shape neighbourhoods: padded radius search, FPS and dense
bipartite connectivity (counterpart of the JAX package's
``ops/neighbors.py``).  Every neighbourhood is a padded ``(N_dst, K)`` index
array plus a validity mask.  The radius search and the dense connectivity
also take clouds with leading batch axes (one cloud per request): each
destination then finds its neighbours in its own request's sources, with
indices local to that request.

Inside :func:`record_degree_tape`, every radius search also records each
destination's in-radius count before the top-k cap (``DegreeRecord``), so
that ``tools/k_truncation_report.py`` can measure how often a cap clips a
neighbourhood; with no tape open nothing is recorded or computed."""
from __future__ import annotations

import contextlib
from typing import Iterator, List, NamedTuple, Optional, Sequence, Tuple

import torch

__all__ = ["pairwise_sqdist", "radius_neighbors", "radius_graph", "dense_neighbors", "farthest_point_sampling",
           "count_within_radius", "DegreeRecord", "record_degree_tape", "summarize_degree_tape"]


class DegreeRecord(NamedTuple):
    """One radius search's truncation diagnostics: its call site's ``tag``,
    radius, cap, each destination's in-radius count before the cap (...,
    Nd) and the destination mask (or None)."""

    tag: str
    r: float
    k: int
    degree: torch.Tensor
    dst_mask: Optional[torch.Tensor]


_DEGREE_TAPE: Optional[List[DegreeRecord]] = None


@contextlib.contextmanager
def record_degree_tape() -> Iterator[List[DegreeRecord]]:
    """Within the block, every :func:`radius_neighbors` call appends its
    :class:`DegreeRecord` to the yielded list, in call order."""
    global _DEGREE_TAPE
    prev, tape = _DEGREE_TAPE, []
    _DEGREE_TAPE = tape
    try:
        yield tape
    finally:
        _DEGREE_TAPE = prev


def summarize_degree_tape(tape: Sequence[DegreeRecord]) -> List[dict]:
    """One dict a record, over its valid destinations: ``tag``, ``r``,
    ``k``, ``n_dst``, ``max_degree``, ``mean_degree`` and
    ``frac_truncated`` (the share whose count exceeds the cap)."""
    out = []
    for rec in tape:
        d = rec.degree.reshape(-1)
        if rec.dst_mask is not None:
            d = d[rec.dst_mask.reshape(-1)]
        d = d.cpu().numpy()
        out.append(dict(
            tag=rec.tag, r=float(rec.r), k=int(rec.k), n_dst=int(d.size),
            max_degree=int(d.max()) if d.size else 0,
            mean_degree=float(d.mean()) if d.size else 0.0,
            frac_truncated=float((d > rec.k).sum() / max(int(d.size), 1)),
        ))
    return out


def pairwise_sqdist(dst_x: torch.Tensor, src_x: torch.Tensor) -> torch.Tensor:
    """Squared distances (..., Nd, Ns) in the expanded form."""
    d2 = (
        torch.sum(dst_x * dst_x, dim=-1, keepdim=True)
        - 2.0 * dst_x @ src_x.transpose(-1, -2)
        + torch.sum(src_x * src_x, dim=-1)[..., None, :]
    )
    return torch.clamp(d2, min=0.0)


def radius_neighbors(
    src_x: torch.Tensor,
    dst_x: torch.Tensor,
    r: float,
    k: int,
    src_mask: Optional[torch.Tensor] = None,
    dst_mask: Optional[torch.Tensor] = None,
    exclude_diagonal: bool = False,
    exclude_src_idx: Optional[torch.Tensor] = None,
    exclude_src_owner: Optional[torch.Tensor] = None,
    tag: str = "",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """For each destination, the k nearest valid sources within ``r`` ->
    (idx (..., Nd, k) long, valid (..., Nd, k) bool); invalid slots point at
    source 0.  Leading axes of ``src_x`` (..., Ns, 3) and ``dst_x`` (...,
    Nd, 3) are batch axes; the ``exclude_*`` options take unbatched clouds.

    Tied or padded slots may come out in another order than ``lax.top_k``
    gives (``torch.topk`` is not stable on CUDA); the set of valid
    neighbours is the same."""
    ns, nd = src_x.shape[-2], dst_x.shape[-2]
    assert k <= ns, f"k={k} exceeds source count {ns}"
    d2 = pairwise_sqdist(dst_x, src_x)
    bad = d2 > r * r
    if src_mask is not None:
        bad |= ~src_mask[..., None, :]
    if exclude_src_idx is not None:
        bad |= torch.arange(ns, device=d2.device)[None, :] == exclude_src_idx[:, None]
    if exclude_src_owner is not None:
        bad |= exclude_src_owner[None, :] == torch.arange(nd, device=d2.device)[:, None]
    if exclude_diagonal:
        assert nd == ns, "exclude_diagonal requires a square graph"
        bad |= torch.eye(ns, dtype=torch.bool, device=d2.device)
    if _DEGREE_TAPE is not None:
        _DEGREE_TAPE.append(DegreeRecord(tag=tag, r=float(r), k=int(k),
                                         degree=torch.sum(~bad, dim=-1, dtype=torch.int32), dst_mask=dst_mask))
    score = torch.where(bad, torch.full_like(d2, float("inf")), d2)
    neg_top, idx = torch.topk(-score, k, dim=-1)
    valid = neg_top > -float("inf")
    if dst_mask is not None:
        valid &= dst_mask[..., None]
    idx = torch.where(valid, idx, torch.zeros_like(idx))
    return idx, valid


def radius_graph(x: torch.Tensor, r: float, k: int,
                 mask: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """The radius graph of one cloud on itself, without self-loops."""
    return radius_neighbors(x, x, r, k, src_mask=mask, dst_mask=mask, exclude_diagonal=True)


def dense_neighbors(
    n_src: int,
    n_dst: int,
    src_mask: Optional[torch.Tensor] = None,
    dst_mask: Optional[torch.Tensor] = None,
    device=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """All-pairs connectivity: idx (..., Nd, Ns), the leading axes those of
    the masks (``src_mask`` (..., Ns), ``dst_mask`` (..., Nd))."""
    valid = torch.ones((n_dst, n_src), dtype=torch.bool, device=device)
    if src_mask is not None:
        valid = valid & src_mask[..., None, :]
    if dst_mask is not None:
        valid = valid & dst_mask[..., None]
    idx = torch.arange(n_src, device=device).expand(valid.shape)
    return idx, valid


def farthest_point_sampling(
    x: torch.Tensor,
    n_samples: int,
    mask: Optional[torch.Tensor] = None,
    start_idx: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Iterative FPS -> (idx (n_samples,) long, valid (n_samples,) bool),
    seeded at ``start_idx`` (default: the first valid point).  If fewer than
    ``n_samples`` points are valid, surplus slots repeat chosen points with
    ``valid=False``.  ``argmax`` returns the first maximum, as
    ``jnp.argmax`` does.  Nothing is read on the host or copied to the
    device, so a CUDA graph can capture it."""
    n = x.shape[0]
    if mask is None:
        mask = torch.ones(n, dtype=torch.bool, device=x.device)
    inf = x.new_full((), float("inf"))
    mindist = torch.where(mask, inf, -inf)
    idx = torch.zeros(n_samples, dtype=torch.long, device=x.device)
    if start_idx is None:
        idx[0] = torch.argmax(mask.to(torch.int32))
    else:
        idx[0] = start_idx
    for i in range(1, n_samples):
        d2 = torch.sum(torch.square(x - x.index_select(0, idx[i - 1 : i])), dim=-1)
        mindist = torch.minimum(mindist, torch.where(mask, d2, -inf))
        idx[i] = torch.argmax(mindist)
    # the arange stops below n_samples, so this is arange < min(valid count, n_samples)
    valid = torch.arange(n_samples, device=x.device) < mask.sum()
    return idx, valid


def count_within_radius(
    src_x: torch.Tensor,
    dst_x: torch.Tensor,
    r: float,
    src_mask: Optional[torch.Tensor] = None,
    dst_mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """For each destination (Nd,), the number of valid sources within ``r``
    (0 for an invalid destination); the weights of contact-point sampling."""
    within = pairwise_sqdist(dst_x, src_x) <= r * r
    if src_mask is not None:
        within &= src_mask[None, :]
    if dst_mask is not None:
        within &= dst_mask[:, None]
    return torch.sum(within.to(torch.int32), dim=-1, dtype=torch.int32)
