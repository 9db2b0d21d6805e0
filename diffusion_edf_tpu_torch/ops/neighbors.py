"""Static-shape neighbourhoods: padded radius search, FPS and dense
bipartite connectivity (counterpart of the JAX package's
``ops/neighbors.py``).  Every neighbourhood is a padded ``(N_dst, K)`` index
array plus a validity mask."""
from __future__ import annotations

from typing import Optional, Tuple

import torch

__all__ = ["pairwise_sqdist", "radius_neighbors", "dense_neighbors", "farthest_point_sampling"]


def pairwise_sqdist(dst_x: torch.Tensor, src_x: torch.Tensor) -> torch.Tensor:
    """Squared distances (Nd, Ns) in the expanded form."""
    d2 = (
        torch.sum(dst_x * dst_x, dim=-1, keepdim=True)
        - 2.0 * dst_x @ src_x.T
        + torch.sum(src_x * src_x, dim=-1)[None, :]
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
) -> Tuple[torch.Tensor, torch.Tensor]:
    """For each destination, the k nearest valid sources within ``r`` ->
    (idx (Nd, k) long, valid (Nd, k) bool); invalid slots point at source 0.

    Tied or padded slots may come out in another order than ``lax.top_k``
    gives (``torch.topk`` is not stable on CUDA); the set of valid
    neighbours is the same."""
    ns, nd = src_x.shape[0], dst_x.shape[0]
    assert k <= ns, f"k={k} exceeds source count {ns}"
    d2 = pairwise_sqdist(dst_x, src_x)
    bad = d2 > r * r
    if src_mask is not None:
        bad |= ~src_mask[None, :]
    if exclude_src_idx is not None:
        bad |= torch.arange(ns, device=d2.device)[None, :] == exclude_src_idx[:, None]
    if exclude_src_owner is not None:
        bad |= exclude_src_owner[None, :] == torch.arange(nd, device=d2.device)[:, None]
    if exclude_diagonal:
        assert nd == ns, "exclude_diagonal requires a square graph"
        bad |= torch.eye(ns, dtype=torch.bool, device=d2.device)
    score = torch.where(bad, torch.full_like(d2, float("inf")), d2)
    neg_top, idx = torch.topk(-score, k, dim=-1)
    valid = neg_top > -float("inf")
    if dst_mask is not None:
        valid &= dst_mask[:, None]
    idx = torch.where(valid, idx, torch.zeros_like(idx))
    return idx, valid


def dense_neighbors(
    n_src: int,
    n_dst: int,
    src_mask: Optional[torch.Tensor] = None,
    dst_mask: Optional[torch.Tensor] = None,
    device=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """All-pairs connectivity: idx (Nd, Ns)."""
    idx = torch.arange(n_src, device=device)[None, :].expand(n_dst, n_src)
    valid = torch.ones((n_dst, n_src), dtype=torch.bool, device=device)
    if src_mask is not None:
        valid &= src_mask[None, :]
    if dst_mask is not None:
        valid &= dst_mask[:, None]
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
    ``jnp.argmax`` does."""
    n = x.shape[0]
    if mask is None:
        mask = torch.ones(n, dtype=torch.bool, device=x.device)
    start = torch.argmax(mask.to(torch.int32)) if start_idx is None else torch.as_tensor(start_idx)
    inf = torch.tensor(float("inf"), dtype=x.dtype, device=x.device)
    mindist = torch.where(mask, inf, -inf)
    idx = torch.zeros(n_samples, dtype=torch.long, device=x.device)
    idx[0] = start
    for i in range(1, n_samples):
        d2 = torch.sum(torch.square(x - x[idx[i - 1]]), dim=-1)
        mindist = torch.minimum(mindist, torch.where(mask, d2, -inf))
        idx[i] = torch.argmax(mindist)
    n_valid = int(mask.sum())
    valid = torch.arange(n_samples, device=x.device) < min(n_valid, n_samples)
    return idx, valid
