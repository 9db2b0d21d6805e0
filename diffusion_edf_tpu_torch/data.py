"""Padded point clouds and padded neighbourhoods (counterpart of the JAX
package's ``data.py``): every container carries a boolean validity ``mask``
instead of ragged lengths, and edges are ``(N_dst, K)`` neighbour slots.
Clouds of several requests are stacked on a leading axis (:func:`stack_points`:
``x`` (R, N, 3)); ``n`` is the number of points of one cloud either way."""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import torch

__all__ = ["FeaturedPoints", "GraphEdges", "concat_edges", "stack_points"]


@dataclasses.dataclass
class FeaturedPoints:
    x: torch.Tensor  # ([R,] N, 3) positions
    f: torch.Tensor  # ([R,] N, F) irreps features
    mask: torch.Tensor  # ([R,] N) bool validity
    w: Optional[torch.Tensor] = None  # ([R,] N) optional point weights

    @property
    def n(self) -> int:
        return self.x.shape[-2]

    def replace(self, **kw) -> "FeaturedPoints":
        return dataclasses.replace(self, **kw)


def stack_points(points: Sequence[FeaturedPoints]) -> FeaturedPoints:
    """Clouds of the same size stacked on a new leading (request) axis."""
    ws = [p.w for p in points]
    return FeaturedPoints(
        x=torch.stack([p.x for p in points]),
        f=torch.stack([p.f for p in points]),
        mask=torch.stack([p.mask for p in points]),
        w=None if any(w is None for w in ws) else torch.stack(ws),
    )


@dataclasses.dataclass
class GraphEdges:
    """``idx[i, k]`` is the source index of dst ``i``'s k-th slot (into the
    concatenated source cloud for multiscale edge sets)."""

    idx: torch.Tensor  # (Nd, K) long
    mask: torch.Tensor  # (Nd, K) bool
    length: Optional[torch.Tensor] = None  # (Nd, K)
    attr: Optional[torch.Tensor] = None  # (Nd, K, sh_dim)
    scalars: Optional[torch.Tensor] = None  # (Nd, K, S)
    logits: Optional[torch.Tensor] = None  # (Nd, K) log edge cutoff (pre-attention)
    weights: Optional[torch.Tensor] = None  # (Nd, K) edge cutoff weights

    @property
    def k(self) -> int:
        return self.idx.shape[-1]

    def replace(self, **kw) -> "GraphEdges":
        return dataclasses.replace(self, **kw)


def _cat(a: Optional[torch.Tensor], b: Optional[torch.Tensor]):
    if a is None or b is None:
        assert a is None and b is None
        return None
    return torch.cat([a, b], dim=1)


def concat_edges(e1: GraphEdges, e2: GraphEdges) -> GraphEdges:
    """Concatenate two edge sets of the same destination cloud over K."""
    return GraphEdges(
        idx=torch.cat([e1.idx, e2.idx], dim=1),
        mask=torch.cat([e1.mask, e2.mask], dim=1),
        length=_cat(e1.length, e2.length),
        attr=_cat(e1.attr, e2.attr),
        scalars=_cat(e1.scalars, e2.scalars),
        logits=_cat(e1.logits, e2.logits),
        weights=_cat(e1.weights, e2.weights),
    )
