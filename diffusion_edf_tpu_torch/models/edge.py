"""Edge construction and encoding over padded neighbourhoods (counterpart of
the JAX package's ``models/edge.py``).  Coordinates are in centimetres: the
1e-4 squared-length floors are 0.01 cm, below the 1 cm voxel pitch.

The encoders take clouds stacked over R requests (``x`` (R, N, 3)): each
destination's neighbours come from its own request's sources, and the edges
come back flat, ``(R * Nd, K)`` rows whose indices point into the R * Ns
sources laid end to end, request after request."""
from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from ..data import FeaturedPoints, GraphEdges
from ..geom.irreps import Irreps
from ..geom.sh import spherical_harmonics
from ..nn.radial import GaussianRadialBasis, SinusoidalPositionEmbeddings, soft_square_cutoff_2
from ..ops.neighbors import dense_neighbors, radius_neighbors

__all__ = ["RadiusEdgeEncoder", "InfiniteEdgeEncoder", "cutoff_sh", "st_clamp_min"]


def st_clamp_min(x: torch.Tensor, eps: float) -> torch.Tensor:
    """``max(x, eps)`` forward with the identity as its gradient (straight
    through)."""
    return x + (torch.clamp(x, min=eps) - x).detach()


def cutoff_sh(irreps_sh: Irreps, sh: torch.Tensor, edge_cutoff: Optional[torch.Tensor],
              cutoff_nonscalar: Optional[torch.Tensor]) -> torch.Tensor:
    """Per-degree cutoff multiplication of edge SH."""
    if edge_cutoff is None and cutoff_nonscalar is None:
        return sh
    pieces = []
    i = 0
    for mul, ir in Irreps(irreps_sh):
        d = mul * ir.dim
        blk = sh[..., i : i + d]
        if ir.l != 0 and cutoff_nonscalar is not None:
            blk = blk * cutoff_nonscalar[..., None]
        pieces.append(blk)
        i += d
    out = torch.cat(pieces, dim=-1)
    if edge_cutoff is not None:
        out = out * edge_cutoff[..., None]
    return out


class _EncoderCore(nn.Module):
    """Length / SH / cutoff encoding of given (idx, mask)."""

    def __init__(self, irreps_sh, edge_cutoff_ranges, nonscalar_ranges, sh_cutoff: bool,
                 fill_edge_weights: Optional[float], cutoff_eps: float = 1e-12, log_eps: float = 1e-6):
        super().__init__()
        self.irreps_sh = Irreps(irreps_sh) if irreps_sh is not None else None
        self.edge_cutoff_ranges, self.nonscalar_ranges = edge_cutoff_ranges, nonscalar_ranges
        self.sh_cutoff, self.fill_edge_weights = sh_cutoff, fill_edge_weights
        self.cutoff_eps, self.log_eps = cutoff_eps, log_eps

    def forward(self, src_x, dst_x, idx, mask, length_enc: Optional[nn.Module]) -> GraphEdges:
        vec = src_x[idx] - dst_x[:, None, :]
        length = torch.sqrt(torch.clamp(torch.sum(torch.square(vec), dim=-1), min=1e-4))
        edge_cutoff = log_cutoff = None
        if self.edge_cutoff_ranges is not None:
            edge_cutoff = soft_square_cutoff_2(length, self.edge_cutoff_ranges)
            # log(c + eps) as the pre-attention logit (bounded derivatives)
            log_cutoff = torch.log(edge_cutoff + self.log_eps)
            edge_cutoff = st_clamp_min(edge_cutoff, self.cutoff_eps)
        elif self.fill_edge_weights is not None:
            edge_cutoff = torch.full_like(length, self.fill_edge_weights)
            log_cutoff = torch.full_like(length, math.log(self.fill_edge_weights))
        cutoff_nonscalar = (
            soft_square_cutoff_2(length, self.nonscalar_ranges) if self.nonscalar_ranges is not None else None
        )
        scalars = length_enc(length) if length_enc is not None else None
        attr = None
        if self.irreps_sh is not None:
            attr = spherical_harmonics(self.irreps_sh, vec, eps=1e-4)
            attr = cutoff_sh(self.irreps_sh, attr, edge_cutoff if self.sh_cutoff else None, cutoff_nonscalar)
        return GraphEdges(idx=idx, mask=mask, length=length, attr=attr, scalars=scalars,
                          logits=log_cutoff, weights=edge_cutoff)


def _flat(src: FeaturedPoints, dst: FeaturedPoints, idx: torch.Tensor, mask: torch.Tensor):
    """Request-local neighbourhoods ``(R, Nd, K)`` -> flat source and
    destination positions and ``(R * Nd, K)`` indices into the flat sources."""
    r, ns = src.x.shape[:2]
    idx = idx + (torch.arange(r, device=idx.device) * ns)[:, None, None]
    k = idx.shape[-1]
    return src.x.reshape(-1, 3), dst.x.reshape(-1, 3), idx.reshape(-1, k), mask.reshape(-1, k)


def _nonscalar_ranges(r_mincut: Optional[float]):
    return (0.2 * r_mincut, 1.0 * r_mincut, None, None) if r_mincut is not None else None


class RadiusEdgeEncoder(nn.Module):
    """Fixed-radius bipartite edges (nearest ``min(k, n_src)`` within
    ``r_cutoff``) with a Gaussian length encoding."""

    def __init__(self, r_cutoff: float, k: int, irreps_sh, length_enc_dim: Optional[int],
                 r_mincut_nonscalar_sh: Optional[float] = None, sh_cutoff: bool = False):
        super().__init__()
        self.r_cutoff, self.k = float(r_cutoff), k
        if length_enc_dim is not None:
            self.length_enc = GaussianRadialBasis(dim=length_enc_dim, max_val=self.r_cutoff)
        self.core = _EncoderCore(
            irreps_sh, (None, None, 0.8 * self.r_cutoff, 1.0 * self.r_cutoff),
            _nonscalar_ranges(r_mincut_nonscalar_sh), sh_cutoff, None,
        )

    def forward(self, src: FeaturedPoints, dst: FeaturedPoints) -> GraphEdges:
        idx, mask = radius_neighbors(src.x, dst.x, self.r_cutoff, min(self.k, src.n), src_mask=src.mask, dst_mask=dst.mask)
        return self.core(*_flat(src, dst, idx, mask), getattr(self, "length_enc", None))


class InfiniteEdgeEncoder(nn.Module):
    """Dense bipartite edges (the ``null``-radius global scale) with a
    sinusoidal length encoding."""

    def __init__(self, irreps_sh, length_enc_dim: Optional[int], length_enc_max_r: Optional[float] = None,
                 r_mincut_nonscalar_sh: Optional[float] = None, sh_cutoff: bool = False,
                 fill_edge_weights: bool = False):
        super().__init__()
        if length_enc_dim is not None:
            assert length_enc_max_r is not None
            self.length_enc = SinusoidalPositionEmbeddings(length_enc_dim, float(length_enc_max_r), n=1000.0)
        self.core = _EncoderCore(
            irreps_sh, None, _nonscalar_ranges(r_mincut_nonscalar_sh), sh_cutoff,
            1.0 if fill_edge_weights else None,
        )

    def forward(self, src: FeaturedPoints, dst: FeaturedPoints) -> GraphEdges:
        idx, mask = dense_neighbors(src.n, dst.n, src_mask=src.mask, dst_mask=dst.mask, device=src.x.device)
        return self.core(*_flat(src, dst, idx, mask), getattr(self, "length_enc", None))
