"""Multiscale UNet point-cloud feature extractor (counterpart of the JAX
package's ``models/extractor.py::UnetFeatureExtractor``, deterministic FPS;
``alpha_drop`` / ``proj_drop``, per scale or one for all, act in ``train()``
mode).

Per scale n the down path FPS-pools the cloud (``M_n = ceil(ratio * M_{n-1})``
of the padded count), projects, runs a bipartite Equiformer block over the
fine -> coarse radius edges and ``n_layers - 1`` self layers; a mid block
runs on the coarsest scale; the up path walks back with self layers and
unpool blocks over reversed edges and ``(a + b) / sqrt(3)`` skips.
"""
from __future__ import annotations

import math
from typing import List, Optional, Sequence, Union

import torch
from torch import nn

from ..data import FeaturedPoints, GraphEdges
from ..geom.irreps import Irreps, multiply_irreps
from ..geom.sh import spherical_harmonics
from ..nn.blocks import EquiformerBlock, ProjectIfMismatch
from ..nn.layers import IrrepsLinear
from ..nn.radial import GaussianRadialBasisFiniteCutoff
from ..ops.neighbors import farthest_point_sampling, radius_neighbors

__all__ = ["UnetFeatureExtractor", "resolve_radii"]


def resolve_radii(radius: Sequence[Optional[float]], pool_ratio: Sequence[float]) -> List[float]:
    """None radii grow by 1/sqrt(pool_ratio) of the previous scale."""
    out = [float(radius[0])]
    for n, r in enumerate(radius[1:]):
        if r is None:
            out.append(out[-1] / math.sqrt(pool_ratio[n - 1] if n >= 1 else pool_ratio[0]))
        else:
            out.append(float(r))
    return out


def _per_scale(v, n_scales: int):
    if isinstance(v, (list, tuple)):
        assert len(v) == n_scales, (v, n_scales)
        return tuple(v)
    return (v,) * n_scales


def _edges(src: FeaturedPoints, dst: FeaturedPoints, r: float, k: int, irreps_sh: Irreps,
           exclude_src_idx=None, exclude_src_owner=None, exclude_diagonal: bool = False) -> GraphEdges:
    idx, mask = radius_neighbors(
        src.x, dst.x, r, k, src_mask=src.mask, dst_mask=dst.mask,
        exclude_src_idx=exclude_src_idx, exclude_src_owner=exclude_src_owner,
        exclude_diagonal=exclude_diagonal,
    )
    vec = src.x[idx] - dst.x[:, None, :]
    length = torch.sqrt(torch.clamp(torch.sum(torch.square(vec), dim=-1), min=1e-4))
    attr = spherical_harmonics(irreps_sh, vec, eps=1e-4)
    return GraphEdges(idx=idx, mask=mask, length=length, attr=attr)


class _ScaleLayer(nn.Module):
    """Radial basis + Equiformer block over a fixed edge structure."""

    def __init__(self, irreps_src, irreps_dst, irreps_sh, num_heads, fc_neurons, radius,
                 irreps_mlp_mid=3, drop=(0.1, 0.0), irreps_head=None):
        """``drop``: ``(alpha_drop, proj_drop)``."""
        super().__init__()
        self.radial = GaussianRadialBasisFiniteCutoff(num_basis=fc_neurons[0], cutoff=0.99 * radius)
        self.gnn = EquiformerBlock(
            irreps_src=irreps_src, irreps_dst=irreps_dst, irreps_edge_attr=irreps_sh,
            num_heads=num_heads, fc_neurons=tuple(fc_neurons), irreps_head=irreps_head,
            irreps_mlp_mid=irreps_mlp_mid, use_edge_logits=False, alpha_drop=drop[0], proj_drop=drop[1],
        )

    def forward(self, src: FeaturedPoints, dst: FeaturedPoints, edges: GraphEdges) -> FeaturedPoints:
        return self.gnn(src, dst, edges.replace(scalars=self.radial(edges.length)))


class _DownPath(nn.Module):
    def __init__(self, irreps_input, emb, irreps_edge_attr, num_heads, fc_neurons, n_layers,
                 pool_ratio, radii, k_pool, k_self, mlp_mid, drop):
        super().__init__()
        self.emb, self.sh = emb, [Irreps(i) for i in irreps_edge_attr]
        self.n_layers, self.pool_ratio, self.radii = n_layers, pool_ratio, radii
        self.k_pool, self.k_self = k_pool, k_self
        if irreps_input is not None:
            self.input_emb = IrrepsLinear(Irreps(irreps_input), emb[0])
        for n in range(len(emb)):
            prev = emb[max(n - 1, 0)]
            self.add_module(f"pool_proj_{n}", ProjectIfMismatch(prev, emb[n]))
            self.add_module(f"pool_layer_{n}", _ScaleLayer(
                prev, emb[n], self.sh[n], num_heads[n], fc_neurons[n], radii[n], mlp_mid[n], drop[n]))
            for i in range(n_layers[n] - 1):
                self.add_module(f"self_layer_{n}_{i}", _ScaleLayer(
                    emb[n], emb[n], self.sh[n], num_heads[n], fc_neurons[n], radii[n], mlp_mid[n], drop[n]))

    def forward(self, pcd: FeaturedPoints):
        f = self.input_emb(pcd.f) if hasattr(self, "input_emb") else pcd.f
        points = FeaturedPoints(x=pcd.x, f=f, mask=pcd.mask, w=pcd.w)
        stack = [points]
        scale_edges, pool_sources = [], []
        for n in range(len(self.emb)):
            src = points
            m = max(1, math.ceil(self.pool_ratio[n] * src.n))
            fps_idx, fps_valid = farthest_point_sampling(src.x, m, mask=src.mask)
            dst = FeaturedPoints(x=src.x[fps_idx], f=getattr(self, f"pool_proj_{n}")(src.f[fps_idx]),
                                 mask=fps_valid)
            pool_edges = _edges(src, dst, self.radii[n], min(self.k_pool[n], src.n), self.sh[n],
                                exclude_src_idx=fps_idx)
            pool_sources.append((src, fps_idx))
            points = getattr(self, f"pool_layer_{n}")(src, dst, pool_edges)
            stack.append(points)
            self_edges = _edges(points, points, self.radii[n], min(self.k_self[n], points.n), self.sh[n],
                                exclude_diagonal=True)
            for i in range(self.n_layers[n] - 1):
                points = getattr(self, f"self_layer_{n}_{i}")(points, points, self_edges)
                stack.append(points)
            scale_edges.append(self_edges)
        return points, stack, scale_edges, pool_sources


class UnetFeatureExtractor(nn.Module):
    """Full UNet with mid block and up path; returns one cloud per scale."""

    def __init__(
        self,
        irreps_input,
        irreps_output,
        irreps_emb: Sequence,
        irreps_edge_attr: Sequence,
        num_heads: Sequence[int],
        fc_neurons: Sequence[Sequence[int]],
        n_layers: Sequence[int],
        pool_ratio: Sequence[float],
        radius: Sequence[Optional[float]],
        n_layers_midstream: int = 2,
        k_pool: Sequence[int] = (24, 24, 24, 24),
        k_self: Sequence[int] = (32, 32, 32, 32),
        k_up: Sequence[int] = (12, 12, 12, 12),
        irreps_mlp_mid: Union[int, Sequence[int]] = 3,
        alpha_drop: Union[float, Sequence[float]] = 0.1,
        proj_drop: Union[float, Sequence[float]] = 0.0,
    ):
        super().__init__()
        n_scales = len(irreps_emb)
        emb = self.emb = [Irreps(i) for i in irreps_emb]
        sh = self.sh = [Irreps(i) for i in irreps_edge_attr]
        radii = self.radii = resolve_radii(radius, pool_ratio)
        mlp_mid = _per_scale(irreps_mlp_mid, n_scales)
        drop = list(zip(_per_scale(alpha_drop, n_scales), _per_scale(proj_drop, n_scales)))
        self.n_layers, self.n_layers_midstream, self.k_up = list(n_layers), n_layers_midstream, list(k_up)
        self.down = _DownPath(irreps_input, emb, irreps_edge_attr, num_heads, fc_neurons, n_layers,
                              pool_ratio, radii, k_pool, k_self, mlp_mid, drop)
        for i in range(n_layers_midstream):
            self.add_module(f"mid_layer_{i}", _ScaleLayer(
                emb[-1], emb[-1], sh[-1], num_heads[-1], fc_neurons[-1], radii[-1], mlp_mid[-1], drop[-1]))
        for n in range(n_scales - 1, -1, -1):
            for i in range(n_layers[n] - 1):
                self.add_module(f"up_self_layer_{n}_{i}", _ScaleLayer(
                    emb[n], emb[n], sh[n], num_heads[n], fc_neurons[n], radii[n], mlp_mid[n], drop[n]))
            if n > 0:
                self.add_module(f"unpool_layer_{n}", _ScaleLayer(
                    emb[n], emb[n - 1], sh[n], num_heads[n], fc_neurons[n], radii[n], mlp_mid[n], drop[n],
                    irreps_head=multiply_irreps(emb[n - 1], 1.0 / num_heads[n], strict=True)))
        for n in range(n_scales):
            self.add_module(f"project_out_{n}", ProjectIfMismatch(emb[n], Irreps(irreps_output)))

    def forward(self, pcd: FeaturedPoints) -> List[FeaturedPoints]:
        n_scales = len(self.emb)
        points, stack, scale_edges, pool_sources = self.down(pcd)
        inv_sqrt3 = 1.0 / math.sqrt(3.0)
        for i in range(self.n_layers_midstream):
            points = getattr(self, f"mid_layer_{i}")(points, points, scale_edges[-1])
        top = stack.pop()
        points = points.replace(f=(points.f + top.f) * inv_sqrt3)

        upstream: List[FeaturedPoints] = []
        for n in range(n_scales - 1, -1, -1):
            for i in range(self.n_layers[n] - 1):
                saved = stack.pop()
                dst = saved.replace(f=(points.f + saved.f) * inv_sqrt3)
                points = getattr(self, f"up_self_layer_{n}_{i}")(points, dst, scale_edges[n])
            upstream.append(points)
            saved = stack.pop()
            if n > 0:
                fine, fps_idx = pool_sources[n]
                # reversed pool edges coarse -> fine; the SH of the negated
                # vector is the parity-inverted SH of the down edges
                up_edges = _edges(points, fine, self.radii[n], min(self.k_up[n], points.n), self.sh[n],
                                  exclude_src_owner=fps_idx)
                dst = FeaturedPoints(x=fine.x, f=saved.f, mask=fine.mask, w=fine.w)
                points = getattr(self, f"unpool_layer_{n}")(points, dst, up_edges)
        upstream = upstream[::-1]
        return [
            FeaturedPoints(x=p.x, f=getattr(self, f"project_out_{n}")(p.f), mask=p.mask)
            for n, p in enumerate(upstream)
        ]
