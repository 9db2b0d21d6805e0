"""Multiscale equivariant tensor field: query points attend jointly over all
scales of a multiscale key cloud (counterpart of the JAX package's
``models/tensor_field.py``).

Per scale n: an edge encoder (finite radius, or dense for a ``null``
radius), the length (+ per-scale context) embedding and a pre-linear; the
scales are concatenated along the neighbour-slot axis and Equiformer blocks
attend over the union.  The clouds come stacked over requests, so one call
serves the query points of several requests (``agent.sample_batch``).
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import torch
from torch import nn

from ..data import FeaturedPoints, GraphEdges, concat_edges
from ..geom.irreps import Irreps
from ..nn.blocks import EquiformerBlock
from ..nn.radial import Dense
from .edge import InfiniteEdgeEncoder, RadiusEdgeEncoder

__all__ = ["MultiscaleTensorField"]


class MultiscaleTensorField(nn.Module):
    def __init__(
        self,
        irreps_input,
        irreps_output,
        irreps_sh,
        num_heads: int,
        fc_neurons: Sequence[int],
        length_emb_dim: int,
        irreps_query,
        r_cluster_multiscale: Sequence[Optional[float]],
        k_multiscale: Sequence[int],
        edge_context_emb_dim: Optional[int] = None,
        r_mincut_nonscalar_sh: Optional[float] = None,
        length_enc_max_r: Optional[float] = None,
        n_layers: int = 1,
        irreps_mlp_mid=3,
        use_src_point_attn: bool = False,
        cutoff_method: str = "edge_attn",
        alpha_drop: float = 0.1,
        proj_drop: float = 0.0,
    ):
        super().__init__()
        self.n_scales = len(r_cluster_multiscale)
        self.k_multiscale = list(k_multiscale)
        self.edge_context_emb_dim = edge_context_emb_dim
        fc_neurons = list(fc_neurons)
        expect_fc0 = length_emb_dim + (edge_context_emb_dim or 0)
        if fc_neurons[0] == -1:
            fc_neurons[0] = expect_fc0
        assert fc_neurons[0] == expect_fc0, (fc_neurons[0], expect_fc0)
        if cutoff_method == "edge_attn":
            use_edge_weights, sh_cutoff = True, False
        elif cutoff_method == "sh":
            use_edge_weights, sh_cutoff = False, True
        else:
            raise ValueError(cutoff_method)
        self.use_edge_weights = use_edge_weights
        r_mincut = r_mincut_nonscalar_sh
        if r_mincut is None:
            r_mincut = 0.01 * float(r_cluster_multiscale[0])
        ctx_dim = edge_context_emb_dim or 0
        fill_edge_weights = False
        for n, r in enumerate(r_cluster_multiscale):
            if r is None:
                enc = InfiniteEdgeEncoder(irreps_sh, length_emb_dim, length_enc_max_r, r_mincut,
                                          sh_cutoff, fill_edge_weights)
            else:
                enc = RadiusEdgeEncoder(float(r), k_multiscale[n], irreps_sh,
                                        length_emb_dim, r_mincut, sh_cutoff, tag=f"radius_edge/parser_{n}")
                if use_edge_weights:
                    fill_edge_weights = True
            self.add_module(f"parser_{n}", enc)
            self.add_module(f"pre_linear_{n}", Dense(length_emb_dim + ctx_dim, fc_neurons[0]))
        use_dst = irreps_query is not None
        irreps_in, irreps_out = Irreps(irreps_input), Irreps(irreps_output)
        common = dict(
            irreps_src=irreps_in, irreps_emb=irreps_in, irreps_edge_attr=Irreps(irreps_sh),
            num_heads=num_heads, fc_neurons=tuple(fc_neurons), irreps_mlp_mid=irreps_mlp_mid,
            use_src_point_attn=use_src_point_attn, use_edge_logits=use_edge_weights,
            alpha_drop=alpha_drop, proj_drop=proj_drop,
        )
        self.gnn_block_init = EquiformerBlock(
            irreps_dst=Irreps(irreps_query) if use_dst else irreps_in,
            irreps_output=irreps_out if n_layers == 1 else irreps_in,
            use_dst_feature=use_dst, **common,
        )
        self.n_layers = n_layers
        for i in range(n_layers - 1):
            self.add_module(f"gnn_block_{i}", EquiformerBlock(
                irreps_dst=irreps_in, irreps_output=irreps_out if i == n_layers - 2 else irreps_in,
                use_dst_feature=True, **common,
            ))

    def forward(self, query_points: FeaturedPoints, input_points_multiscale: List[FeaturedPoints],
                context_emb: Optional[List[torch.Tensor]] = None) -> FeaturedPoints:
        """``query_points`` and every scale of ``input_points_multiscale``
        stacked over R requests (``x`` (R, N, 3)); ``context_emb`` per scale
        (R * Nd, C).  Each query point attends to its own request's key
        points.  Returns the R * Nd query points flat, request after request."""
        assert len(input_points_multiscale) == self.n_scales
        assert (context_emb is not None) == (self.edge_context_emb_dim is not None)
        r = query_points.x.shape[0]
        edge_query = query_points
        all_edges: Optional[GraphEdges] = None
        n_total = 0
        for n, pts in enumerate(input_points_multiscale):
            edges = getattr(self, f"parser_{n}")(pts, edge_query)
            scalars = edges.scalars
            if context_emb is not None:
                ctx = context_emb[n]
                scalars = torch.cat([scalars, ctx[:, None, :].expand(*scalars.shape[:-1], ctx.shape[-1])], dim=-1)
            scalars = torch.nn.functional.silu(getattr(self, f"pre_linear_{n}")(scalars))
            if not self.use_edge_weights:
                edges = edges.replace(logits=torch.zeros_like(edges.mask, dtype=scalars.dtype), weights=None)
            edges = edges.replace(scalars=scalars, idx=edges.idx + n_total)
            n_total += r * pts.n
            all_edges = edges if all_edges is None else concat_edges(all_edges, edges)
        flat_src = _flat_points(input_points_multiscale)
        out = self.gnn_block_init(flat_src, _flat_points([query_points]), all_edges)
        for i in range(self.n_layers - 1):
            out = getattr(self, f"gnn_block_{i}")(flat_src, out, all_edges)
        return out


def _flat_points(clouds: List[FeaturedPoints]) -> FeaturedPoints:
    """Stacked clouds laid end to end: scale after scale, request after request."""
    ws = [p.w for p in clouds]
    return FeaturedPoints(
        x=torch.cat([p.x.reshape(-1, 3) for p in clouds]),
        f=torch.cat([p.f.reshape(p.mask.numel(), p.f.shape[-1]) for p in clouds]),
        mask=torch.cat([p.mask.reshape(-1) for p in clouds]),
        w=None if any(w is None for w in ws) else torch.cat([w.reshape(-1) for w in ws]),
    )
