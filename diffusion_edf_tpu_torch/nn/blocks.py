"""Equiformer blocks over padded neighbourhoods (counterpart of the JAX
package's ``nn/blocks.py``).  Dropout (``alpha_drop`` on the attention
weights, ``proj_drop`` on whole irreps of the attention and feed-forward
outputs) acts in ``train()`` mode only.  With ``scene_axis_name`` the source
cloud is sharded over that mesh axis (``nn/attention.py``): the destination
features enter each rank's messages through ``copy_to_shards``, so their
gradient sums every rank's share."""
from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from ..data import FeaturedPoints, GraphEdges
from ..geom.irreps import Irreps, sort_irreps_even_first
from ..parallel.mesh import copy_to_shards, current_mesh
from .attention import GraphAttention
from .layers import EquivariantDropout, EquivariantLayerNorm, GateFromIrreps, IrrepsLinear, irreps2gate, scalar_silu
from .tp import im_perm

__all__ = ["FeedForwardNetwork", "EquiformerBlock", "ProjectIfMismatch", "resolve_mlp_mid"]


def resolve_mlp_mid(irreps_emb, irreps_mlp_mid) -> Irreps:
    """int multiplier -> ``sort_even_first(emb * k).simplify()``."""
    if isinstance(irreps_mlp_mid, int):
        rep = Irreps(tuple(Irreps(irreps_emb)) * irreps_mlp_mid)
        s, _, _ = sort_irreps_even_first(rep)
        return s.simplify()
    return Irreps(irreps_mlp_mid)


class ProjectIfMismatch(nn.Module):
    def __init__(self, irreps_in, irreps_out, use_bias: bool = True, layernorm: bool = True):
        super().__init__()
        self.identity = Irreps(irreps_in) == Irreps(irreps_out)
        if not self.identity:
            if layernorm:
                self.ln = EquivariantLayerNorm(irreps_in)
            self.lin = IrrepsLinear(irreps_in, irreps_out, use_bias=use_bias)

    def forward(self, f: torch.Tensor) -> torch.Tensor:
        if self.identity:
            return f
        if hasattr(self, "ln"):
            f = self.ln(f)
        return self.lin(f)


class FeedForwardNetwork(nn.Module):
    def __init__(self, irreps_in, irreps_out, irreps_mlp_mid=None, proj_drop: float = 0.0):
        super().__init__()
        irreps_in = Irreps(irreps_in)
        mid = Irreps(irreps_mlp_mid) if irreps_mlp_mid is not None else irreps_in
        s, g, t = irreps2gate(mid)
        self.fctp1 = IrrepsLinear(irreps_in, mid if g.dim == 0 else (s + g + t).simplify())
        self.gate = GateFromIrreps(mid) if g.dim else None
        self.fctp2 = IrrepsLinear(mid, Irreps(irreps_out))
        if proj_drop > 0.0:
            self.proj_drop = EquivariantDropout(irreps_out, proj_drop)

    def forward(self, f: torch.Tensor) -> torch.Tensor:
        h = self.fctp1(f)
        h = scalar_silu(h) if self.gate is None else self.gate(h)
        h = self.fctp2(h)
        return self.proj_drop(h) if hasattr(self, "proj_drop") else h


class EquiformerBlock(nn.Module):
    """Pre-norm bipartite graph-attention block:
    ``linear_src(norm(src_f))[idx] + linear_dst(norm(dst_f))[:, None]`` ->
    GraphAttention -> +skip(dst) -> post-norm -> FFN -> +skip.  Both message
    linears emit i-major lanes, which the attention DTP reads contiguously."""

    def __init__(
        self,
        irreps_src,
        irreps_dst,
        irreps_edge_attr,
        num_heads: int,
        fc_neurons: Sequence[int],
        irreps_emb=None,
        irreps_output=None,
        irreps_head=None,
        irreps_mlp_mid=3,
        use_dst_feature: bool = True,
        skip_connection: bool = True,
        use_src_point_attn: bool = False,
        use_edge_logits: bool = True,
        alpha_drop: float = 0.1,
        proj_drop: float = 0.0,
        scene_axis_name: Optional[str] = None,
    ):
        super().__init__()
        self.scene_axis_name = scene_axis_name
        irreps_src, irreps_dst = Irreps(irreps_src), Irreps(irreps_dst)
        irreps_emb = Irreps(irreps_emb) if irreps_emb is not None else irreps_dst
        irreps_out = Irreps(irreps_output) if irreps_output is not None else irreps_dst
        self.use_dst_feature, self.skip_connection = use_dst_feature, skip_connection
        self.use_src_point_attn, self.use_edge_logits = use_src_point_attn, use_edge_logits
        msg_perm = im_perm(irreps_emb)
        self.prenorm_src = EquivariantLayerNorm(irreps_src)
        self.linear_src = IrrepsLinear(irreps_src, irreps_emb, use_bias=not use_dst_feature, output_perm=msg_perm)
        if use_dst_feature:
            self.prenorm_dst = EquivariantLayerNorm(irreps_dst)
            self.linear_dst = IrrepsLinear(irreps_dst, irreps_emb, use_bias=True, output_perm=msg_perm)
        self.ga = GraphAttention(
            irreps_input=irreps_emb,
            irreps_edge_attr=Irreps(irreps_edge_attr),
            irreps_output=irreps_emb,
            fc_neurons=tuple(fc_neurons),
            num_heads=num_heads,
            irreps_head=irreps_head,
            alpha_drop=alpha_drop,
            proj_drop=proj_drop,
            scene_axis_name=scene_axis_name,
        )
        if skip_connection and use_dst_feature:
            self.skip_1 = ProjectIfMismatch(irreps_dst, irreps_emb, layernorm=False)
        self.post_norm = EquivariantLayerNorm(irreps_emb)
        self.ffn = FeedForwardNetwork(irreps_emb, irreps_out, resolve_mlp_mid(irreps_emb, irreps_mlp_mid), proj_drop)
        if skip_connection:
            self.skip_2 = ProjectIfMismatch(irreps_emb, irreps_out, layernorm=False)

    def forward(self, src: FeaturedPoints, dst: FeaturedPoints, edges: GraphEdges) -> FeaturedPoints:
        # (Nd, K, F_emb) i-major; index_select, whose backward is an index_add
        # (advanced indexing's sorts its indices on CUDA)
        msg_src = self.linear_src(self.prenorm_src(src.f))
        message = torch.index_select(msg_src, 0, edges.idx.reshape(-1)).reshape(*edges.idx.shape, -1)
        if self.use_dst_feature:
            msg_dst = self.linear_dst(self.prenorm_dst(dst.f))
            if self.scene_axis_name:
                msg_dst = copy_to_shards(msg_dst, current_mesh().group(self.scene_axis_name))
            message = message + msg_dst[:, None, :]
        post_attn = None
        if self.use_src_point_attn:
            assert src.w is not None
            post_attn = src.w[edges.idx]
        emb = self.ga(
            message, edges.attr, edges.scalars, edges.mask,
            edge_pre_attn_logit=edges.logits if self.use_edge_logits else None,
            edge_post_attn=post_attn,
        )
        if self.skip_connection and self.use_dst_feature:
            emb = emb + self.skip_1(dst.f)
        out = self.ffn(self.post_norm(emb))
        if self.skip_connection:
            out = out + self.skip_2(emb)
        # zero the features of padded dst points
        out = torch.where(dst.mask[:, None], out, torch.zeros_like(out))
        return FeaturedPoints(x=dst.x, f=out, mask=dst.mask, w=dst.w)
