"""Query-side models (counterpart of the JAX package's ``models/keypoint.py``):
learned features and weights at fixed gripper coordinates
(``StaticKeypointModel``, the pick models), and the learned keypoint
extractor (``KeypointExtractor``, the place models' query and the sapien
models' key): a feature extractor (UNet or forward-only), FPS-selected query
points, and two tensor fields that give each query point its features and
its weight."""
from __future__ import annotations

import math
from typing import Dict, Optional, Sequence

import numpy as np
import torch
from torch import nn

from ..data import FeaturedPoints, stack_points
from ..geom.irreps import Irreps
from ..nn.radial import Dense, LayerNorm
from ..ops.neighbors import farthest_point_sampling
from .extractor import build_feature_extractor
from .tensor_field import MultiscaleTensorField

__all__ = ["StaticKeypointModel", "KeypointExtractor"]


class StaticKeypointModel(nn.Module):
    def __init__(self, keypoint_coords: Sequence[Sequence[float]], irreps_output):
        super().__init__()
        coords = np.asarray(keypoint_coords, dtype=np.float32)
        n = coords.shape[0]
        self.register_buffer("coords", torch.as_tensor(coords), persistent=False)
        self.keypoint_features = nn.Parameter(torch.empty(n, Irreps(irreps_output).dim))
        self.keypoint_weights = nn.Parameter(torch.empty(n))

    def forward(self, input_points: FeaturedPoints) -> FeaturedPoints:
        n = self.coords.shape[0]
        return FeaturedPoints(
            x=self.coords.to(input_points.x.dtype),
            f=self.keypoint_features.to(input_points.f.dtype),
            mask=torch.ones(n, dtype=torch.bool, device=self.coords.device),
            w=torch.sigmoid(self.keypoint_weights).to(input_points.x.dtype),
        )


class KeypointExtractor(nn.Module):
    """``m = max(1, ceil(pool_ratio * N))`` query points by FPS over the
    input cloud's points inside the optional ``bbox`` (a mask update, so the
    shapes stay static), deterministic FPS only (seeded at the first valid
    point; the random start is a training option).  ``tensor_field`` gives
    their features; ``weight_field`` an embedding that a LayerNorm (flax's:
    eps 1e-6, fast variance), silu and a Dense(1) turn into a weight, by
    ``sigmoid`` or a softmax over the valid points, optionally scaled by
    ``softplus(weight_mult_logit)``, and 0 where the mask drops the point."""

    def __init__(
        self,
        feature_extractor_kwargs: Dict,
        tensor_field_kwargs: Dict,
        keypoint_kwargs: Dict,
        feature_extractor_name: str = "UnetFeatureExtractor",
        weight_activation: str = "sigmoid",
        weight_mult: Optional[float] = None,
    ):
        super().__init__()
        assert weight_activation in ("sigmoid", "softmax"), weight_activation
        self.weight_activation = weight_activation
        self.pool_ratio = float(keypoint_kwargs["pool_ratio"])
        bbox = keypoint_kwargs.get("bbox")
        # (3, 2), a buffer so that it moves with the model and no call copies it to the device
        self.register_buffer("bbox", None if bbox is None else torch.as_tensor(np.asarray(bbox, dtype=np.float32)),
                             persistent=False)
        self.feature_extractor = build_feature_extractor(feature_extractor_name, feature_extractor_kwargs)
        tf = dict(tensor_field_kwargs, irreps_input=feature_extractor_kwargs["irreps_output"],
                  irreps_query=None, edge_context_emb_dim=None)
        self.out_dim = Irreps(tf["irreps_output"]).dim
        emb_dim = keypoint_kwargs.get("weight_pre_emb_dim") or Irreps(feature_extractor_kwargs["irreps_output"]).mul_0
        self.tensor_field = MultiscaleTensorField(**tf)
        self.weight_field = MultiscaleTensorField(**dict(tf, irreps_output=f"{emb_dim}x0e"))
        self.weight_ln = LayerNorm(emb_dim)
        self.weight_dense = Dense(emb_dim, 1)
        if weight_mult is not None:
            self.weight_mult_logit = nn.Parameter(
                torch.tensor(math.log(math.exp(float(weight_mult)) - 1.0)))

    def init_query_points(self, src_points: FeaturedPoints) -> FeaturedPoints:
        mask = src_points.mask
        if self.bbox is not None:
            b = self.bbox
            mask = mask & torch.all((src_points.x >= b[:, 0]) & (src_points.x <= b[:, 1]), dim=-1)
        m = max(1, math.ceil(self.pool_ratio * src_points.n))
        idx, valid = farthest_point_sampling(src_points.x, m, mask=mask)
        return FeaturedPoints(x=src_points.x[idx], f=src_points.f.new_zeros(m, self.out_dim), mask=valid)

    def forward(self, input_points: FeaturedPoints) -> FeaturedPoints:
        feats = [stack_points([p]) for p in self.feature_extractor(input_points)]
        query = self.init_query_points(input_points)
        query_1 = stack_points([query])
        out = self.tensor_field(query_1, feats)
        h = self.weight_ln(self.weight_field(query_1, feats).f)
        w = self.weight_dense(torch.nn.functional.silu(h)).squeeze(-1)
        if self.weight_activation == "sigmoid":
            w = torch.sigmoid(w)
        else:
            w = torch.softmax(torch.where(query.mask, w, torch.full_like(w, -float("inf"))), dim=-1)
        if hasattr(self, "weight_mult_logit"):
            w = w * torch.nn.functional.softplus(self.weight_mult_logit)
        w = torch.where(query.mask, w, torch.zeros_like(w))
        return FeaturedPoints(x=out.x, f=out.f, mask=out.mask, w=w)
