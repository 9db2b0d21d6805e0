"""Query-side model: learned features and weights at fixed gripper
coordinates (counterpart of the JAX package's
``models/keypoint.py::StaticKeypointModel``)."""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
from torch import nn

from ..data import FeaturedPoints
from ..geom.irreps import Irreps

__all__ = ["StaticKeypointModel"]


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
