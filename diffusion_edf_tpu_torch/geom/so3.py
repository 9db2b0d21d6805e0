"""Quaternion / SE(3) algebra in PyTorch (the subset the sampler uses).

Quaternions are ``(w, x, y, z)`` with real part first; poses are 7-vectors
``(qw, qx, qy, qz, x, y, z)``.  Every function broadcasts over leading batch
dims and keeps the input dtype.
"""
from __future__ import annotations

import torch

__all__ = [
    "quaternion_invert",
    "quaternion_apply",
    "normalize_quaternion",
    "quaternion_to_matrix",
    "transform_points",
]


def quaternion_invert(q: torch.Tensor) -> torch.Tensor:
    """Conjugate (assumes a unit quaternion)."""
    return torch.cat([q[..., :1], -q[..., 1:]], dim=-1)


def quaternion_apply(q: torch.Tensor, point: torch.Tensor) -> torch.Tensor:
    """Rotate ``point`` (..., 3) by unit quaternion ``q`` (..., 4), expanded
    Rodrigues form."""
    w = q[..., :1]
    v = q[..., 1:]
    v, point = torch.broadcast_tensors(v, point)
    t = 2.0 * torch.linalg.cross(v, point, dim=-1)
    return point + w * t + torch.linalg.cross(v, t, dim=-1)


def normalize_quaternion(q: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    return q / torch.sqrt(torch.sum(q * q, dim=-1, keepdim=True) + eps)


def quaternion_to_matrix(q: torch.Tensor) -> torch.Tensor:
    """Unit quaternion -> rotation matrix (..., 3, 3)."""
    w, x, y, z = q.unbind(-1)
    m = torch.stack(
        [
            1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
            2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
            2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y),
        ],
        dim=-1,
    )
    return m.reshape(*q.shape[:-1], 3, 3)


def transform_points(points: torch.Tensor, Ts: torch.Tensor) -> torch.Tensor:
    """Apply poses ``Ts`` (nT, 7) to points (nP, 3) -> (nT, nP, 3)."""
    q = Ts[..., None, :4]
    t = Ts[..., None, 4:]
    return quaternion_apply(q, points) + t
