"""Quaternion / SE(3) algebra in PyTorch (counterpart of the JAX package's
``geom/so3.py``).

Quaternions are ``(w, x, y, z)`` with real part first; poses are 7-vectors
``(qw, qx, qy, qz, x, y, z)``.  Every function broadcasts over leading batch
dims and keeps the input dtype; none branches on data.
"""
from __future__ import annotations

from typing import Optional

import torch

__all__ = [
    "quaternion_raw_multiply",
    "quaternion_multiply",
    "quaternion_invert",
    "quaternion_apply",
    "normalize_quaternion",
    "standardize_quaternion",
    "axis_angle_to_quaternion",
    "quaternion_to_matrix",
    "matrix_to_quaternion",
    "random_quaternions",
    "multiply_se3",
    "se3_invert",
    "transform_points",
    "se3_from_quat_trans",
    "se3_exp_map",
    "se3_log_map",
    "quaternion_to_axis_angle",
]


def _cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    a, b = torch.broadcast_tensors(a, b)
    return torch.linalg.cross(a, b, dim=-1)


def _norm(x: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(torch.sum(x * x, dim=-1, keepdim=True))


def quaternion_raw_multiply(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Hamilton product (no normalization)."""
    aw, ax, ay, az = a.unbind(-1)
    bw, bx, by, bz = b.unbind(-1)
    ow = aw * bw - ax * bx - ay * by - az * bz
    ox = aw * bx + ax * bw + ay * bz - az * by
    oy = aw * by - ax * bz + ay * bw + az * bx
    oz = aw * bz + ax * by - ay * bx + az * bw
    return torch.stack([ow, ox, oy, oz], dim=-1)


def standardize_quaternion(q: torch.Tensor) -> torch.Tensor:
    """Make the real part non-negative."""
    return torch.where(q[..., :1] < 0, -q, q)


def quaternion_multiply(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return standardize_quaternion(quaternion_raw_multiply(a, b))


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


def axis_angle_to_quaternion(axis_angle: torch.Tensor) -> torch.Tensor:
    """Rotation vector -> quaternion, with a series below 1e-6 rad."""
    angle = _norm(axis_angle)
    half = 0.5 * angle
    small = angle < 1e-6
    sin_half_over_angle = torch.where(
        small, 0.5 - (angle * angle) / 48.0, torch.sin(half) / torch.where(small, torch.ones_like(angle), angle)
    )
    return torch.cat([torch.cos(half), axis_angle * sin_half_over_angle], dim=-1)


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


def matrix_to_quaternion(m: torch.Tensor) -> torch.Tensor:
    """Rotation matrix -> unit quaternion, from the largest of the four
    candidates that the diagonal gives (no branch on data)."""
    m00, m11, m22 = m[..., 0, 0], m[..., 1, 1], m[..., 2, 2]
    tr = m00 + m11 + m22
    qw2 = torch.clamp(1.0 + tr, min=0.0) / 4.0
    qx2 = torch.clamp(1.0 + m00 - m11 - m22, min=0.0) / 4.0
    qy2 = torch.clamp(1.0 - m00 + m11 - m22, min=0.0) / 4.0
    qz2 = torch.clamp(1.0 - m00 - m11 + m22, min=0.0) / 4.0
    w, x, y, z = (torch.sqrt(v + 1e-30) for v in (qw2, qx2, qy2, qz2))
    cands = torch.stack([
        torch.stack([w, (m[..., 2, 1] - m[..., 1, 2]) / (4 * w), (m[..., 0, 2] - m[..., 2, 0]) / (4 * w),
                     (m[..., 1, 0] - m[..., 0, 1]) / (4 * w)], dim=-1),
        torch.stack([(m[..., 2, 1] - m[..., 1, 2]) / (4 * x), x, (m[..., 0, 1] + m[..., 1, 0]) / (4 * x),
                     (m[..., 0, 2] + m[..., 2, 0]) / (4 * x)], dim=-1),
        torch.stack([(m[..., 0, 2] - m[..., 2, 0]) / (4 * y), (m[..., 0, 1] + m[..., 1, 0]) / (4 * y), y,
                     (m[..., 1, 2] + m[..., 2, 1]) / (4 * y)], dim=-1),
        torch.stack([(m[..., 1, 0] - m[..., 0, 1]) / (4 * z), (m[..., 0, 2] + m[..., 2, 0]) / (4 * z),
                     (m[..., 1, 2] + m[..., 2, 1]) / (4 * z), z], dim=-1),
    ], dim=-2)  # (..., 4 candidates, 4)
    best = torch.argmax(torch.stack([qw2, qx2, qy2, qz2], dim=-1), dim=-1)
    q = torch.take_along_dim(cands, best[..., None, None], dim=-2)[..., 0, :]
    return standardize_quaternion(normalize_quaternion(q))


def random_quaternions(n: int, generator: Optional[torch.Generator] = None, dtype=torch.float32,
                       device=None) -> torch.Tensor:
    """Uniform random unit quaternions (n, 4): normalised Gaussian draws."""
    q = torch.randn(n, 4, generator=generator, dtype=dtype, device=device)
    return standardize_quaternion(normalize_quaternion(q))


def se3_from_quat_trans(q: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    return torch.cat([q, t], dim=-1)


def multiply_se3(T1: torch.Tensor, T2: torch.Tensor) -> torch.Tensor:
    """``(q1, t1) * (q2, t2) = (q1 q2, t1 + q1 t2)``."""
    q1, t1 = T1[..., :4], T1[..., 4:]
    q2, t2 = T2[..., :4], T2[..., 4:]
    q = quaternion_raw_multiply(q1, q2)
    t = t1 + quaternion_apply(q1, t2)
    return torch.cat([q, t], dim=-1)


def se3_invert(T: torch.Tensor) -> torch.Tensor:
    """``(q, t)^-1 = (q^-1, -q^-1 t)``."""
    q, t = T[..., :4], T[..., 4:]
    qi = quaternion_invert(q)
    return torch.cat([qi, -quaternion_apply(qi, t)], dim=-1)


def transform_points(points: torch.Tensor, Ts: torch.Tensor) -> torch.Tensor:
    """Apply poses ``Ts`` (nT, 7) to points (nP, 3) -> (nT, nP, 3)."""
    q = Ts[..., None, :4]
    t = Ts[..., None, 4:]
    return quaternion_apply(q, points) + t


def se3_exp_map(log_vec: torch.Tensor) -> torch.Tensor:
    """SE(3) exponential map: (..., 6) twist ``(v, w)``, translation first ->
    pose ``(q, t)`` with ``t = V(w) v``; series below 1e-4 rad."""
    v, w = log_vec[..., :3], log_vec[..., 3:]
    theta = _norm(w + 1e-30)
    q = axis_angle_to_quaternion(w)
    small = theta < 1e-4
    A = torch.where(small, 0.5 - theta**2 / 24.0, (1.0 - torch.cos(theta)) / torch.clamp(theta**2, min=1e-30))
    B = torch.where(small, 1.0 / 6.0 - theta**2 / 120.0,
                    (theta - torch.sin(theta)) / torch.clamp(theta**3, min=1e-30))
    wxv = _cross(w, v)
    wxwxv = _cross(w, wxv)
    t = v + A * wxv + B * wxwxv
    return torch.cat([q, t], dim=-1)


def quaternion_to_axis_angle(q: torch.Tensor) -> torch.Tensor:
    """Unit quaternion -> rotation vector, with a series below 1e-6."""
    q = standardize_quaternion(q)
    w = torch.clamp(q[..., :1], -1.0, 1.0)
    v = q[..., 1:]
    sin_half = _norm(v + 1e-30)
    half = torch.atan2(sin_half, w)
    small = sin_half < 1e-6
    scale = torch.where(small, 2.0 + (2.0 / 3.0) * half * half,
                        2.0 * half / torch.where(small, torch.ones_like(sin_half), sin_half))
    return v * scale


def se3_log_map(T: torch.Tensor) -> torch.Tensor:
    """Pose ``(q, t)`` -> (..., 6) twist ``(v, w)``."""
    q, t = T[..., :4], T[..., 4:]
    w = quaternion_to_axis_angle(q)
    theta = _norm(w + 1e-30)
    small = theta < 1e-4
    sin_t, cos_t = torch.sin(theta), torch.cos(theta)
    k = torch.where(
        small,
        1.0 / 12.0 + theta**2 / 720.0,
        (1.0 - 0.5 * theta * sin_t / torch.clamp(1.0 - cos_t, min=1e-30)) / torch.clamp(theta**2, min=1e-30),
    )
    wxt = _cross(w, t)
    wxwxt = _cross(w, wxt)
    v = t - 0.5 * wxt + k * wxwxt
    return torch.cat([v, w], dim=-1)
