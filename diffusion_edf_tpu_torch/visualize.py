"""Pose/point-cloud visualization (reference ``visualize.py:7-111``; a numpy
copy of the JAX package's ``visualize.py``).

Produces a plotly figure with the scene cloud, the grasped cloud rendered at
each sampled pose, and a slider over poses; where plotly is not installed,
the raw data as a dict (the module imports in headless images).
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np

__all__ = ["visualize_pose", "pose_axes"]


def _quat_rotate(q: np.ndarray, v: np.ndarray) -> np.ndarray:
    w, x, y, z = q
    R = np.array(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
            [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
            [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
        ]
    )
    return v @ R.T


def pose_axes(pose: np.ndarray, length: float = 1.0):
    """Return (origin, x_axis, y_axis, z_axis) for drawing a frame."""
    q, t = pose[:4], pose[4:]
    axes = _quat_rotate(q, np.eye(3) * length)
    return t, axes[0], axes[1], axes[2]


def visualize_pose(
    scene_points: np.ndarray,
    scene_colors: np.ndarray,
    grasp_points: np.ndarray,
    grasp_colors: np.ndarray,
    poses: np.ndarray,  # (nP, 7)
    point_size: float = 1.5,
    width: int = 1000,
    height: int = 800,
):
    """Plotly figure with a per-pose slider (``visualize.py:56-110``)."""
    poses = np.asarray(poses).reshape(-1, 7)
    try:
        import plotly.graph_objects as go
    except Exception:
        return {
            "scene_points": np.asarray(scene_points),
            "poses": poses,
            "note": "plotly unavailable; raw data returned",
        }

    def _rgb(c):
        c = np.clip(np.asarray(c), 0, 1)
        return [f"rgb({int(r*255)},{int(g*255)},{int(b*255)})" for r, g, b in c]

    scene_tr = go.Scatter3d(
        x=scene_points[:, 0], y=scene_points[:, 1], z=scene_points[:, 2],
        mode="markers", marker=dict(size=point_size, color=_rgb(scene_colors)), name="scene",
    )
    frames = []
    for i, pose in enumerate(poses):
        pts = _quat_rotate(pose[:4], np.asarray(grasp_points)) + pose[4:]
        frames.append(
            go.Scatter3d(
                x=pts[:, 0], y=pts[:, 1], z=pts[:, 2], mode="markers",
                marker=dict(size=point_size, color=_rgb(grasp_colors)),
                name=f"pose {i}", visible=(i == 0),
            )
        )
    fig = go.Figure(data=[scene_tr] + frames)
    steps = []
    for i in range(len(poses)):
        vis = [True] + [j == i for j in range(len(poses))]
        steps.append(dict(method="update", args=[{"visible": vis}], label=str(i)))
    fig.update_layout(
        sliders=[dict(active=0, steps=steps)],
        width=width, height=height, scene_aspectmode="data",
    )
    return fig
