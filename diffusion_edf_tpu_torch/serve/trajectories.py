"""Approach/retreat trajectories around sampled target poses (the port's own
copy of the JAX package's ``serve/trajectories.py``, which is numpy only;
the port imports nothing of that package):

* pre-pick: straight-line approach of length ``approach_len`` along the
  gripper's local -z axis, discretized into ``n_steps`` poses ending at the
  target pose;
* pre-place: scene-aware retreat: the grasped cloud is pushed away from
  nearby scene points by gradient steps on a soft contact potential
  (neighbors within ``cutoff_r``; step size ``dt``), yielding ``n_steps``
  poses that separate the object from the scene before the final placement is
  reached in reverse.
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np

__all__ = ["compute_pre_pick_trajectory", "compute_pre_place_trajectory"]


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


def compute_pre_pick_trajectory(
    pick_pose: np.ndarray, approach_len: float = 0.1, n_steps: int = 10
) -> np.ndarray:
    """(7,) target pose -> (n_steps, 7) linear approach along gripper -z."""
    pick_pose = np.asarray(pick_pose, dtype=np.float64).reshape(7)
    q, t = pick_pose[:4], pick_pose[4:]
    approach_dir = _quat_rotate(q, np.array([[0.0, 0.0, 1.0]]))[0]  # gripper +z in world
    start = t - approach_len * approach_dir
    alphas = np.linspace(0.0, 1.0, n_steps)
    out = np.stack([np.concatenate([q, start + a * (t - start)]) for a in alphas])
    return out


def compute_pre_place_trajectory(
    place_pose: np.ndarray,
    scene_points: np.ndarray,  # (Ns, 3)
    grasp_points: np.ndarray,  # (Ng, 3) in the gripper frame
    n_steps: int = 20,
    dt: float = 1e-4,
    cutoff_r: float = 0.05,
    eps: float = 1e-4,
    max_num_neighbors: int = 100,
) -> np.ndarray:
    """(7,) place pose -> (n_steps, 7) retreat path (last pose == place pose).

    Gradient ascent on separation: at each step the grasped cloud (at the
    current pose) is pushed along the mean repulsion direction from scene
    points within ``cutoff_r``; when clear of contact it continues straight.
    """
    place_pose = np.asarray(place_pose, dtype=np.float64).reshape(7)
    q = place_pose[:4]
    t = place_pose[4:].copy()
    scene = np.asarray(scene_points, dtype=np.float64)
    grasp_local = _quat_rotate(q, np.asarray(grasp_points, dtype=np.float64))

    poses = [np.concatenate([q, t.copy()])]
    last_dir = np.array([0.0, 0.0, 1.0])
    for _ in range(n_steps - 1):
        pts = grasp_local + t
        # repulsion from nearby scene points
        rep = np.zeros(3)
        n_pairs = 0
        # subsample for speed
        sub = pts[:: max(1, len(pts) // 256)]
        for p in sub:
            d = scene - p
            dist = np.linalg.norm(d, axis=-1)
            nb = np.argsort(dist)[:max_num_neighbors]
            nb = nb[dist[nb] < cutoff_r]
            if len(nb):
                w = 1.0 / (dist[nb] + eps)
                rep -= (d[nb] * w[:, None]).sum(0)
                n_pairs += len(nb)
        if n_pairs > 0:
            direction = rep / (np.linalg.norm(rep) + 1e-12)
            last_dir = direction
        else:
            direction = last_dir
        step = direction * max(dt * max(n_pairs, 1), cutoff_r / (2 * n_steps))
        t = t + step
        poses.append(np.concatenate([q, t.copy()]))
    return np.stack(poses[::-1])  # approach order: far -> place pose
