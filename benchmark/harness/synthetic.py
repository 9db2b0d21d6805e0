"""Procedural demo generation: the program's ``train/synthetic.py``, copied so
that the benchmark's traffic stays as it is when the program changes (the
same seed gives the same demos as the program's copy).

The reference ships LFS demo datasets (``demo/panda_mug_on_hanger``) that are
unavailable offline; this module generates geometrically meaningful pick/place
tasks with the same container format so the full train/eval/serve pipeline can
run end-to-end.  The task family is "mug on hanger"-like: a tabletop scene
with a pole ("hanger") at a random pose, a mug, and a two-finger gripper.

Frame convention (matches the reference demos + configs): grasp clouds are in
the HAND-BASE frame of a Franka-like gripper whose TCP is at ``z = 10.5 cm``
— the pick model's static query keypoints (``score_model_configs.yaml``
``keypoint_coords: [+-0.5, +-0.5, 10.5]`` cm) sit between the fingertips, at
the grasp contact, and the place model's KeypointExtractor bbox
(``z in [8, 100]`` cm) selects the held object above the fingers.  A
mug-at-origin grasp frame would put the pick keypoints 10 cm into empty space
(the finest field scale sees nothing) and leave the place bbox empty.

* pick:  scene = table + pole + mug; grasp cloud = gripper (hand frame);
  target = hand pose whose fingertips straddle the mug handle.
* place: scene = table + pole; grasp cloud = gripper + mug held in hand;
  target = hand pose that hangs the mug on the pole (random roll about the
  vertical axis through the hang point — the physical symmetry; demos record
  one roll, and ``TargetPoseDemo.symmetry`` carries the orbit center so eval
  can score against the full orbit).

Units: meters (rescaled to cm by the standard preprocess pipeline).
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from ..reference.edf.train.data import DemoSequence, PointCloud, TargetPoseDemo

__all__ = [
    "make_synthetic_demo",
    "make_synthetic_dataset",
    "make_split_dataset",
    "SPLITS",
    "GRIPPER_TCP",
]

# hand-base -> TCP offset (meters); the reference Franka hand's flange->TCP is
# 10.34 cm, and the pick configs put the static keypoints at z = 10.5 cm.
GRIPPER_TCP = np.array([0.0, 0.0, 0.105])


def _cylinder(rng, center, axis, radius, length, n, color):
    axis = np.asarray(axis, dtype=np.float64)
    axis = axis / np.linalg.norm(axis)
    # orthonormal frame
    a = np.array([1.0, 0, 0]) if abs(axis[0]) < 0.9 else np.array([0, 1.0, 0])
    u = np.cross(axis, a)
    u /= np.linalg.norm(u)
    v = np.cross(axis, u)
    t = rng.uniform(-length / 2, length / 2, n)
    phi = rng.uniform(0, 2 * np.pi, n)
    pts = (
        np.asarray(center)[None]
        + t[:, None] * axis[None]
        + radius * (np.cos(phi)[:, None] * u[None] + np.sin(phi)[:, None] * v[None])
    )
    cols = np.clip(np.asarray(color)[None] + rng.normal(0, 0.03, (n, 3)), 0, 1)
    return pts, cols


def _plane(rng, center, nx, ny, size, n, color):
    xy = rng.uniform(-size / 2, size / 2, (n, 2))
    pts = np.asarray(center)[None] + np.stack([xy[:, 0], xy[:, 1], np.zeros(n)], -1)
    cols = np.clip(np.asarray(color)[None] + rng.normal(0, 0.02, (n, 3)), 0, 1)
    return pts, cols


def _disk(rng, center, radius, n, color):
    r = radius * np.sqrt(rng.uniform(0, 1, n))
    phi = rng.uniform(0, 2 * np.pi, n)
    pts = np.asarray(center)[None] + np.stack([r * np.cos(phi), r * np.sin(phi), np.zeros(n)], -1)
    cols = np.clip(np.asarray(color)[None] + rng.normal(0, 0.02, (n, 3)), 0, 1)
    return pts, cols


def _mug(rng, n, color, shape_scale: float = 1.0):
    """Mug-like object in its own frame: cylinder + closed bottom + handle +
    a bright rim marker.  The bottom disk and marker break the approximate
    180-degree flip symmetry of an open shell, so target orientations are
    unambiguous (pose metrics would otherwise count valid symmetric samples
    as ~180-degree errors).

    ``shape_scale`` != 1 yields an unseen mug *instance* (different
    radius/height, handle kept at the same grasp offset so target poses stay
    comparable) — the analog of the reference's unseen-instance test mugs
    (``evaluate_real_mug.ipynb`` cells 5,9-10)."""
    body_r = 0.035 * shape_scale
    body_h = 0.08 * (2.0 - shape_scale)  # taller when thinner, squatter when wider
    n_body = int(n * 0.55)
    n_handle = int(n * 0.2)
    n_bottom = int(n * 0.15)
    n_marker = n - n_body - n_handle - n_bottom
    body, cb = _cylinder(rng, [0, 0, body_h / 2], [0, 0, 1], body_r, body_h, n_body, color)
    handle, ch = _cylinder(rng, [0.01 + body_r, 0, 0.04], [0, 0, 1], 0.012, 0.05, n_handle, color)
    bottom, cbo = _disk(rng, [0, 0, 0.0], body_r, n_bottom, [0.8, 0.1, 0.1])
    marker, cm = _cylinder(
        rng, [-(body_r - 0.005), 0, body_h + 0.005], [0, 0, 1], 0.006, 0.01, n_marker, [0.95, 0.9, 0.1]
    )
    return (
        np.concatenate([body, handle, bottom, marker]),
        np.concatenate([cb, ch, cbo, cm]),
    )


def _gripper(rng, n):
    """Two-finger gripper in the hand-base frame: wrist cylinder + crossbar +
    two fingers whose gap is centered on the TCP (``GRIPPER_TCP``).  The
    fingers are color-coded (red/green) so the cloud (which the model sees as
    RGB 3x0e features) breaks the parallel-jaw 180-degree flip symmetry —
    real scanned grippers are likewise color/texture asymmetric."""
    n_wrist = int(n * 0.4)
    n_bar = int(n * 0.2)
    n_f = (n - n_wrist - n_bar) // 2
    wrist, cw = _cylinder(rng, [0, 0, 0.03], [0, 0, 1], 0.016, 0.06, n_wrist, [0.35, 0.35, 0.4])
    bar, cbar = _cylinder(rng, [0, 0, 0.065], [1, 0, 0], 0.009, 0.075, n_bar, [0.3, 0.3, 0.35])
    f1, c1 = _cylinder(rng, [0.017, 0, 0.0875], [0, 0, 1], 0.004, 0.045, n_f, [0.85, 0.15, 0.1])
    f2, c2 = _cylinder(
        rng, [-0.017, 0, 0.0875], [0, 0, 1], 0.004, 0.045, n - n_wrist - n_bar - n_f, [0.1, 0.7, 0.2]
    )
    return np.concatenate([wrist, bar, f1, f2]), np.concatenate([cw, cbar, c1, c2])


def _distractors(rng, n, n_objects):
    """Clutter objects on the table (unseen-distractor split): random small
    cylinders/disks away from the work area."""
    pts, cols = [], []
    per = max(n // max(n_objects, 1), 1)
    for i in range(n_objects):
        if i == n_objects - 1:
            per = n - per * (n_objects - 1)  # exact total
        kind = rng.integers(0, 2)
        center = np.array([rng.uniform(-0.22, 0.22), rng.uniform(0.18, 0.52), rng.uniform(0.01, 0.05)])
        color = rng.uniform(0.1, 0.9, 3)
        if kind == 0:
            p, c = _cylinder(rng, center, [0, 0, 1], rng.uniform(0.01, 0.03), rng.uniform(0.04, 0.1), per, color)
        else:
            p, c = _disk(rng, center, rng.uniform(0.02, 0.05), per, color)
        pts.append(p)
        cols.append(c)
    return np.concatenate(pts), np.concatenate(cols)


def _quat_about(axis, angle):
    axis = np.asarray(axis, dtype=np.float64)
    axis = axis / np.linalg.norm(axis)
    return np.concatenate([[np.cos(angle / 2)], np.sin(angle / 2) * axis])


def _quat_mul(a, b):
    w1, x1, y1, z1 = a
    w2, x2, y2, z2 = b
    return np.array(
        [
            w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
            w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
            w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
            w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
        ]
    )


def _quat_apply(q, pts):
    w, x, y, z = q
    R = np.array(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
            [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
            [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
        ]
    )
    return np.asarray(pts) @ R.T


# top-down grasp base rotation: hand +z (approach) -> world -z, finger
# separation axis (hand x) -> world y.  R0 = rotation by pi about (1,1,0)/sqrt2.
_Q_TOPDOWN = np.array([0.0, np.sqrt(0.5), np.sqrt(0.5), 0.0])


def make_synthetic_demo(
    seed: int,
    n_scene: int = 2800,
    n_grasp: int = 700,
    pose_shift: bool = False,
    n_distractors: int = 0,
    shape_scale: float = 1.0,
    tilt: Optional[float] = None,
) -> DemoSequence:
    """One pick+place demo sequence (step 0 = pick, step 1 = place).

    Generalization-split knobs (reference semantics: per-split test demo sets,
    ``evaluate_real_mug.ipynb`` cells 5,9-10):

    * ``pose_shift`` — pole/mug poses OUTSIDE the training ranges (steeper
      pole tilt, mug beyond the training x/y box).
    * ``n_distractors`` — clutter objects added to the scene.
    * ``shape_scale`` — mug radius/height variation (unseen instance).
    * ``tilt`` — pole lateral extent (None -> 0.5 under ``pose_shift``,
      else the 0.25 legacy training value).
    """
    rng = np.random.default_rng(seed)

    # --- table + hanger pole scene ---
    table, tc = _plane(rng, [0, 0.35, 0.0], 0, 0, 0.5, int(n_scene * 0.5), [0.45, 0.35, 0.25])
    pole_base = np.array([rng.uniform(-0.1, 0.1), rng.uniform(0.3, 0.45), 0.12])
    yaw = rng.uniform(0, 2 * np.pi)
    if tilt is None:
        tilt = 0.5 if pose_shift else 0.25  # training draws lateral extent 0.25
    pole_dir = np.array([np.cos(yaw) * tilt, np.sin(yaw) * tilt, 0.97])
    pole_dir /= np.linalg.norm(pole_dir)
    pole, pc = _cylinder(rng, pole_base + 0.1 * pole_dir, pole_dir, 0.008, 0.2, int(n_scene * 0.2), [0.7, 0.7, 0.2])
    # mug resting on the table (for the pick step)
    if pose_shift:
        # outside the training box ([-0.15,0.15] x [0.25,0.45])
        mug_pos = np.array(
            [rng.uniform(0.15, 0.22) * rng.choice([-1.0, 1.0]), rng.uniform(0.45, 0.55), 0.0]
        )
    else:
        mug_pos = np.array([rng.uniform(-0.15, 0.15), rng.uniform(0.25, 0.45), 0.0])
    mug_yaw = rng.uniform(0, 2 * np.pi)
    n_mug = int(n_scene * 0.3) - (int(n_scene * 0.1) if n_distractors else 0)
    mug_local, mc = _mug(rng, n_mug, [0.2, 0.3, 0.7], shape_scale=shape_scale)
    cz, sz = np.cos(mug_yaw), np.sin(mug_yaw)
    Rz = np.array([[cz, -sz, 0], [sz, cz, 0], [0, 0, 1]])
    mug_world = mug_local @ Rz.T + mug_pos

    scene_parts = [table, pole, mug_world]
    scene_col_parts = [tc, pc, mc]
    if n_distractors:
        dp, dc = _distractors(rng, int(n_scene * 0.1), n_distractors)
        scene_parts.append(dp)
        scene_col_parts.append(dc)
    scene_pts = np.concatenate(scene_parts)
    scene_cols = np.concatenate(scene_col_parts)
    scene = PointCloud(points=scene_pts, colors=scene_cols)
    # place-step scene: the mug has been picked up — it is in the gripper,
    # not on the table (a duplicate table mug would be a spurious attractor
    # for the place score field; the reference demos likewise record a fresh
    # scene cloud per step)
    place_parts = [(p, c) for p, c in zip(scene_parts, scene_col_parts) if p is not mug_world]
    place_scene = PointCloud(
        points=np.concatenate([p for p, _ in place_parts]),
        colors=np.concatenate([c for _, c in place_parts]),
    )

    # --- pick: gripper (hand frame) grasps the mug handle top-down ---
    handle_off = np.array([0.01 + 0.035 * shape_scale, 0.0, 0.04])
    grip_z = 0.05  # grip the upper handle (handle spans z in [0.015, 0.065])
    handle_xy = mug_pos + Rz @ handle_off
    grip_world = np.array([handle_xy[0], handle_xy[1], grip_z])

    gripper_pts, gripper_cols = _gripper(rng, n_grasp)
    pick_grasp = PointCloud(points=gripper_pts, colors=gripper_cols)

    q_pick = _quat_mul(_quat_about([0, 0, 1], mug_yaw), _Q_TOPDOWN)
    # R_pick @ TCP = (0, 0, -0.105) for any yaw (top-down approach)
    t_pick = grip_world - _quat_apply(q_pick, GRIPPER_TCP[None])[0]
    pick_pose = np.concatenate([q_pick, t_pick])[None]

    # --- place: gripper + held mug (hand frame); hang the mug on the pole ---
    # mug-in-hand transform T_rel = T_pick^-1 * T_mug: R_rel = R0 (the
    # top-down base rotation, an involution), t_rel = R0 @ Rz(-yaw)(mug_pos -
    # t_pick) — the handle sits at the TCP, the (upside-down) body above the
    # fingers, inside the place query bbox (z in [8, 100] cm, hand frame).
    t_rel = _quat_apply(_Q_TOPDOWN, (mug_pos - t_pick)[None] @ Rz)[0]
    mug_hand_local, mh_cols = _mug(rng, int(n_grasp * 0.65), [0.2, 0.3, 0.7], shape_scale=shape_scale)
    mug_in_hand = _quat_apply(_Q_TOPDOWN, mug_hand_local) + t_rel
    grip2_pts, grip2_cols = _gripper(rng, n_grasp - int(n_grasp * 0.65))
    place_grasp = PointCloud(
        points=np.concatenate([grip2_pts, mug_in_hand]),
        colors=np.concatenate([grip2_cols, mh_cols]),
    )

    # mug world pose when hung on the pole tip (random roll about world z
    # through the hang point — the task's physical symmetry)
    hang_point = pole_base + 0.19 * pole_dir
    roll = rng.uniform(0, 2 * np.pi)
    q_place_mug = _quat_mul(_quat_about([0, 0, 1], roll), _quat_about([1, 0, 0], np.pi / 2))
    # hand pose H = T_mug_world * T_rel^-1
    t_relinv = -_quat_apply(_Q_TOPDOWN, t_rel[None])[0]  # R0^-1 = R0
    q_place = _quat_mul(q_place_mug, _Q_TOPDOWN)
    t_place = hang_point + _quat_apply(q_place_mug, t_relinv[None])[0]
    place_pose = np.concatenate([q_place, t_place])[None]

    pick = TargetPoseDemo(scene_pcd=scene, grasp_pcd=pick_grasp, target_poses=pick_pose, name=f"synt_{seed}_pick")
    place = TargetPoseDemo(
        scene_pcd=place_scene,
        grasp_pcd=place_grasp,
        target_poses=place_pose,
        name=f"synt_{seed}_place",
        symmetry={"axis": [0.0, 0.0, 1.0], "center": hang_point.tolist()},
    )
    return DemoSequence(steps=[pick, place])


def _bowl(rng, n, color, shape_scale: float = 1.0):
    """Bowl-like object in its own frame: open hemispherical shell (rim up)
    + closed bottom disk + a bright rim marker breaking the yaw symmetry so
    pick targets are unambiguous (the PLACE task keeps its physical z-orbit
    symmetry — a bowl centers on a dish at any yaw)."""
    rim_r = 0.055 * shape_scale
    depth = 0.035 * (2.0 - shape_scale)
    n_shell = int(n * 0.7)
    n_bottom = int(n * 0.2)
    n_marker = n - n_shell - n_bottom
    # shell: z = depth * (r/rim_r)^2 paraboloid, points uniform in area-ish
    r = rim_r * np.sqrt(rng.uniform(0.15, 1.0, n_shell))
    phi = rng.uniform(0, 2 * np.pi, n_shell)
    shell = np.stack(
        [r * np.cos(phi), r * np.sin(phi), depth * (r / rim_r) ** 2], axis=-1
    )
    cs = np.clip(np.asarray(color)[None] + rng.normal(0, 0.03, (n_shell, 3)), 0, 1)
    bottom, cb = _disk(rng, [0, 0, 0.0], rim_r * 0.4, n_bottom, [0.8, 0.1, 0.1])
    marker, cm = _cylinder(
        rng, [rim_r, 0, depth + 0.004], [0, 0, 1], 0.005, 0.008, n_marker, [0.95, 0.9, 0.1]
    )
    return np.concatenate([shell, bottom, marker]), np.concatenate([cs, cb, cm])


def make_bowl_demo(
    seed: int,
    n_scene: int = 2800,
    n_grasp: int = 700,
    pose_shift: bool = False,
    n_distractors: int = 0,
    shape_scale: float = 1.0,
    tilt: Optional[float] = None,  # unused (no pole); kept for split parity
) -> DemoSequence:
    """Second task family: "bowl on dish" (reference analog:
    ``demo/panda_bowl_on_dish`` / ``evaluate_real_bowl.ipynb``).

    * pick:  scene = table + dish + bowl; target = top-down rim grasp at the
      marker azimuth (the demo's recorded grasp point).
    * place: scene = table + dish; grasp = gripper + bowl in hand; target =
      bowl centered on the dish, any yaw (z-orbit symmetry about the dish
      center, like the mug family's hanger roll).
    """
    rng = np.random.default_rng(seed + 70_000)

    table, tc = _plane(rng, [0, 0.35, 0.0], 0, 0, 0.5, int(n_scene * 0.45), [0.45, 0.35, 0.25])
    # dish: flat disk + rim ring
    if pose_shift:
        dish_pos = np.array(
            [rng.uniform(0.15, 0.22) * rng.choice([-1.0, 1.0]), rng.uniform(0.45, 0.55), 0.005]
        )
    else:
        dish_pos = np.array([rng.uniform(-0.12, 0.12), rng.uniform(0.28, 0.44), 0.005])
    dish_r = 0.07
    n_dish = int(n_scene * 0.22)
    dish_flat, df = _disk(rng, dish_pos, dish_r, int(n_dish * 0.7), [0.85, 0.85, 0.9])
    dish_rim, dr = _cylinder(
        rng, dish_pos + [0, 0, 0.006], [0, 0, 1], dish_r, 0.012, n_dish - int(n_dish * 0.7),
        [0.8, 0.8, 0.88],
    )
    # bowl on the table (pick step), away from the dish
    while True:
        bowl_pos = np.array([rng.uniform(-0.15, 0.15), rng.uniform(0.25, 0.45), 0.0])
        if np.linalg.norm(bowl_pos[:2] - dish_pos[:2]) > 0.15:
            break
    if pose_shift:
        bowl_pos = np.array(
            [rng.uniform(0.15, 0.22) * rng.choice([-1.0, 1.0]), rng.uniform(0.18, 0.24), 0.0]
        )
    bowl_yaw = rng.uniform(0, 2 * np.pi)
    n_bowl = int(n_scene * 0.33) - (int(n_scene * 0.1) if n_distractors else 0)
    bowl_local, bc = _bowl(rng, n_bowl, [0.2, 0.55, 0.35], shape_scale=shape_scale)
    cz, sz = np.cos(bowl_yaw), np.sin(bowl_yaw)
    Rz = np.array([[cz, -sz, 0], [sz, cz, 0], [0, 0, 1]])
    bowl_world = bowl_local @ Rz.T + bowl_pos

    scene_parts = [table, dish_flat, dish_rim, bowl_world]
    scene_cols = [tc, df, dr, bc]
    if n_distractors:
        dp, dc = _distractors(rng, int(n_scene * 0.1), n_distractors)
        scene_parts.append(dp)
        scene_cols.append(dc)
    scene = PointCloud(points=np.concatenate(scene_parts), colors=np.concatenate(scene_cols))
    place_scene = PointCloud(
        points=np.concatenate([p for p, c in zip(scene_parts, scene_cols) if p is not bowl_world]),
        colors=np.concatenate([c for p, c in zip(scene_parts, scene_cols) if p is not bowl_world]),
    )

    # pick: top-down rim grasp at the marker azimuth (bowl frame +x)
    rim_r = 0.055 * shape_scale
    depth = 0.035 * (2.0 - shape_scale)
    grip_local = np.array([rim_r, 0.0, depth])  # rim point at the marker
    grip_world = bowl_pos + Rz @ grip_local
    gripper_pts, gripper_cols = _gripper(rng, n_grasp)
    pick_grasp = PointCloud(points=gripper_pts, colors=gripper_cols)
    # fingers straddle the rim: separation axis (hand x) tangential ->
    # rotate the top-down base by (yaw + 90deg) about z
    q_pick = _quat_mul(_quat_about([0, 0, 1], bowl_yaw + np.pi / 2), _Q_TOPDOWN)
    t_pick = np.array([grip_world[0], grip_world[1], depth]) - _quat_apply(q_pick, GRIPPER_TCP[None])[0]
    pick_pose = np.concatenate([q_pick, t_pick])[None]

    # place: bowl held in hand (same relative transform math as the mug)
    t_rel = _quat_apply(_Q_TOPDOWN, (bowl_pos - t_pick)[None] @ Rz)[0]
    bowl_hand_local, bh = _bowl(rng, int(n_grasp * 0.65), [0.2, 0.55, 0.35], shape_scale=shape_scale)
    bowl_in_hand = _quat_apply(_Q_TOPDOWN, bowl_hand_local) + t_rel
    grip2, g2c = _gripper(rng, n_grasp - int(n_grasp * 0.65))
    place_grasp = PointCloud(
        points=np.concatenate([grip2, bowl_in_hand]),
        colors=np.concatenate([g2c, bh]),
    )
    # bowl pose on the dish: centered, any yaw (record one)
    yaw2 = rng.uniform(0, 2 * np.pi)
    q_bowl_place = _quat_about([0, 0, 1], yaw2)
    bowl_place_pos = dish_pos + [0, 0, 0.008]
    t_relinv = -_quat_apply(_Q_TOPDOWN, t_rel[None])[0]
    q_place = _quat_mul(q_bowl_place, _Q_TOPDOWN)
    t_place = bowl_place_pos + _quat_apply(q_bowl_place, t_relinv[None])[0]
    place_pose = np.concatenate([q_place, t_place])[None]

    pick = TargetPoseDemo(
        scene_pcd=scene, grasp_pcd=pick_grasp, target_poses=pick_pose,
        name=f"bowl_{seed}_pick",
        # a rim grasp is valid at any azimuth (bowl = body of revolution up
        # to the small marker); the orbit axis is the bowl's vertical axis
        symmetry={"axis": [0.0, 0.0, 1.0], "center": bowl_pos.tolist()},
    )
    place = TargetPoseDemo(
        scene_pcd=place_scene, grasp_pcd=place_grasp, target_poses=place_pose,
        name=f"bowl_{seed}_place",
        symmetry={"axis": [0.0, 0.0, 1.0], "center": bowl_place_pos.tolist()},
    )
    return DemoSequence(steps=[pick, place])


def _bottle(rng, n, color, shape_scale: float = 1.0):
    """Bottle-like object in its own frame: body cylinder + narrower neck +
    bright cap + a label stripe on the body (+x azimuth).  A bottle is a body
    of revolution; the label breaks the yaw symmetry so the recorded pick
    grasp azimuth is unambiguous (like the mug handle / bowl rim marker).
    The PLACE task keeps the physical z-orbit symmetry — a bottle stands on
    the shelf spot at any yaw."""
    body_r = 0.025 * shape_scale
    body_h = 0.11 * (2.0 - shape_scale)
    neck_h = 0.035
    n_body = int(n * 0.55)
    n_neck = int(n * 0.18)
    n_cap = int(n * 0.08)
    n_label = n - n_body - n_neck - n_cap
    body, cb = _cylinder(rng, [0, 0, body_h / 2], [0, 0, 1], body_r, body_h, n_body, color)
    neck, cn = _cylinder(
        rng, [0, 0, body_h + neck_h / 2], [0, 0, 1], 0.011, neck_h, n_neck, color
    )
    cap, cc = _cylinder(
        rng, [0, 0, body_h + neck_h + 0.005], [0, 0, 1], 0.013, 0.01, n_cap, [0.9, 0.15, 0.1]
    )
    label, cl = _cylinder(
        rng, [body_r, 0, body_h * 0.55], [0, 0, 1], 0.004, 0.04, n_label, [0.95, 0.9, 0.1]
    )
    return (
        np.concatenate([body, neck, cap, label]),
        np.concatenate([cb, cn, cc, cl]),
    )


def make_bottle_demo(
    seed: int,
    n_scene: int = 2800,
    n_grasp: int = 700,
    pose_shift: bool = False,
    n_distractors: int = 0,
    shape_scale: float = 1.0,
    tilt: Optional[float] = None,  # unused (no pole); kept for split parity
) -> DemoSequence:
    """Third task family: "bottle on shelf" (reference analog:
    ``demo/panda_bottle_on_shelf`` / ``evaluate_real_bottle.ipynb``).

    * pick:  scene = table + shelf + bottle standing on the table; target =
      top-down neck grasp, fingers straddling the neck at the label azimuth
      (the demo's recorded grasp).
    * place: scene = table + shelf; grasp = gripper + bottle in hand; target =
      bottle standing on the shelf spot, any yaw (z-orbit symmetry about the
      spot center, like the bowl family's dish placement).
    """
    rng = np.random.default_rng(seed + 140_000)

    table, tc = _plane(rng, [0, 0.35, 0.0], 0, 0, 0.5, int(n_scene * 0.4), [0.45, 0.35, 0.25])
    # shelf: raised platform on two legs at the back of the table, with a
    # pale spot marker at the placement target
    shelf_h = 0.16
    shelf_size = 0.18
    if pose_shift:
        shelf_center = np.array(
            [rng.uniform(0.12, 0.2) * rng.choice([-1.0, 1.0]), rng.uniform(0.5, 0.56), shelf_h]
        )
    else:
        shelf_center = np.array([rng.uniform(-0.1, 0.1), rng.uniform(0.44, 0.52), shelf_h])
    n_shelf = int(n_scene * 0.25)
    plat, pf = _plane(rng, shelf_center, 0, 0, shelf_size, int(n_shelf * 0.6), [0.55, 0.45, 0.3])
    leg_off = shelf_size / 2 - 0.015
    leg1, l1 = _cylinder(
        rng, shelf_center + [-leg_off, 0, -shelf_h / 2], [0, 0, 1], 0.008, shelf_h,
        int(n_shelf * 0.125), [0.5, 0.4, 0.28],
    )
    leg2, l2 = _cylinder(
        rng, shelf_center + [leg_off, 0, -shelf_h / 2], [0, 0, 1], 0.008, shelf_h,
        int(n_shelf * 0.125), [0.5, 0.4, 0.28],
    )
    spot = shelf_center + [0, 0, 0.001]
    spot_pts, sc = _disk(
        rng, spot, 0.035, n_shelf - int(n_shelf * 0.6) - 2 * int(n_shelf * 0.125), [0.85, 0.85, 0.9]
    )
    # bottle standing on the table (pick step), in front of the shelf
    if pose_shift:
        bottle_pos = np.array(
            [rng.uniform(0.15, 0.22) * rng.choice([-1.0, 1.0]), rng.uniform(0.18, 0.24), 0.0]
        )
    else:
        bottle_pos = np.array([rng.uniform(-0.15, 0.15), rng.uniform(0.22, 0.38), 0.0])
    bottle_yaw = rng.uniform(0, 2 * np.pi)
    n_bottle = int(n_scene * 0.35) - (int(n_scene * 0.1) if n_distractors else 0)
    bottle_local, bc = _bottle(rng, n_bottle, [0.25, 0.45, 0.65], shape_scale=shape_scale)
    cz, sz = np.cos(bottle_yaw), np.sin(bottle_yaw)
    Rz = np.array([[cz, -sz, 0], [sz, cz, 0], [0, 0, 1]])
    bottle_world = bottle_local @ Rz.T + bottle_pos

    scene_parts = [table, plat, leg1, leg2, spot_pts, bottle_world]
    scene_cols = [tc, pf, l1, l2, sc, bc]
    if n_distractors:
        dp, dc = _distractors(rng, int(n_scene * 0.1), n_distractors)
        scene_parts.append(dp)
        scene_cols.append(dc)
    scene = PointCloud(points=np.concatenate(scene_parts), colors=np.concatenate(scene_cols))
    place_scene = PointCloud(
        points=np.concatenate([p for p, c in zip(scene_parts, scene_cols) if p is not bottle_world]),
        colors=np.concatenate([c for p, c in zip(scene_parts, scene_cols) if p is not bottle_world]),
    )

    # pick: top-down neck grasp — TCP at the neck midpoint, finger separation
    # axis (hand x) at the label azimuth + 90deg so the fingers straddle the
    # 1.1 cm neck (finger gap interior is +-1.3 cm)
    body_h = 0.11 * (2.0 - shape_scale)
    grip_z = body_h + 0.035 * 0.5
    grip_world = np.array([bottle_pos[0], bottle_pos[1], grip_z])
    gripper_pts, gripper_cols = _gripper(rng, n_grasp)
    pick_grasp = PointCloud(points=gripper_pts, colors=gripper_cols)
    q_pick = _quat_mul(_quat_about([0, 0, 1], bottle_yaw + np.pi / 2), _Q_TOPDOWN)
    t_pick = grip_world - _quat_apply(q_pick, GRIPPER_TCP[None])[0]
    pick_pose = np.concatenate([q_pick, t_pick])[None]

    # place: bottle held in hand (same relative transform math as mug/bowl)
    t_rel = _quat_apply(_Q_TOPDOWN, (bottle_pos - t_pick)[None] @ Rz)[0]
    bottle_hand_local, bh = _bottle(rng, int(n_grasp * 0.65), [0.25, 0.45, 0.65], shape_scale=shape_scale)
    bottle_in_hand = _quat_apply(_Q_TOPDOWN, bottle_hand_local) + t_rel
    grip2, g2c = _gripper(rng, n_grasp - int(n_grasp * 0.65))
    place_grasp = PointCloud(
        points=np.concatenate([grip2, bottle_in_hand]),
        colors=np.concatenate([g2c, bh]),
    )
    # bottle pose on the shelf spot: standing upright, any yaw (record one)
    yaw2 = rng.uniform(0, 2 * np.pi)
    q_bottle_place = _quat_about([0, 0, 1], yaw2)
    bottle_place_pos = spot + [0, 0, 0.002]
    t_relinv = -_quat_apply(_Q_TOPDOWN, t_rel[None])[0]
    q_place = _quat_mul(q_bottle_place, _Q_TOPDOWN)
    t_place = bottle_place_pos + _quat_apply(q_bottle_place, t_relinv[None])[0]
    place_pose = np.concatenate([q_place, t_place])[None]

    pick = TargetPoseDemo(
        scene_pcd=scene, grasp_pcd=pick_grasp, target_poses=pick_pose,
        name=f"bottle_{seed}_pick",
        # a neck grasp is valid at any azimuth (bottle = body of revolution
        # up to the label); the orbit axis is the bottle's vertical axis
        symmetry={"axis": [0.0, 0.0, 1.0], "center": bottle_pos.tolist()},
    )
    place = TargetPoseDemo(
        scene_pcd=place_scene, grasp_pcd=place_grasp, target_poses=place_pose,
        name=f"bottle_{seed}_place",
        symmetry={"axis": [0.0, 0.0, 1.0], "center": bottle_place_pos.tolist()},
    )
    return DemoSequence(steps=[pick, place])


FAMILIES = {"mug": make_synthetic_demo, "bowl": make_bowl_demo, "bottle": make_bottle_demo}


# Diverse-training factor ranges.  Models trained on the narrow fixed-factor
# distribution (scale 1.0, tilt 0.25, no clutter) collapse on the held-out
# splits; the reference's real demo sets carry natural per-demo variation.
# The held-out splits below still test EXTRAPOLATION beyond these ranges.
TRAIN_SCALE_RANGE = (0.85, 1.15)
TRAIN_TILT_RANGE = (0.02, 0.35)
TRAIN_MAX_DISTRACTORS = 2


def make_synthetic_dataset(
    n_demos: int = 10,
    seed: int = 0,
    diverse: bool = False,
    clutter_heavy: bool = False,
    family: str = "mug",
    **kwargs,
) -> List[DemoSequence]:
    """Training demo set.  ``diverse=True`` draws per-demo mug scale / pole
    tilt / clutter from the TRAIN_* ranges; ``False`` keeps the fixed
    factors.

    ``clutter_heavy`` reweights the per-demo distractor draw toward the top
    of the training range (the plain draw leaves half the demos
    clutter-free).  The split definitions (``SPLITS``) are unchanged —
    the distractors split still tests count extrapolation beyond
    ``TRAIN_MAX_DISTRACTORS``.

    ``family``: task geometry — ``"mug"`` (mug on hanger) or ``"bowl"``
    (bowl on dish, the second trained family; reference ships
    ``demo/panda_bowl_on_dish``).
    """
    mk = FAMILIES[family]
    if not diverse:
        return [mk(seed + i, **kwargs) for i in range(n_demos)]
    rng = np.random.default_rng(seed + 313)
    clutter_draw = (
        [1, TRAIN_MAX_DISTRACTORS, TRAIN_MAX_DISTRACTORS, TRAIN_MAX_DISTRACTORS]
        if clutter_heavy
        else [0, 0, 1, TRAIN_MAX_DISTRACTORS]
    )
    out = []
    for i in range(n_demos):
        o = dict(kwargs)
        o.setdefault("shape_scale", float(rng.uniform(*TRAIN_SCALE_RANGE)))
        o.setdefault("tilt", float(rng.uniform(*TRAIN_TILT_RANGE)))
        o.setdefault("n_distractors", int(rng.choice(clutter_draw)))
        out.append(mk(seed + i, **o))
    return out


# Generalization splits (reference: default / unseen poses / unseen
# distractors / unseen instances test demo sets).  ``default`` is the training
# distribution with fresh seeds; the others perturb exactly one factor beyond
# the training ranges.
SPLITS = {
    "default": dict(),
    "unseen_poses": dict(pose_shift=True),
    "distractors": dict(n_distractors=TRAIN_MAX_DISTRACTORS + 1),
    "unseen_instances": dict(shape_scale=None),  # resolved per-demo below
}


def make_split_dataset(
    split: str, n_demos: int = 10, seed: int = 1000, family: str = "mug", **kwargs
) -> List[DemoSequence]:
    """Demo set for one generalization split; seeds default to a held-out
    range (train uses 0..n-1)."""
    mk = FAMILIES[family]
    opts = dict(SPLITS[split])
    out = []
    rng = np.random.default_rng(seed + 777)
    for i in range(n_demos):
        o = dict(opts)
        if o.get("shape_scale", 1.0) is None:
            # unseen instance: object scale strictly OUTSIDE the diverse
            # training range [0.85, 1.15] (reference semantics: test objects
            # differ from every training object)
            lo, hi = TRAIN_SCALE_RANGE
            if rng.uniform() < 0.5:
                o["shape_scale"] = float(rng.uniform(lo - 0.15, lo - 0.03))
            else:
                o["shape_scale"] = float(rng.uniform(hi + 0.03, hi + 0.15))
        out.append(mk(seed + i, **o, **kwargs))
    return out
