"""Host-side demo containers, the preprocessing pipeline, padding into
``FeaturedPoints`` and the demo datasets on disk (counterpart of the JAX
package's ``train/data.py``).  Preprocessing is numpy and draws its jitter
from a numpy generator, so the same seed gives the same clouds as the JAX
package.  Voxel downsampling is the numpy ``np.unique`` path."""
from __future__ import annotations

import dataclasses
import os
import warnings
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch
import yaml

from ..data import FeaturedPoints

__all__ = [
    "PointCloud",
    "TargetPoseDemo",
    "DemoSequence",
    "PREPROCESS_REGISTRY",
    "compose_proc_fn",
    "pad_pointcloud",
    "DemoDataset",
    "load_demo_sequence",
    "save_demo_sequence",
]


@dataclasses.dataclass
class PointCloud:
    points: np.ndarray  # (N, 3)
    colors: np.ndarray  # (N, 3) in [0, 1]

    def __post_init__(self):
        self.points = np.asarray(self.points, dtype=np.float32)
        self.colors = np.asarray(self.colors, dtype=np.float32)

    @property
    def n(self) -> int:
        return len(self.points)


@dataclasses.dataclass
class TargetPoseDemo:
    scene_pcd: PointCloud
    grasp_pcd: PointCloud
    target_poses: np.ndarray  # (nP, 7) (qw, qx, qy, qz, x, y, z)
    name: str = ""
    symmetry: Optional[Dict] = None

    def __post_init__(self):
        self.target_poses = np.asarray(self.target_poses, dtype=np.float32).reshape(-1, 7)


@dataclasses.dataclass
class DemoSequence:
    """Ordered task steps: step 0 is the pick, step 1 the place."""

    steps: List[TargetPoseDemo]

    def __getitem__(self, i: int) -> TargetPoseDemo:
        return self.steps[i]

    def __len__(self) -> int:
        return len(self.steps)


def _voxel_downsample(pcd: PointCloud, voxel_size: float, coord_reduction: str = "average") -> PointCloud:
    if pcd.n == 0:
        return pcd
    return _voxel_downsample_numpy(pcd, voxel_size, coord_reduction)


def _voxel_downsample_numpy(pcd: PointCloud, voxel_size: float, coord_reduction: str = "average") -> PointCloud:
    """The voxel downsample without the native library (lexicographic voxel order, as the native one)."""
    keys = np.floor(pcd.points / voxel_size).astype(np.int64)
    _, inv, counts = np.unique(keys, axis=0, return_inverse=True, return_counts=True)
    inv = inv.reshape(-1)
    n_vox = counts.shape[0]
    pts = np.zeros((n_vox, 3), dtype=np.float64)
    cols = np.zeros((n_vox, 3), dtype=np.float64)
    np.add.at(pts, inv, pcd.points)
    np.add.at(cols, inv, pcd.colors)
    pts /= counts[:, None]
    cols /= counts[:, None]
    if coord_reduction == "center":
        pts = (np.unique(keys, axis=0) + 0.5) * voxel_size
    return PointCloud(points=pts, colors=cols)


def _rescale(pcd: PointCloud, rescale_factor: float) -> PointCloud:
    return PointCloud(points=pcd.points * rescale_factor, colors=pcd.colors)


def _pos_jitter(pcd: PointCloud, std: float, prob: float, rng: np.random.Generator) -> PointCloud:
    if rng.uniform() > prob:
        return pcd
    return PointCloud(points=pcd.points + rng.normal(0, std, pcd.points.shape), colors=pcd.colors)


def _color_jitter(pcd: PointCloud, std: float, prob: float, rng: np.random.Generator) -> PointCloud:
    if rng.uniform() > prob:
        return pcd
    return PointCloud(points=pcd.points, colors=np.clip(pcd.colors + rng.normal(0, std, pcd.colors.shape), 0, 1))


def _randomize_hsl(pcd: PointCloud, hrange: float, srange: float, lrange: float, prob: float,
                   rng: np.random.Generator) -> PointCloud:
    if rng.uniform() > prob:
        return pcd
    dh = rng.uniform(-hrange, hrange)
    ds = rng.uniform(-srange, srange)
    dl = rng.uniform(-lrange, lrange)
    rgb = np.clip(pcd.colors, 0.0, 1.0)
    maxc = rgb.max(-1)
    minc = rgb.min(-1)
    l = (maxc + minc) / 2.0
    delta = maxc - minc
    sat_div = np.where(l <= 0.5, maxc + minc, 2.0 - maxc - minc)
    s = np.where(delta > 0, delta / np.where(sat_div > 0, sat_div, 1.0), 0.0)
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    safe = np.where(delta > 0, delta, 1.0)
    rc, gc, bc = (maxc - r) / safe, (maxc - g) / safe, (maxc - b) / safe
    h = np.where(r == maxc, bc - gc, np.where(g == maxc, 2.0 + rc - bc, 4.0 + gc - rc))
    h = np.where(delta > 0, (h / 6.0) % 1.0, 0.0)
    h = (h + dh) % 1.0
    l = np.clip(l + dl, 0.0, 1.0)
    s = np.clip(s + ds, 0.0, 1.0)
    m2 = np.where(l <= 0.5, l * (1.0 + s), l + s - l * s)
    m1 = 2.0 * l - m2

    def _channel(hue):
        hue = hue % 1.0
        return np.where(
            hue < 1 / 6, m1 + (m2 - m1) * hue * 6.0,
            np.where(hue < 0.5, m2, np.where(hue < 2 / 3, m1 + (m2 - m1) * (2 / 3 - hue) * 6.0, m1)),
        )

    out = np.stack([_channel(h + 1 / 3), _channel(h), _channel(h - 1 / 3)], axis=-1)
    out = np.where((s == 0.0)[..., None], l[..., None], out)
    return PointCloud(points=pcd.points, colors=out.astype(pcd.colors.dtype))


def _crop_bbox(pcd: PointCloud, bbox: Sequence[Sequence[float]]) -> PointCloud:
    b = np.asarray(bbox, dtype=np.float32)
    m = np.all((pcd.points >= b[:, 0]) & (pcd.points <= b[:, 1]), axis=-1)
    return PointCloud(points=pcd.points[m], colors=pcd.colors[m])


PREPROCESS_REGISTRY: Dict[str, Callable] = {
    "downsample": _voxel_downsample,
    "rescale": _rescale,
    "pos_jitter": _pos_jitter,
    "color_jitter": _color_jitter,
    "randomize_hsl": _randomize_hsl,
    "crop_bbox": _crop_bbox,
}

_RANDOM_OPS = {"pos_jitter", "color_jitter", "randomize_hsl"}


def compose_proc_fn(preprocess_config: Sequence[Dict], seed: Optional[int] = None) -> Callable:
    """Demo-level preprocessing from the config list; ``rescale`` also
    scales target translations, ``crop_bbox`` honours ``targets``."""
    rng = np.random.default_rng(seed)

    def proc(demo: TargetPoseDemo) -> TargetPoseDemo:
        scene, grasp = demo.scene_pcd, demo.grasp_pcd
        poses = demo.target_poses.copy()
        symmetry = dict(demo.symmetry) if demo.symmetry else None
        for op in preprocess_config:
            name, kwargs = op["name"], dict(op.get("kwargs", {}))
            fn = PREPROCESS_REGISTRY[name]
            targets = kwargs.pop("targets", None)
            extra = {"rng": rng} if name in _RANDOM_OPS else {}
            if name == "rescale":
                factor = float(kwargs["rescale_factor"])
                scene, grasp = fn(scene, **kwargs), fn(grasp, **kwargs)
                poses = np.concatenate([poses[:, :4], poses[:, 4:] * factor], axis=-1)
                if symmetry is not None and "center" in symmetry:
                    symmetry["center"] = (np.asarray(symmetry["center"], np.float64) * factor).tolist()
                continue
            if targets is None or "scene_pcd" in targets:
                scene = fn(scene, **kwargs, **extra)
            if targets is None or "grasp_pcd" in targets:
                grasp = fn(grasp, **kwargs, **extra)
        return TargetPoseDemo(scene_pcd=scene, grasp_pcd=grasp, target_poses=poses, name=demo.name,
                              symmetry=symmetry)

    return proc


def pad_pointcloud(pcd: PointCloud, n_pad: int, device="cpu") -> FeaturedPoints:
    """Pad (or stride-subsample, with a warning) to exactly ``n_pad`` points;
    padded points are parked at 1e6 with ``mask=False``."""
    n = pcd.n
    pts, cols = pcd.points, pcd.colors
    if n > n_pad:
        warnings.warn(f"pad_pointcloud: truncating {n} -> {n_pad} points "
                      f"({100.0 * (n - n_pad) / n:.1f}% dropped); raise n_pad", stacklevel=2)
        idx = np.linspace(0, n - 1, n_pad).round().astype(np.int64)
        pts, cols, n = pts[idx], cols[idx], n_pad
    x = np.zeros((n_pad, 3), dtype=np.float32)
    f = np.zeros((n_pad, 3), dtype=np.float32)
    x[:n] = pts
    x[n:] = 1e6
    f[:n] = cols
    mask = np.zeros((n_pad,), dtype=bool)
    mask[:n] = True
    return FeaturedPoints(x=torch.as_tensor(x, device=device), f=torch.as_tensor(f, device=device),
                          mask=torch.as_tensor(mask, device=device))


def _load_pt_tensor(path: str) -> np.ndarray:
    return np.asarray(torch.load(path, map_location="cpu", weights_only=True))


def _load_pcd_dir(d: str) -> PointCloud:
    return PointCloud(points=_load_pt_tensor(os.path.join(d, "points.pt")),
                      colors=_load_pt_tensor(os.path.join(d, "colors.pt")))


def load_demo_sequence(demo_dir: str) -> DemoSequence:
    """One demo from the native ``demo.npz`` layout, or from the reference
    layout (``step_K/{scene_pcd,grasp_pcd,target_poses}`` of torch tensors)."""
    npz = os.path.join(demo_dir, "demo.npz")
    steps = []
    if os.path.exists(npz):
        with np.load(npz) as data:
            k = 0
            while f"step{k}_scene_points" in data:
                steps.append(TargetPoseDemo(
                    scene_pcd=PointCloud(data[f"step{k}_scene_points"], data[f"step{k}_scene_colors"]),
                    grasp_pcd=PointCloud(data[f"step{k}_grasp_points"], data[f"step{k}_grasp_colors"]),
                    target_poses=data[f"step{k}_poses"],
                    name=os.path.basename(demo_dir),
                ))
                k += 1
        return DemoSequence(steps=steps)
    k = 0
    while os.path.isdir(os.path.join(demo_dir, f"step_{k}")):
        sd = os.path.join(demo_dir, f"step_{k}")
        steps.append(TargetPoseDemo(
            scene_pcd=_load_pcd_dir(os.path.join(sd, "scene_pcd")),
            grasp_pcd=_load_pcd_dir(os.path.join(sd, "grasp_pcd")),
            target_poses=_load_pt_tensor(os.path.join(sd, "target_poses", "poses.pt")),
            name=os.path.basename(demo_dir),
        ))
        k += 1
    return DemoSequence(steps=steps)


def save_demo_sequence(demo: DemoSequence, demo_dir: str) -> None:
    """Write the native ``demo.npz`` layout (the symmetry is not stored, as
    in the JAX package)."""
    os.makedirs(demo_dir, exist_ok=True)
    payload = {}
    for k, step in enumerate(demo.steps):
        payload[f"step{k}_scene_points"] = step.scene_pcd.points
        payload[f"step{k}_scene_colors"] = step.scene_pcd.colors
        payload[f"step{k}_grasp_points"] = step.grasp_pcd.points
        payload[f"step{k}_grasp_colors"] = step.grasp_pcd.colors
        payload[f"step{k}_poses"] = step.target_poses
    np.savez_compressed(os.path.join(demo_dir, "demo.npz"), **payload)


class DemoDataset:
    """The demos that an annotation file (``data.yaml``: a list of
    ``{path: ...}``) lists, loaded on first access."""

    def __init__(self, dataset_dir: str, annotation_file: str = "data.yaml"):
        self.dataset_dir = dataset_dir
        with open(os.path.join(dataset_dir, annotation_file)) as f:
            ann = yaml.safe_load(f)
        self.demo_dirs = [os.path.join(dataset_dir, item["path"]) for item in ann]
        self._cache: Dict[int, DemoSequence] = {}

    def __len__(self) -> int:
        return len(self.demo_dirs)

    def __getitem__(self, i: int) -> DemoSequence:
        if i not in self._cache:
            self._cache[i] = load_demo_sequence(self.demo_dirs[i])
        return self._cache[i]
