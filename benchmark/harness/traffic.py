"""The one traffic generator: a mix is a data file (``traffic/<mix>.json``)
of parameters, and every input of a run is drawn from the run's seed.

A serve mix gives the task, the number of closed-loop clients, the seeds of
a request, the server's batching and the scene draw; request ``k`` of client
``c`` is a function of ``(seed, c, k)`` alone, so the same seed gives the
same requests in the same order whatever the speed of the system.  A train
mix gives the number of demos; the demos are a function of the seed.

Scenes are the synthetic mug-on-hanger demos of ``synthetic.py``, drawn
with the training ranges of scale, pole tilt and clutter: the pick step's
scene and gripper, or the place step's scene and mug in the gripper.  Seed
poses follow the program's evaluation (``eval.py``): uniform rotations and
translations about the scene's centre, spread by its extent.
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Dict, List, Tuple

import numpy as np

from . import synthetic
from ..reference.edf.train.data import DemoSequence, PointCloud

__all__ = ["load_mix", "Mix", "seed_words", "request", "demos"]

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@dataclasses.dataclass
class Mix:
    kind: str  # "serve" or "train"
    params: Dict[str, Any]


def load_mix(name: str, bench_dir: str = BENCH_DIR) -> Mix:
    """The mix ``traffic/<name>.json`` of the benchmark's directory."""
    with open(os.path.join(bench_dir, "traffic", name + ".json")) as f:
        params = json.load(f)
    return Mix(kind=params["kind"], params=params)


def seed_words(seed: int, *more: int) -> List[int]:
    """Non-negative words for ``np.random.SeedSequence`` from any whole seed."""
    return [int(seed) % 2**64] + [int(m) for m in more]


def _demo(params: Dict[str, Any], words: List[int]) -> DemoSequence:
    """One synthetic demo drawn from ``words``: its factors from the
    training ranges, its geometry from a seed of its own."""
    rng = np.random.default_rng(np.random.SeedSequence(words))
    scene = params["scene"]
    opts = dict(n_scene=int(scene["n_scene"]), n_grasp=int(scene["n_grasp"]))
    if scene.get("diverse", True):
        opts["shape_scale"] = float(rng.uniform(*synthetic.TRAIN_SCALE_RANGE))
        opts["tilt"] = float(rng.uniform(*synthetic.TRAIN_TILT_RANGE))
        opts["n_distractors"] = int(rng.integers(0, synthetic.TRAIN_MAX_DISTRACTORS + 1))
    return synthetic.FAMILIES[scene.get("family", "mug")](int(rng.integers(0, 2**31 - 1)), **opts)


def request(params: Dict[str, Any], seed: int, client: int, k: int) -> Tuple[PointCloud, PointCloud, np.ndarray]:
    """Request ``k`` of ``client``: (scene, grasp, seed poses (n, 7)), metres."""
    step = 0 if params["task"] == "pick" else 1
    demo = _demo(params, seed_words(seed, 1, client, k))[step]
    rng = np.random.default_rng(np.random.SeedSequence(seed_words(seed, 2, client, k)))
    n = int(params["seeds_per_request"])
    center = demo.scene_pcd.points.mean(0)
    spread = demo.scene_pcd.points.std(0).mean() + float(params.get("pose_spread_m", 0.05))
    q = rng.normal(size=(n, 4))
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    t = center + rng.normal(scale=spread, size=(n, 3))
    return demo.scene_pcd, demo.grasp_pcd, np.concatenate([q, t], axis=-1)


def demos(params: Dict[str, Any], seed: int) -> List[DemoSequence]:
    """The training demos of a train mix."""
    return [_demo(params, seed_words(seed, 3, i)) for i in range(int(params["demos"]))]
