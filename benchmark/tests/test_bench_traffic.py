"""The traffic mixes: every input a function of the seed, every cloud within
the served pads after the configuration's preprocessing."""
from __future__ import annotations

import json
import os

import numpy as np
import pytest

from benchmark.harness import traffic
from benchmark.reference.edf.train.data import TargetPoseDemo, compose_proc_fn

from .conftest import BENCH

BIG_SEED = 2**31 + 12345  # a run's seed may pass 32 signed bits


def _bench():
    with open(os.path.join(os.path.dirname(BENCH), "BENCHMARK.json")) as f:
        return json.load(f)


def _config(name):
    (c,) = [c for c in _bench()["configs"] if c["name"] == name]
    with open(os.path.join(os.path.dirname(BENCH), c["file"])) as f:
        return json.load(f)


SERVE = [w for w in _bench()["workloads"] if traffic.load_mix(w["traffic"]).kind == "serve"]
TRAIN = [w for w in _bench()["workloads"] if traffic.load_mix(w["traffic"]).kind == "train"]


@pytest.mark.parametrize("cell", SERVE, ids=lambda w: w["name"])
def test_serve_requests_follow_the_seed_and_fit_the_pads(cell):
    params = traffic.load_mix(cell["traffic"]).params
    cfg = _config(cell["config"])
    a = traffic.request(params, BIG_SEED, 0, 3)
    b = traffic.request(params, BIG_SEED, 0, 3)
    c = traffic.request(params, BIG_SEED + 1, 0, 3)
    for x, y in zip(a[:2], b[:2]):
        np.testing.assert_array_equal(x.points, y.points)
        np.testing.assert_array_equal(x.colors, y.colors)
    np.testing.assert_array_equal(a[2], b[2])
    assert not np.array_equal(a[2], c[2]) and not np.array_equal(a[0].points[:10], c[0].points[:10])
    assert a[2].shape == (params["seeds_per_request"], 7)
    np.testing.assert_allclose(np.linalg.norm(a[2][:, :4], axis=-1), 1.0, rtol=1e-12)
    proc = compose_proc_fn(cfg["preprocess"]["preprocess_config"])
    for client in range(int(params["clients"])):
        for k in range(4):
            scene, grasp = traffic.request(params, BIG_SEED, client, k)[:2]
            d = proc(TargetPoseDemo(scene_pcd=scene, grasp_pcd=grasp, target_poses=np.zeros((1, 7))))
            scene, grasp = d.scene_pcd, d.grasp_pcd
            assert 0 < scene.n <= cfg["n_scene_pad"] and 0 < grasp.n <= cfg["n_grasp_pad"]


@pytest.mark.parametrize("cell", TRAIN, ids=lambda w: w["name"])
def test_train_demos_follow_the_seed_and_fit_the_pads(cell):
    params = traffic.load_mix(cell["traffic"]).params
    cfg = _config(cell["config"])
    a, b = traffic.demos(params, BIG_SEED), traffic.demos(params, BIG_SEED)
    assert len(a) == params["demos"]
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x[0].scene_pcd.points, y[0].scene_pcd.points)
        np.testing.assert_array_equal(x[0].target_poses, y[0].target_poses)
    assert not np.array_equal(a[0][0].target_poses, traffic.demos(params, BIG_SEED + 1)[0][0].target_poses)
    m = cfg["models"][cfg["train_model"]]
    proc = compose_proc_fn(m["train_configs"]["preprocess_config"], seed=0)
    for seq in a:
        d = proc(seq[0])
        assert 0 < d.scene_pcd.n <= cfg["n_scene_pad"] and 0 < d.grasp_pcd.n <= cfg["n_grasp_pad"]
