"""Fixtures of the benchmark's CPU tests: a checkout root holding the
benchmark's traffic, metrics and configurations, the tiny configurations of
this directory, and a ``BENCHMARK.json`` whose cells run them."""
from __future__ import annotations

import json
import os
import shutil
import sys

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH = os.path.dirname(HERE)
ROOT = os.path.dirname(BENCH)
sys.path.insert(0, ROOT)

LIMITS = {"pick_serve": {"step_gap": 1e-2, "energy_gap": 1e-3}, "place_serve4": {"step_gap": 1e-2, "energy_gap": 1e-3},
          "pick_train": {"loss_gap": 1e-4, "grad_gap": 1e-3, "change_gap": 1e-2, "ema_gap": 1e-2}}
SCENE = {"family": "mug", "n_scene": 400, "n_grasp": 120, "diverse": True}
MIXES = {
    "pick_serve": {"kind": "serve", "task": "pick", "clients": 1, "seeds_per_request": 4, "batching": None,
                   "warm_batches": [1], "scene": SCENE, "pose_spread_m": 0.05, "check": {"requests": 2, "steps": 3}},
    "place_serve4": {"kind": "serve", "task": "place", "clients": 3, "seeds_per_request": 3,
                     "batching": {"max_batch": 4, "window_ms": 20}, "warm_batches": [1, 2, 4], "scene": SCENE,
                     "pose_spread_m": 0.05, "check": {"requests": 2, "steps": 3}},
    "pick_train": {"kind": "train", "demos": 3, "scene": SCENE, "check": {"steps": 3}},
}
CONFIGS = {"pick_serve": "tiny_pick", "place_serve4": "tiny_place", "pick_train": "tiny_pick"}


def make_root(path) -> str:
    """A checkout root whose cells are the real cells' names on tiny
    configurations and mixes (``tiny_<cell>``)."""
    root = str(path)
    for d in ("traffic", "metrics", "configs"):
        shutil.copytree(os.path.join(BENCH, d), os.path.join(root, "benchmark", d), dirs_exist_ok=True)
    for t in ("pick", "place"):
        shutil.copy(os.path.join(HERE, f"tiny_{t}.json"), os.path.join(root, "benchmark", "configs", f"tiny_{t}.json"))
    for cell, mix in MIXES.items():
        mix = json.loads(json.dumps(mix))
        mix["check"]["limits"] = LIMITS[cell]
        with open(os.path.join(root, "benchmark", "traffic", f"tiny_{cell}.json"), "w") as f:
            json.dump(mix, f)
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    bench["configs"] = [{"name": f"tiny_{t}", "source": "the CPU tests", "file": f"benchmark/configs/tiny_{t}.json",
                         "reduced": [], "why": "tiny widths"} for t in ("pick", "place")]
    bench["workloads"] = [{"name": cell, "config": CONFIGS[cell], "traffic": f"tiny_{cell}", "chips": 1, "why": "tiny"}
                          for cell in MIXES]
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    return root


@pytest.fixture
def tiny_root(tmp_path):
    return make_root(tmp_path)


def run_cell(root: str, cell: str, capsys, seed: int = 2**31 + 11, seconds: float = 3.0, trace: int = 0):
    """(exit code, result line or None, standard error) of one run of
    ``cell`` on the CPU."""
    from benchmark.harness.core import main

    code = main(["--workload", cell, "--seed", str(seed), "--seconds", str(seconds), "--trace", str(trace)],
                device="cpu", root=root)
    out, err = capsys.readouterr()
    lines = [line for line in out.splitlines() if line.startswith("{")]
    return code, (json.loads(lines[-1]) if lines else None), err
