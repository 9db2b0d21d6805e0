"""The benchmark's serve harness on the sapien pick cascade at tiny widths on
the CPU: a root built as the benchmark's own CPU tests build theirs
(``benchmark/tests/conftest.make_root``), with the tiny configuration of
``test_torch_sapien_bench.py`` and the cell ``sapien_pick_serve`` on it
added in this test's copy.  A sound run reads ``correct`` true and reports
the cell's per-layer metrics that a CPU run has; a port whose point-attentive
key flattens its keypoint weights to their mean reads false."""
import json
import os

import pytest
import torch

from benchmark.tests.conftest import make_root, run_cell

from .test_torch_sapien_bench import _mean_weights, tiny_sapien_config

CELL = "sapien_pick_serve"
MIX = {"kind": "serve", "task": "pick", "clients": 1, "seeds_per_request": 32, "batching": None, "warm_batches": [1],
       "scene": {"family": "mug", "n_scene": 400, "n_grasp": 120, "diverse": True}, "pose_spread_m": 0.05,
       "check": {"requests": 100, "steps": 3, "limits": {"step_gap": 1e-2}}}  # every request of the window


@pytest.fixture
def sapien_root(tmp_path, monkeypatch):
    from benchmark.harness import core

    # tests/conftest.py loads JAX into this process for the parity tests: the harness refuses only what a run
    # loads besides (a whole run in a process of its own is benchmark/tests/test_bench_names.py's)
    loaded, forbidden = set(core.forbidden_modules()), core.forbidden_modules
    monkeypatch.setattr(core, "forbidden_modules", lambda: sorted(set(forbidden()) - loaded))
    root = make_root(tmp_path)
    with open(os.path.join(root, "benchmark", "configs", "tiny_sapien.json"), "w") as f:
        json.dump(tiny_sapien_config(), f)
    with open(os.path.join(root, "benchmark", "traffic", f"tiny_{CELL}.json"), "w") as f:
        json.dump(MIX, f)
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    bench["configs"].append({"name": "tiny_sapien", "source": "the CPU tests", "reduced": [], "why": "tiny widths",
                             "file": "benchmark/configs/tiny_sapien.json"})
    bench["workloads"].append({"name": CELL, "config": "tiny_sapien", "traffic": f"tiny_{CELL}", "chips": 1,
                               "why": "tiny"})
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    return root


def _flat_key_weights(monkeypatch):
    """The port's point-attentive key with every kept keypoint's weight
    replaced by their mean (no host read: it runs inside the runtime)."""
    from diffusion_edf_tpu_torch.models.score_model import PointAttentiveScoreModel

    orig = PointAttentiveScoreModel.get_key_pcd_multiscale

    def flat(self, pcd):
        (key,) = orig(self, pcd)
        return [_mean_weights(key)]

    monkeypatch.setattr(PointAttentiveScoreModel, "get_key_pcd_multiscale", flat)


def test_sapien_cell_reads_correct(sapien_root, capsys):
    """A traced run: ``correct`` true with no failed request, the lowres and
    highres steps read apart, and no runtime entry built in the window."""
    torch.set_num_threads(2)
    code, line, err = run_cell(sapien_root, CELL, capsys, seconds=2.0, trace=1)
    assert code == 0 and line is not None, err
    assert line["correct"] is True and line["failed"] == 0 and line["attempted"] > 0, err
    assert set(line["compared"]) == {"step_gap"}  # no critic, so no energy_gap
    metrics = line["metrics"]
    for name in ("serve_ms.sapien", "extract_ms.sapien", "lowres_step_ms.sapien", "highres_step_ms.sapien"):
        assert metrics[name]["value"] > 0, name
    assert metrics["new_entries.sapien"]["value"] == 0
    assert not any(n.endswith((".pick", ".place", ".train")) for n in metrics)


def test_flat_keypoint_weights_read_incorrect(sapien_root, capsys, monkeypatch):
    torch.set_num_threads(2)
    _flat_key_weights(monkeypatch)
    code, line, err = run_cell(sapien_root, CELL, capsys, seconds=2.0)
    assert code == 0 and line is not None, err
    assert line["correct"] is False and line["failed"] == 0, err
    assert line["compared"]["step_gap"]["value"] > line["compared"]["step_gap"]["limit"]
