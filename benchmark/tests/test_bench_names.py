"""A cell, a configuration, a traffic mix and a per-layer metric added by new
files and ``BENCHMARK.json`` entries alone, with no file of the benchmark
edited; and the harness's refusals."""
from __future__ import annotations

import json
import os
import shutil
import sys

from benchmark.harness.core import forbidden_modules, load_spec

from .conftest import HERE, ROOT, run_cell


def test_new_files_alone_add_a_cell(tiny_root, capsys):
    bench = os.path.join(tiny_root, "benchmark")
    before = {p: open(os.path.join(dp, p), "rb").read() for dp, _, fs in os.walk(bench) for p in fs}
    shutil.copy(os.path.join(HERE, "tiny_pick.json"), os.path.join(bench, "configs", "tiny_pick_other.json"))
    with open(os.path.join(bench, "traffic", "tiny_pick_serve.json")) as f:
        mix = json.load(f)
    mix["seeds_per_request"] = 2
    with open(os.path.join(bench, "traffic", "two_seeds.json"), "w") as f:
        json.dump(mix, f)
    with open(os.path.join(bench, "metrics", "requests_seen.other.py"), "w") as f:
        f.write('def read(record):\n    return float(len(record["requests"]))\n')
    with open(os.path.join(tiny_root, "BENCHMARK.json")) as f:
        spec = json.load(f)
    spec["configs"].append({"name": "tiny_pick_other", "source": "the CPU tests", "reduced": [], "why": "new",
                            "file": "benchmark/configs/tiny_pick_other.json"})
    spec["workloads"].append({"name": "other", "config": "tiny_pick_other", "traffic": "two_seeds", "chips": 1,
                              "why": "new"})
    spec["per_layer"].append({"name": "requests_seen.other", "unit": "requests", "better": "higher",
                              "source": "program_counter", "layer": "serve", "moves": "request_ms_p50",
                              "workloads": ["other"]})
    spec["end_to_end"][0]["workloads"].append("other")
    with open(os.path.join(tiny_root, "BENCHMARK.json"), "w") as f:
        json.dump(spec, f)
    for trace, name in ((0, "request_ms_p50"), (1, "requests_seen.other")):
        code, line, err = run_cell(tiny_root, "other", capsys, trace=trace)
        assert code == 0, err
        assert line["correct"], err
        assert name in line["metrics"] and line["metrics"][name]["value"] > 0
    for dp, _, fs in os.walk(bench):  # nothing that was there changed
        for p in fs:
            if p in before:
                assert open(os.path.join(dp, p), "rb").read() == before[p], p


def test_unknown_cell_is_refused(tiny_root, capsys):
    code, line, err = run_cell(tiny_root, "no_such_cell", capsys)
    assert code != 0 and line is None and "no_such_cell" in err


def test_cell_without_a_card_is_refused(tiny_root, capsys):
    from benchmark.harness.core import main

    code = main(["--workload", "pick_serve", "--seed", "1", "--seconds", "1"], device="cuda", root=tiny_root)
    out, err = capsys.readouterr()
    import torch

    if not torch.cuda.is_available():
        assert code != 0 and "{" not in out and "CUDA" in err


def test_per_layer_metrics_are_those_of_the_cell():
    spec = load_spec("place_serve4")
    names = {m["name"] for m in spec.per_layer}
    assert "requests_per_dispatch.place" in names and not any(n.endswith((".pick", ".train")) for n in names)
    assert {m["name"] for m in spec.end_to_end} == {"request_ms_p50", "pose_steps_per_s", "setup_s"}


def test_forbidden_modules_compare_whole_names(monkeypatch):
    import types

    base = set(forbidden_modules())
    monkeypatch.setitem(sys.modules, "jaxfoo", types.ModuleType("jaxfoo"))
    monkeypatch.setitem(sys.modules, "diffusion_edf_tpu_torch_x", types.ModuleType("diffusion_edf_tpu_torch_x"))
    assert set(forbidden_modules()) == base
    monkeypatch.setitem(sys.modules, "diffusion_edf_tpu.agent", types.ModuleType("diffusion_edf_tpu.agent"))
    assert set(forbidden_modules()) == base | {"diffusion_edf_tpu"}


def test_a_run_loads_neither_jax_nor_the_jax_package(tiny_root):
    """A whole run in a process of its own: the harness exits non-zero if
    JAX or the JAX package is loaded once the window has closed."""
    import subprocess

    code = ("import sys; sys.path.insert(0, %r)\n"
            "from benchmark.harness.core import main, forbidden_modules\n"
            "rc = main(['--workload', 'pick_serve', '--seed', '5', '--seconds', '2'], device='cpu', root=%r)\n"
            "assert 'diffusion_edf_tpu_torch' in sys.modules\n"
            "print('FORBIDDEN', forbidden_modules())\n"
            "sys.exit(rc)\n") % (ROOT, tiny_root)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "FORBIDDEN []" in out.stdout
