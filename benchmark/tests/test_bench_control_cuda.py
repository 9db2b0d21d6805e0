"""The control on the card: for each cell, the program's readings within
the mix's limits and the control's (the reference in TF32 in the program's
place), or a planted fault's, past at least one of them, on three seeds at
the cell's own sizes and a short window of its own load.

    python -m pytest -p no:cacheprovider benchmark/tests/test_bench_control_cuda.py
"""
from __future__ import annotations

import json
import os

import pytest

from .conftest import ROOT

with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
    CELLS = [w["name"] for w in json.load(f)["workloads"]]


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the cells run the program's CUDA kernels")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_and_program_passes(card, cell, tmp_path):
    from benchmark.harness import control, core, traffic

    out = tmp_path / "control.jsonl"
    assert control.main(["--workload", cell, "--seeds", "901", "902", "903", "--seconds", "6", "--out", str(out)]) == 0
    rows = [json.loads(line) for line in out.read_text().splitlines()]
    limits = traffic.load_mix(core.load_spec(cell).traffic).params["check"]["limits"]
    for row in rows:
        assert all(row["program"][k] <= v for k, v in limits.items()), row
        assert row.get("failed", 0) == 0
        for col in [c for c in row if c not in ("seed", "program", "requests", "failed")]:
            assert any(row[col][k] > v for k, v in limits.items()), (col, row)
