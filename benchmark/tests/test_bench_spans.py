"""The program's spans and padding count under whole CPU runs of the tiny cells:
``pad_share.place`` reads the service's padding count within 0-100 in a
``--trace 1`` run of the place cell, and reads nothing from a service that
counts no padding; the harness never switches the program's recorder on,
so no run records a span."""
from __future__ import annotations

import pytest
import torch

from benchmark.harness.core import metric_reader

from .conftest import run_cell


@pytest.mark.parametrize("cell,trace", [("place_serve4", 1), ("place_serve4", 0), ("pick_serve", 0)])
def test_runs_read_padding_and_record_no_span(tiny_root, capsys, cell, trace):
    from diffusion_edf_tpu_torch.utils import profiling

    torch.set_num_threads(2)
    profiling.drain()
    code, line, err = run_cell(tiny_root, cell, capsys, seconds=2.0, trace=trace)
    assert code == 0 and line is not None and line["correct"], err
    with profiling.span("after.the.run"):
        pass
    assert profiling.drain() == []  # the recorder was off in the run and still is
    if trace:
        assert 0.0 <= line["metrics"]["pad_share.place"]["value"] <= 100.0
        assert line["metrics"]["pad_share.place"]["unit"] == "%"
    else:
        assert "pad_share.place" not in line["metrics"]


def test_pad_share_reads_the_window_and_nothing_without_the_count():
    read = metric_reader("pad_share.place")
    stats = {"dispatches": 0, "requests": 0, "batched_requests": 2}
    assert read({"batch": (stats, dict(stats, batched_requests=10))}) is None  # a service without the count
    assert read({}) is None
    b0 = dict(stats, padded_requests=1)
    assert read({"batch": (b0, dict(b0, batched_requests=10, padded_requests=3))}) == pytest.approx(20.0)
    assert read({"batch": (b0, b0)}) is None


def _span(name, t0_s, t1_s, request=None, **attrs):
    from diffusion_edf_tpu_torch.utils.profiling import span

    s = span(name, request=request, **attrs)
    s.t0, s.t1 = int(t0_s * 1e9), int(t1_s * 1e9)
    return s


def test_span_readings_of_a_record():
    """``metrics/spans.py`` on a record of two requests: the window is the
    first send to the last reply, spans outside it are left out, and a
    record without spans reads nothing."""
    from benchmark.metrics import spans as sp

    requests = [{"ok": True, "t_send": 10.0, "t_reply": 14.0}, {"ok": True, "t_send": 11.0, "t_reply": 16.0}]
    spans = [
        _span("serve.request", 10.1, 13.9, request=1), _span("serve.decode", 10.1, 10.2, request=1),
        _span("serve.queue", 10.2, 11.2, request=1), _span("serve.encode", 13.5, 13.9, request=1),
        _span("serve.request", 11.1, 15.9, request=2), _span("serve.decode", 11.1, 11.3, request=2),
        _span("serve.queue", 11.3, 14.3, request=2), _span("serve.encode", 15.5, 15.8, request=2),
        _span("agent.extract", 11.2, 11.5), _span("agent.rollout", 11.5, 13.4), _span("agent.critic", 13.3, 13.5),
        _span("agent.rollout", 14.3, 15.5), _span("agent.rollout", 16.5, 17.0),  # the last after the window
    ]
    setup = [_span("graphs.build", 1.0, 3.5, entry="rollout"), _span("graphs.build", 4.0, 4.5, entry="rollout"),
             _span("agent.rollout", 4.5, 6.0)]
    record = {"requests": requests, "spans": spans, "setup_spans": setup}
    assert sp.window(record) == (10.0, 16.0)
    assert sp.queue_wait_ms(record) == pytest.approx(2000.0)  # median of 1.0 and 3.0 s
    assert sp.wire_ms(record) == pytest.approx(500.0)  # (0.1 + 0.4) and (0.2 + 0.3) s
    assert sp.host_gap_share(record) == pytest.approx(100.0 * (1 - 3.5 / 6.0))  # 11.2-13.5 and 14.3-15.5
    assert sp.capture_s(record) == pytest.approx(3.0)
    bare = {"requests": requests}
    assert [f(bare) for f in (sp.queue_wait_ms, sp.wire_ms, sp.host_gap_share, sp.capture_s)] == [None] * 4


@pytest.mark.parametrize("cell", ["pick_serve", "place_serve4"])
def test_span_report_of_a_traced_run(tiny_root, capsys, tmp_path, cell):
    """``tools/torch_span_report.py`` on a ``--trace 1`` run of a tiny cell:
    every reading of the cell is there and within its range, and the
    recorder is off again after it."""
    import importlib.util
    import json
    import os

    from diffusion_edf_tpu_torch.utils import profiling

    from .conftest import ROOT

    torch.set_num_threads(2)
    spec = importlib.util.spec_from_file_location("torch_span_report", os.path.join(ROOT, "tools", "torch_span_report.py"))
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    out = tmp_path / "spans.json"
    code = tool.main(["--workload", cell, "--seed", str(2**31 + 23), "--seconds", "2", "--trace", "1",
                      "--device", "cpu", "--root", tiny_root, "--out", str(out)])
    capsys.readouterr()
    assert code == 0
    with open(out) as f:
        r = json.load(f)
    assert r["request_spans"] > 0 and 0.0 < r["capture_s"] < r["setup_s"]
    assert 0.0 <= r["host_gap_share"] <= 100.0 and 0.0 < r["wire_ms"]
    assert 0.0 <= r["queue_wait_ms"] < r["request_ms_p50"]
    if cell == "place_serve4":
        assert 0.0 <= r["pad_share"] <= 100.0 and r["dispatches"]
    else:
        assert r["pad_share"] is None and "harness_gap_share" in r
    with profiling.span("after.the.report"):
        pass
    assert profiling.drain() == []
