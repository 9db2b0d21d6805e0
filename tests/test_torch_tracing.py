"""The port's span recorder (``utils/profiling.py``) on the CPU:
nothing kept with recording off; parents and request ids of spans opened on
one thread and across threads; the spans of the HTTP service, batched (three
concurrent place requests padded to a dispatch of four) and unbatched; the
agent's ``info`` timings as its spans' durations; no span per Langevin step
or inside a program; and the spans of host work, and only those, as ranges
in a ``profiling.trace``."""
import glob
import json
import threading

import numpy as np
import pytest
import torch

from diffusion_edf_tpu_torch.agent import ENTRY_POINTS
from diffusion_edf_tpu_torch.serve import AgentService
from diffusion_edf_tpu_torch.utils import profiling
from diffusion_edf_tpu_torch.utils.profiling import drain, record, span

from .test_torch_serve import COLD, _payload, _post, _request, _serve, agents, family  # noqa: F401

torch.set_num_threads(1)
AGENT_SPANS = {"agent.preprocess", "agent.extract", "agent.rollout", "agent.critic"}


@pytest.fixture
def recorder():
    """Recording on for the test, off and emptied after it."""
    drain()
    record(True)
    try:
        yield
    finally:
        record(False)
        drain()


def _named(spans, name):
    return [s for s in spans if s.name == name]


def test_recording_off_keeps_nothing():
    drain()
    with span("outer") as outer:
        with span("inner", request=3):
            pass
    q = span("queue").start()
    q.end()
    assert drain() == []
    assert outer.t1 >= outer.t0 > 0 and outer.seconds >= 0  # a span times itself with recording off


def test_spans_nest_with_parents(recorder):
    with span("root", request=7) as root:
        with span("child", k=1) as child:
            with span("leaf") as leaf:
                pass
        q = span("queue").start()
    done = threading.Event()

    def other():
        with span("elsewhere", parent=root) as e:
            pass
        q.end()
        done.e = e
        done.set()

    th = threading.Thread(target=other)
    th.start()
    th.join(timeout=30)
    assert done.is_set() and not th.is_alive()
    spans = drain()
    assert [s.name for s in spans] == ["leaf", "child", "root", "elsewhere", "queue"]
    assert root.parent is None and child.parent == root.id and leaf.parent == child.id
    assert q.parent == root.id and done.e.parent == root.id
    assert {s.request for s in spans} == {7}  # inherited from the parent
    assert child.attrs == {"k": 1}
    assert done.e.thread != root.thread and q.thread == root.thread
    assert all(s.t0 <= s.t1 for s in spans) and root.t0 <= child.t0 <= leaf.t0 <= leaf.t1 <= child.t1 <= root.t1
    assert drain() == []


def test_batched_requests_queue_and_padding(agents, recorder):
    """Three concurrent place requests with ``max_batch=4``: one dispatch of
    three real requests and one padding request; each request's spans on its
    HTTP thread and on the dispatcher thread share its id."""
    service = AgentService(None, agents["place"], dict(place_diffusion_configs=COLD),
                           batching=dict(max_batch=4, window_ms=2000))
    httpd, url = _serve(service)
    results = [None] * 3
    try:
        threads = [threading.Thread(target=lambda i=i: results.__setitem__(i, _post(url + "/denoise",
                                                                                    _payload("place", 70 + i))))
                   for i in range(3)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=600)
        assert not any(th.is_alive() for th in threads)
    finally:
        httpd.shutdown()
    assert all(r is not None and len(r["trajectories"]) == 7 for r in results)
    assert service.batch_stats == {"dispatches": 1, "requests": 3, "batched_requests": 3, "padded_requests": 1}
    spans = drain()
    roots = _named(spans, "serve.request")
    ids = sorted(s.request for s in roots)
    assert len(roots) == 3 and len(set(ids)) == 3
    (dispatch,) = _named(spans, "serve.dispatch")
    assert sorted(dispatch.request) == ids and dispatch.attrs == {"real": 3, "padded": 1}
    queues = _named(spans, "serve.queue")
    assert len(queues) == 3 and sorted(q.request for q in queues) == ids
    by_id = {s.id: s for s in spans}
    for root in roots:
        mine = [s for s in spans if s.request == root.request]
        assert {s.name for s in mine} == {"serve.request", "serve.decode", "serve.queue", "serve.encode"}
        assert all(s.parent == root.id for s in mine if s is not root)
        (queue,) = [s for s in mine if s.name == "serve.queue"]
        assert root.t0 <= queue.t0 and queue.t1 <= dispatch.t0 + 1_000_000  # the queue ends as the dispatch starts
        encodes = [s for s in mine if s.name == "serve.encode"]
        assert {s.thread for s in encodes} == {root.thread, dispatch.thread} != {root.thread}
    # the agent's spans sit under the dispatch, on its thread, with its request ids
    agent_spans = [s for s in spans if s.name in AGENT_SPANS]
    assert {s.name for s in agent_spans} == AGENT_SPANS and len(_named(agent_spans, "agent.preprocess")) == 4
    for s in agent_spans:
        assert s.thread == dispatch.thread and s.request == dispatch.request
        while s.parent != dispatch.id:
            s = by_id[s.parent]


def test_unbatched_request_spans(agents, recorder):
    """Without batching the queue is the wait for the device lock and the
    dispatch holds one request, none padded."""
    service = AgentService(agents["pick"], None, dict(pick_diffusion_configs=COLD))
    out = service.denoise(_payload("pick", 80), request=41)
    assert len(out["trajectories"]) == 7
    spans = drain()
    assert service.batch_stats["padded_requests"] == 0
    names = [s.name for s in spans if s.name.startswith("serve.")]
    assert names == ["serve.decode", "serve.queue", "serve.dispatch", "serve.encode"]
    assert all(s.request in (41, (41,)) for s in spans)
    (dispatch,) = _named(spans, "serve.dispatch")
    assert dispatch.request == (41,) and dispatch.attrs == {"real": 1, "padded": 0}


@pytest.mark.parametrize("steps", [1, 4])
def test_info_timings_are_span_durations(agents, recorder, steps):
    """``info["extract_s"]``, ``["rollout_s"]`` and ``["critic_s"]`` are the
    spans' durations; a call opens its spans a stage, never a step; a call
    on built entries builds no program, and a new shape builds each entry's
    programs once."""
    agent = agents["pick"]
    cfg = dict(COLD, N_steps_list=[[steps, steps], [steps, steps]])
    scene, grasp, Ts = _request(90)
    drain()
    for call in range(2):
        _, _, _, info = agent.sample(scene, grasp, Ts, **cfg)
        spans = drain()
        builds = _named(spans, "graphs.build")
        if call == 0:
            entries = {b.attrs["entry"] for b in builds}
            assert "rollout" in entries and entries <= set(ENTRY_POINTS)  # a new rollout shape; the clouds' are not
            assert all(b.attrs["capture_s"] == 0.0 for b in builds)  # nothing is captured on the CPU
        else:
            assert builds == []
        spans = [s for s in spans if s.name != "graphs.build"]
        assert sorted(s.name for s in spans) == sorted(["agent.preprocess", "agent.critic"]
                                                       + ["agent.extract", "agent.rollout"] * 2)
        extract = sorted(_named(spans, "agent.extract"), key=lambda s: s.attrs["stage"])
        rollout = sorted(_named(spans, "agent.rollout"), key=lambda s: s.attrs["stage"])
        assert info["extract_s"] == [s.seconds for s in extract]
        assert info["rollout_s"] == [s.seconds for s in rollout]
        assert info["steps"] == [s.attrs["steps"] for s in rollout] == [2 * steps] * 2
        assert info["critic_s"] == _named(spans, "agent.critic")[0].seconds
        for e, r in zip(extract, rollout):
            assert e.t1 <= r.t0


def test_trace_holds_host_spans_only(agents, tmp_path):
    """With recording off, a ``profiling.trace`` of one ``sample`` call holds
    the agent's spans of host work as ``record_function`` ranges, in the
    profiler's events and in the written trace file, and none of its spans
    that enclose device work (the profiler would mirror those onto the
    device as busy time)."""
    drain()
    scene, grasp, Ts = _request(91)
    with profiling.trace(str(tmp_path)) as prof:
        _, _, _, info = agents["pick"].sample(scene, grasp, Ts, **COLD)
    names = [e.name for e in prof.events()]
    assert names.count("agent.preprocess") == 1
    assert not {"agent.extract", "agent.rollout", "agent.critic", "graphs.build"} & set(names)
    (path,) = glob.glob(str(tmp_path / "trace_*.json"))
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    assert [e.get("cat") for e in events if e.get("name") == "agent.preprocess"] == ["user_annotation"]
    assert drain() == []  # the profiler does not switch recording on
    assert len(info["rollout_s"]) == 2 and np.isfinite(info["critic_s"])


@pytest.mark.parametrize("device_work", [False, True])
def test_span_under_trace_is_a_range_for_host_work_only(tmp_path, device_work):
    """Under ``profiling.trace`` a span of host work is a ``user_annotation``
    range and a span of device work is none."""
    with profiling.trace(str(tmp_path)) as prof:
        with span("probe", device_work=device_work) as s:
            sum(range(1000))
    assert [e.name for e in prof.events()].count("probe") == (0 if device_work else 1)
    assert s.t1 >= s.t0 > 0 and drain() == []


def test_span_without_the_profiler_flag(monkeypatch, recorder):
    """A span still works should torch drop the profiler's module flag."""
    monkeypatch.delattr(profiling._autograd_profiler, "_is_profiler_enabled")
    with span("probe") as s:
        pass
    assert drain() == [s] and s.t1 >= s.t0 > 0
