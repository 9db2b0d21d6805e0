"""What the metric files share: each ``metrics/<name>.py`` is ``read(record)``
of a run's record (the traffic driver's spans, counters and trace), returning None
where the record holds nothing to read."""
from __future__ import annotations

import statistics
from typing import Any, Dict, List, Optional

from ..work import PEAK_TF32_FLOPS

Record = Dict[str, Any]


def _profile(record: Record) -> Optional[Dict[str, Any]]:
    return next((c for c in record.get("calls", []) if c.get("profile")), None)


def _plain_calls(record: Record) -> List[Dict[str, Any]]:
    """The agent calls of the window that ran without the profiler."""
    return [c for c in record.get("calls", []) if not c.get("profile")]


def setup_s(record: Record) -> Optional[float]:
    return record.get("setup_s")


def request_ms_p50(record: Record) -> Optional[float]:
    """Median, over every request of the window, of send to parsed reply; a
    failed request counts as infinitely late."""
    reqs = record.get("requests")
    if not reqs:
        return None
    return 1e3 * statistics.median(r["t_reply"] - r["t_send"] if r["ok"] else float("inf") for r in reqs)


def pose_steps_per_s(record: Record) -> Optional[float]:
    """Real seeds x Langevin steps of every request answered in the window,
    over the window."""
    reqs = record.get("requests")
    if not reqs or not record.get("window_s"):
        return None
    work = sum(r["n_seeds"] for r in reqs if r["ok"]) * record["steps_per_request"]
    return work / record["window_s"]


def train_step_ms(record: Record) -> Optional[float]:
    if not record.get("steps"):
        return None
    return 1e3 * record["window_s"] / record["steps"]


def serve_ms(record: Record) -> Optional[float]:
    """Median of a request's latency less its agent call's host time: JSON,
    HTTP and the service.  Read where calls and requests pair one to one
    (one client, no batching)."""
    reqs, calls = record.get("requests") or [], _plain_calls(record)
    if not calls or len(calls) != len(reqs) or not all(r["ok"] for r in reqs):
        return None
    return 1e3 * statistics.median(r["t_reply"] - r["t_send"] - c["wall_s"] for r, c in zip(reqs, calls))


def requests_per_dispatch(record: Record) -> Optional[float]:
    if "batch" not in record:
        return None
    b0, b1 = record["batch"]
    d = b1["dispatches"] - b0["dispatches"]
    return None if d <= 0 else (b1["batched_requests"] - b0["batched_requests"]) / d


def extract_ms(record: Record) -> Optional[float]:
    """The extractions' host time of an agent call, the mean over the
    window's calls (a median would flip between the sizes of dispatches that
    alternate)."""
    calls = _plain_calls(record)
    return 1e3 * statistics.fmean(sum(c["extract_s"]) for c in calls) if calls else None


def step_ms(record: Record) -> Optional[float]:
    """The rollouts' host time over their Langevin steps, all the window's
    calls together."""
    calls = _plain_calls(record)
    return 1e3 * sum(sum(c["rollout_s"]) for c in calls) / sum(sum(c["steps"]) for c in calls) if calls else None


def new_entries(record: Record) -> Optional[float]:
    if "entries" not in record or not record.get("calls"):
        return None
    before, after = record["entries"]
    return float(after - before)


def kernels_per_step(record: Record) -> Optional[float]:
    """Device kernels of the profiled stretch over its steps (Langevin steps
    of an agent call, extraction and critic included; train steps of an
    epoch)."""
    c = _profile(record)
    if c is None or not c["profile"]["kernels"]:
        return None
    steps = c["steps"] if isinstance(c["steps"], int) else sum(c["steps"])
    return c["profile"]["kernels"] / steps


def k1_roofline(record: Record) -> Optional[float]:
    """K1's least time (``work.py``, at the slots the reference's masks keep)
    over its device time in the profiled call, in percent."""
    c = _profile(record)
    if c is None or "work" not in c or not c["profile"].get("k1_s"):
        return None
    return 100.0 * c["work"]["k1_least_s"] / c["profile"]["k1_s"]


def plain_wall_s(record: Record) -> Optional[float]:
    """The host time, in the window, of what was profiled after it: the
    median of the window's epochs, or of its agent calls of the profiled
    call's shape (requests and seeds)."""
    if record.get("epoch_s"):
        return statistics.median(record["epoch_s"])
    c = _profile(record)
    if c is None or "rows" not in c:
        return None
    walls = [p["wall_s"] for p in _plain_calls(record) if p["rows"].shape == c["rows"].shape]
    return statistics.median(walls) if walls else None


def mfu(record: Record) -> Optional[float]:
    """The profiled call's model FLOPs over the host time of a call of its
    shape in the window (``plain_wall_s``; the profiler's own host time is no
    part of the program's) at the TF32 peak, in percent."""
    c, wall = _profile(record), plain_wall_s(record)
    if c is None or "work" not in c or not wall:
        return None
    return 100.0 * c["work"]["flops"] / (wall * PEAK_TF32_FLOPS)


def idle_share(record: Record) -> Optional[float]:
    """1 - the profiled stretch's device busy time / the host time of the
    same stretch in the window (``plain_wall_s``), in percent."""
    c, wall = _profile(record), plain_wall_s(record)
    if c is None or not c["profile"]["kernels"] or not wall:
        return None
    return 100.0 * (1.0 - c["profile"]["busy_s"] / wall)
