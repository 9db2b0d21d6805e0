"""The device trace of one profiled stretch (``torch.profiler``, CUPTI):
device busy time, kernel counts and times by name, and the idle gaps named
by what the host was doing.  Nothing here imports the program."""
from __future__ import annotations

import time
from typing import Any, Callable, Dict, List, Tuple

import torch

__all__ = ["profile_call", "reduce_events"]

K1_KERNELS = ("edge_kernel_f32", "compact_kernel")  # K1: the compaction of the mask's slots, then the segment


def profile_call(fn: Callable[[], Any]) -> Tuple[Any, Callable[[], Dict[str, Any]]]:
    """(``fn()``, the reduction of its trace, to be called later):
    ``fn`` under the profiler, the device synchronised before and after, the
    wall time on the host's clock.  The trace is reduced when asked, out of
    the measured window."""
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.cuda.is_available()
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    sync()
    with profile(activities=[ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])) as prof:
        t0 = time.perf_counter()
        out = fn()
        sync()
        wall = time.perf_counter() - t0
    return out, lambda: reduce_events(prof.events(), wall)


def _merge(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    merged: List[Tuple[float, float]] = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1] = (merged[-1][0], max(merged[-1][1], b))
        else:
            merged.append((a, b))
    return merged


def reduce_events(events, wall_s: float) -> Dict[str, Any]:
    """Busy seconds (the union of the kernels' intervals), the traced window
    (``window_s``: from the first kernel's start to the last one's end; the
    host's wall around the call, ``wall_s``, also holds the profiler's own
    host time), kernel count, K1's device seconds, the ten kernels that took
    most time and the ten longest idle stretches of the window grouped by the
    innermost host op that spans them."""
    cuda = torch.autograd.DeviceType.CUDA
    kernels, host = [], []
    for e in events:
        if e.device_type == cuda:
            if not e.name.startswith(("Memcpy", "Memset")):
                kernels.append(e)
        else:
            host.append(e)
    if not kernels:
        return {"kernels": 0, "busy_s": 0.0, "window_s": 0.0, "wall_s": wall_s}
    spans = [(e.time_range.start, e.time_range.end) for e in kernels]
    busy = _merge(spans)
    busy_s = sum(b - a for a, b in busy) / 1e6
    by_name: Dict[str, float] = {}
    for e, (a, b) in zip(kernels, spans):
        by_name[e.name] = by_name.get(e.name, 0.0) + (b - a) / 1e6
    k1_s = sum(t for n, t in by_name.items() if any(k in n for k in K1_KERNELS))
    # idle stretches between the kernels, each named by the shortest host op around its middle
    edges = [x for iv in busy for x in iv]
    gaps = [(edges[i], edges[i + 1]) for i in range(1, len(edges) - 1, 2) if edges[i + 1] > edges[i]]
    host_spans = sorted((e.time_range.start, e.time_range.end, e.name) for e in host)
    idle: Dict[str, float] = {}
    gaps.sort(key=lambda g: g[0] - g[1])
    for a, b in gaps[200:]:  # only the longest stretches are named: the host ops that span a short one vary
        idle["shorter stretches"] = idle.get("shorter stretches", 0.0) + (b - a) / 1e6
    for a, b in gaps[:200]:
        mid = 0.5 * (a + b)
        around = [(hb - ha, n) for ha, hb, n in host_spans if ha <= mid <= hb]
        label = min(around)[1] if around else "host outside torch ops"
        idle[label] = idle.get(label, 0.0) + (b - a) / 1e6
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    return {
        "kernels": len(kernels), "busy_s": busy_s, "window_s": (busy[-1][1] - busy[0][0]) / 1e6, "wall_s": wall_s,
        "k1_s": k1_s,
        "device_ops": [[n, t] for n, t in top],
        "idle_gaps": [[n, t] for n, t in sorted(idle.items(), key=lambda kv: -kv[1])[:10]],
    }
