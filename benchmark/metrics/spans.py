"""Readings of the program's spans (``diffusion_edf_tpu_torch/utils/profiling.py``),
for the metric files to import: each ``reading(record)`` takes a run's record
holding ``record["setup_spans"]`` (the spans that ended in set-up) and
``record["spans"]`` (those after it), as ``profiling.drain()`` returns them,
and returns None where the record holds none, as from a program without the
recorder.  Spans and the traffic driver's ``t_send`` / ``t_reply`` share one clock
(``time.perf_counter``).  Padding is read from ``batch_stats`` alone
(``pad_share.place.py``)."""
from __future__ import annotations

import statistics
from typing import Any, Dict, List, Optional, Tuple

Record = Dict[str, Any]
DEVICE_SPANS = ("agent.extract", "agent.rollout", "agent.critic")  # each ends synchronised


def _union(intervals: List[Tuple[float, float]], lo: float, hi: float) -> float:
    """The length of the union of ``intervals`` clipped to [lo, hi]."""
    total, end = 0.0, lo
    for a, b in sorted((max(a, lo), min(b, hi)) for a, b in intervals):
        if b > end and b > a:  # a span wholly outside [lo, hi] clips to nothing
            total += b - max(a, end)
            end = b
    return total


def _bounds(s) -> Tuple[float, float]:
    return s.t0 / 1e9, s.t1 / 1e9


def window(record: Record) -> Optional[Tuple[float, float]]:
    """First send to last reply of the window's answered requests."""
    reqs = [r for r in record.get("requests") or () if r["ok"]]
    if not reqs:
        return None
    return min(r["t_send"] for r in reqs), max(r["t_reply"] for r in reqs)


def window_spans(record: Record) -> List[Any]:
    """The spans that lie inside the serve window."""
    w = window(record)
    if w is None or not record.get("spans"):
        return []
    return [s for s in record["spans"] if w[0] <= _bounds(s)[0] and _bounds(s)[1] <= w[1]]


def per_request(record: Record) -> Dict[int, Dict[str, float]]:
    """Seconds by span name of each request whose ``serve.request`` lies in
    the window."""
    spans = window_spans(record)
    out: Dict[int, Dict[str, float]] = {s.request: {} for s in spans if s.name == "serve.request"}
    for s in spans:
        if isinstance(s.request, int) and s.request in out:
            out[s.request][s.name] = out[s.request].get(s.name, 0.0) + s.seconds
    return out


def queue_wait_ms(record: Record) -> Optional[float]:
    """Median over the window's requests of their ``serve.queue``."""
    per = per_request(record)
    return 1e3 * statistics.median(p.get("serve.queue", 0.0) for p in per.values()) if per else None


def wire_ms(record: Record) -> Optional[float]:
    """Median over the window's requests of ``serve.decode`` + ``serve.encode``."""
    per = per_request(record)
    if not per:
        return None
    return 1e3 * statistics.median(p.get("serve.decode", 0.0) + p.get("serve.encode", 0.0) for p in per.values())


def host_gap_share(record: Record) -> Optional[float]:
    """100 x (1 - the union of the device spans inside the window / the
    window), in percent: outside them the device has no work queued."""
    w = window(record)
    if w is None or not record.get("spans"):
        return None
    busy = _union([_bounds(s) for s in record["spans"] if s.name in DEVICE_SPANS], *w)
    return 100.0 * (1.0 - busy / (w[1] - w[0]))


def capture_s(record: Record) -> Optional[float]:
    """The set-up's ``graphs.build`` spans (eager first run and capture), summed."""
    setup = record.get("setup_spans")
    if not setup:
        return None
    return sum(s.seconds for s in setup if s.name == "graphs.build")
