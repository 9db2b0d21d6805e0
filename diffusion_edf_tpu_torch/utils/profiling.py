"""Profiling (counterpart of the JAX package's ``utils/profiling.py``), and
the port's span recorder.

:func:`trace` records a region with ``torch.profiler`` (host and, where
there is a card, CUDA activity) and writes a Chrome / Perfetto trace into
``log_dir``.  The JAX module's other function, ``setup_compilation_cache``,
keeps XLA's compiled programs across processes.  The port's per-shape
counterpart, the CUDA graphs of the agent's sampling runtime
(``agent.py``, ``graphs.py``), lives in the process that captured it and is
captured again by the next (a fraction of a second a shape); its one
compile, ``nvcc`` of the CUDA kernels, is kept across processes already:
``nn/cuda_build.py`` writes each library into ``build/`` under a hash of
its sources and loads it from there.

The recorder: the service, the agent and the graph runtime open named
spans (:class:`span`) where their work happens.  Each span times itself
on ``time.perf_counter_ns()`` (the clock of ``time.perf_counter``),
always: the agent's ``info["extract_s"]`` and its kin are span durations.
Recording is off until ``record(True)``; then every span that ends is
kept, with its name, id, parent (the innermost span open on its thread,
unless given), request id(s), thread, start, end and attributes, in a
bounded buffer that ``drain()`` empties.  An operator of the server
switches it on around a stretch of traffic::

    from diffusion_edf_tpu_torch.utils import profiling
    profiling.record(True)
    ...                                   # requests
    spans = profiling.drain()             # then record(False)

Whenever ``torch.profiler`` is active, recording on or off, a span of host
work also opens ``torch.profiler.record_function(name)``, so it is a host
range beside the kernels in any :func:`trace` file, and an idle stretch of
the device while the host was in it is named by it.  A span that encloses
device work (``device_work=True``: a dispatch, an unbatched request, the
extraction, rollout and critic, a program's build) opens none.  The
profiler mirrors a ``record_function`` range onto the device, as a
``gpu_user_annotation`` over the kernels it launched, and a reading of
device events counts that as busy time; a host-op range
(``RecordFunctionFast``) instead has every kernel launched inside it linked
to it, and the profiler took some half an hour to process a place call's
~800k kernels linked so (H100, torch 2.11).  Spans sit outside every
function that a ``graphs.Program`` captures (Python in a captured function
runs once, at capture), and none is opened per Langevin step.

The spans (the metric each feeds, in ``PERF.md``):

- ``serve.request``: the root of each ``POST /denoise``, with the request
  id the service numbers; its children ``serve.decode`` (body, JSON,
  arrays, point clouds), ``serve.queue`` (with batching, enqueue to the
  start of the dispatch that computes it; without, the wait for the device
  lock) and ``serve.encode`` (unscaling, ``tolist``, JSON, the write; on
  the dispatcher thread too, keyed by the request's id);
- ``serve.dispatch``: one agent call, ``request`` its request ids,
  ``real`` and ``padded`` its real and padding requests;
- ``agent.preprocess`` (a request: host work), ``agent.extract`` and
  ``agent.rollout`` (a cascade stage; the extraction's ``model``, the score
  model's class, and ``key_points``, the points its key clouds keep summed
  over scales and requests; the rollout's ``steps``) and
  ``agent.critic``: the extraction, rollout and critic each end
  synchronised;
- ``graphs.build``: one ``Program``'s eager first run and capture, with its
  ``entry``, ``shape`` and ``capture_s``.

The service's one counter is ``AgentService.batch_stats``.
"""
from __future__ import annotations

import collections
import contextlib
import itertools
import os
import threading
import time
from typing import Any, Deque, Iterator, List, Optional

import torch
import torch.autograd.profiler as _autograd_profiler
from torch.profiler import ProfilerActivity, profile

__all__ = ["trace", "span", "record", "drain"]

_MAX_SPANS = 200_000  # the buffer keeps the newest spans: a request opens a few tens

_on = False
_spans: Deque["span"] = collections.deque(maxlen=_MAX_SPANS)
_ids = itertools.count(1)
_local = threading.local()


def _open() -> List["span"]:
    """The spans open on this thread (recording on), innermost last."""
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


def _profiling() -> bool:
    """Whether ``torch.profiler`` is active (False should torch drop the flag)."""
    return getattr(_autograd_profiler, "_is_profiler_enabled", False)


class span:
    """A named stretch of the program: ``with span("agent.rollout", steps=n)
    as s: ...``, then ``s.seconds``.  ``start()`` / ``end()`` time a stretch
    that ends on another thread (it is nobody's parent).  ``parent`` (a
    span, or a span's id) defaults to the innermost open span, and
    ``request`` (an id, or a tuple of ids) to the parent span's.
    ``device_work``: the span encloses device work, so it opens no profiler
    range (see the module docstring)."""

    __slots__ = ("name", "id", "parent", "request", "thread", "t0", "t1", "attrs", "device_work", "_range",
                 "_pushed")

    def __init__(self, name: str, parent: Any = None, request: Any = None, device_work: bool = False, **attrs: Any):
        self.name, self.request, self.device_work, self.attrs = name, request, device_work, attrs
        self.parent: Any = parent  # a span or an id until linked, then an id
        self.id: Optional[int] = None
        self.thread: Optional[int] = None
        self.t0 = self.t1 = 0
        self._range = None
        self._pushed = False

    def _link(self) -> None:
        """Take an id, the thread, and the parent's id and request."""
        parent = self.parent
        if parent is None:
            stack = _open()
            parent = stack[-1] if stack else None
        if isinstance(parent, span):
            if self.request is None:
                self.request = parent.request
            parent = parent.id
        self.parent = parent
        self.id, self.thread = next(_ids), threading.get_ident()

    def start(self) -> "span":
        if _on:
            self._link()
        self.t0 = time.perf_counter_ns()
        return self

    def end(self) -> "span":
        self.t1 = time.perf_counter_ns()
        if _on:
            if self.id is None:
                self._link()
            _spans.append(self)
        return self

    def __enter__(self) -> "span":
        if _profiling() and not self.device_work:
            self._range = torch.profiler.record_function(self.name)
            self._range.__enter__()
        self.start()
        if self.id is not None:
            _open().append(self)
            self._pushed = True
        return self

    def __exit__(self, *exc) -> None:
        if self._pushed:
            _open().pop()
            self._pushed = False
        self.end()
        if self._range is not None:
            self._range.__exit__(*exc)
            self._range = None

    @property
    def seconds(self) -> float:
        return (self.t1 - self.t0) / 1e9

    def __repr__(self) -> str:
        return f"span({self.name!r}, id={self.id}, parent={self.parent}, request={self.request!r}, " \
               f"{self.seconds * 1e3:.3f} ms, {self.attrs})"


def record(on: bool) -> None:
    """Switch recording of spans on or off (off at import)."""
    global _on
    _on = bool(on)


def drain() -> List[span]:
    """The spans kept since the last drain, in the order they ended; the
    buffer is then empty."""
    out: List[span] = []
    while True:
        try:
            out.append(_spans.popleft())
        except IndexError:
            return out


@contextlib.contextmanager
def trace(log_dir: str, record_shapes: bool = False) -> Iterator[profile]:
    """Profile a region: ``with trace("traces/run") as prof: run()``, then
    open ``traces/run/trace_<time>.json`` in Perfetto or ``chrome://tracing``
    (``prof.key_averages()`` sums it by op; the program's spans of host work
    are its ``user_annotation`` ranges)."""
    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
    with profile(activities=activities, record_shapes=record_shapes) as prof:
        try:
            yield prof
        finally:
            if torch.cuda.is_available():
                torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, f"trace_{time.strftime('%Y%m%d_%H%M%S')}_{os.getpid()}.json"))
