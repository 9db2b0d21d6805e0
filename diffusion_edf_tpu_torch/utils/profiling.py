"""Profiling (counterpart of the JAX package's ``utils/profiling.py``).

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
"""
from __future__ import annotations

import contextlib
import os
import time
from typing import Iterator

import torch
from torch.profiler import ProfilerActivity, profile

__all__ = ["trace"]


@contextlib.contextmanager
def trace(log_dir: str, record_shapes: bool = False) -> Iterator[profile]:
    """Profile a region: ``with trace("traces/run") as prof: run()``, then
    open ``traces/run/trace_<time>.json`` in Perfetto or ``chrome://tracing``
    (``prof.key_averages()`` sums it by op)."""
    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
    with profile(activities=activities, record_shapes=record_shapes) as prof:
        try:
            yield prof
        finally:
            if torch.cuda.is_available():
                torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, f"trace_{time.strftime('%Y%m%d_%H%M%S')}_{os.getpid()}.json"))
