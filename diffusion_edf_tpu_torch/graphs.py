"""Per-shape programs of the sampling and training paths: captured once as
CUDA graphs on the card, run eagerly on the CPU (the counterpart of the
executables that ``jax.jit`` compiles per input shape).

A :class:`Program` wraps ``fn()``, a function that reads and writes tensors
it closes over (static buffers) and may return more tensors (its static
outputs).  Its construction is the first call: ``fn`` runs eagerly, on CUDA
on a side stream as PyTorch's graph documentation prescribes, which fills
every operand cache the call reaches (folded weights, tensor-core operands,
constant tables) so that nothing is copied from the host during the capture.
On CUDA ``fn`` is then captured into a ``torch.cuda.CUDAGraph`` in the
caller's memory pool (the capture runs nothing), and the first call's
outputs are copied into the captured ones.  Each later call replays the
graph.  On the CPU there is nothing to capture: each later call runs ``fn``
eagerly and copies its outputs into the first call's, so the CPU runs the
code that the card captures.  A capture that fails raises; nothing carries
on eagerly.

Random draws inside ``fn`` come from ``torch.Generator``s registered with
the graph (``generators``): a replay then draws what an eager call from the
generator's state would draw, and advances the generator as that call
would, so ``get_state`` / ``set_state`` keep working across replays.  A
replay writes its tensors without moving their version counters; the
tensors that ``fn`` writes in place and that outlive it (``writes``:
parameters, optimizer state) have their counters bumped after every replay
(no launch), so every cache keyed by a version (``nn/util.py::cached``,
the agent's runtime) sees the write.

A program over a mesh (``mesh=``) holds the mesh's collectives in its
graph.  Its groups must be NCCL on CUDA (``parallel/mesh.py::
Mesh.capturable``; a gloo group copies CUDA tensors through the host, and
the program raises).  Every NCCL communicator the function touches is
created by the eager first call, which runs the same collectives on the
same groups.  Each collective then runs in the graph on its group's
stream, joined to the capturing stream by events.  Every rank must build
and replay its programs in one order, as every rank must call a
collective: a rank that captures or replays alone blocks the others.  In a
process with a process group (a program over a mesh or not) the device is
synchronised before a capture, so that no eager collective is in flight,
and the capture is thread-local (``capture_error_mode="thread_local"``):
the NCCL watchdog thread queries its works' events meanwhile, which a
global capture forbids to every thread.

The hand-written kernels count their launches in Python globals
(``nn/edge_kernel.py``: ``launches``, ``launches_bf16``;
``nn/fused_attention.py``: ``launches``), which a capture bumps without
running anything and a replay does not bump.  A program takes each
capture's count back off the counters and adds it again at every replay, so
they keep counting the kernels that ran on the device: the warmup pass's,
and those of every replay.
"""
from __future__ import annotations

import dataclasses
import gc
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from .nn import edge_kernel as _ek
from .nn import fused_attention as _fa
from .parallel.mesh import Mesh, require_capturable
from .utils.profiling import span

__all__ = ["Program", "launch_counts", "add_launches", "tensors_of", "copy_into", "pool_bytes"]

_SIDE_STREAMS: Dict[torch.device, "torch.cuda.Stream"] = {}


def launch_counts() -> Tuple[int, int, int]:
    """The kernel launch counters: (K1 float32, K2 mixed bfloat16, K3)."""
    return _ek.launches, _ek.launches_bf16, _fa.launches


def add_launches(delta: Tuple[int, int, int]) -> None:
    _ek.launches += delta[0]
    _ek.launches_bf16 += delta[1]
    _fa.launches += delta[2]


def tensors_of(tree: Any) -> List[torch.Tensor]:
    """The tensors of a tree of tensors, lists, tuples, dataclasses and
    None, in order."""
    if tree is None:
        return []
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, (list, tuple)):
        return [t for item in tree for t in tensors_of(item)]
    if dataclasses.is_dataclass(tree):
        return [t for f in dataclasses.fields(tree) for t in tensors_of(getattr(tree, f.name))]
    raise TypeError(f"not a tree of tensors: {type(tree).__name__}")


def copy_into(dst: Any, src: Any) -> None:
    """Copy every tensor of ``src`` into the tensor at its place in ``dst``
    (trees of the same structure).  A tensor that is its own destination
    (an output that is a parameter or a static input) is left alone, so no
    parameter's version counter moves."""
    a, b = tensors_of(dst), tensors_of(src)
    if len(a) != len(b):
        raise ValueError("copy_into: the trees differ")
    for x, y in zip(a, b):
        if x.data_ptr() != y.data_ptr() or x.stride() != y.stride() or x.shape != y.shape:
            x.copy_(y)


def pool_bytes(pool: Optional[tuple]) -> Optional[int]:
    """Device memory held by the graph pool ``pool`` (None on the CPU)."""
    if pool is None:
        return None
    segments = torch.cuda.memory_snapshot()
    return sum(s["total_size"] for s in segments if tuple(s.get("segment_pool_id", ())) == tuple(pool))


def _side_stream(device: torch.device) -> "torch.cuda.Stream":
    s = _SIDE_STREAMS.get(device)
    if s is None:
        s = _SIDE_STREAMS[device] = torch.cuda.Stream(device)
    return s


class Program:
    """``fn`` run once now and captured on CUDA (see the module docstring);
    call it to run it again.  ``out`` holds the static outputs, ``delta``
    the kernel launches of one run, ``capture_s`` the seconds of the capture
    (0 on the CPU).  ``generators``: those that ``fn`` draws from;
    ``writes``: the tensors whose version counters a replay bumps;
    ``mesh``: the mesh whose collectives ``fn`` runs; ``entry`` and
    ``shape`` name the program in its ``graphs.build`` span."""

    def __init__(self, fn: Callable[[], Any], device: torch.device, pool: Optional[tuple] = None,
                 generators: Sequence[torch.Generator] = (), writes: Sequence[torch.Tensor] = (),
                 mesh: Optional[Mesh] = None, entry: str = "", shape: Any = None):
        require_capturable(mesh, device, "graphs.Program")
        with span("graphs.build", device_work=True, entry=entry, shape=shape) as build:
            self._build(fn, device, pool, generators, writes, mesh)
            build.attrs["capture_s"] = self.capture_s

    def _build(self, fn, device, pool, generators, writes, mesh) -> None:
        self.fn = fn
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.writes = list(writes)
        self.capture_s = 0.0
        if device.type != "cuda":
            before = launch_counts()
            self.out = fn()
            self.delta = tuple(a - b for a, b in zip(launch_counts(), before))
            return
        side, main = _side_stream(device), torch.cuda.current_stream(device)
        side.wait_stream(main)
        with torch.cuda.stream(side):
            first = fn()
        main.wait_stream(side)
        grouped = dist.is_initialized()
        if grouped:  # no eager collective in flight while capturing
            torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        graph = torch.cuda.CUDAGraph()
        for g in generators:
            graph.register_generator_state(g)
        warm = launch_counts()
        # no garbage collection while capturing: freeing another graph then (a destroyed runtime's, say) is an
        # operation a capture forbids, and it invalidates the capture
        collecting = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.graph(graph, pool=pool,
                                  capture_error_mode="thread_local" if grouped else "global"):
                out = fn()
        finally:
            if collecting:
                gc.enable()
            captured = tuple(a - b for a, b in zip(launch_counts(), warm))
            add_launches(tuple(-d for d in captured))
        self.graph, self.out, self.delta = graph, out, captured
        copy_into(out, first)
        self.capture_s = time.perf_counter() - t0

    def __call__(self) -> Any:
        if self.graph is None:
            copy_into(self.out, self.fn())
        else:
            self.graph.replay()
            add_launches(self.delta)
            if self.writes:
                torch.autograd.graph.increment_version(self.writes)
        return self.out
