"""Multi-process initialisation and per-process demo ranges (counterpart of
the JAX package's ``parallel/distributed.py``).

One process per rank: :func:`initialize_distributed` joins the process
group from its arguments or the environment, the JAX package's names
(``COORDINATOR_ADDRESS``, ``NUM_PROCESSES``, ``PROCESS_ID``) or torchrun's
(``MASTER_ADDR`` / ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``), and is a
no-op for a single process.
"""
from __future__ import annotations

import os
from typing import Optional, Tuple, Union

import torch
import torch.distributed as dist

from .mesh import Mesh, make_mesh

__all__ = ["initialize_distributed", "global_mesh", "host_local_demo_slice"]


def _env(*names: str) -> Optional[str]:
    for n in names:
        if os.environ.get(n):
            return os.environ[n]
    return None


def initialize_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    device: Union[str, torch.device] = "cuda",
    backend: Optional[str] = None,
) -> bool:
    """Join the process group; returns whether there is one (False for a
    single process, where nothing is done).

    ``coordinator_address`` is ``host:port`` (a TCP rendezvous) or an
    ``init_method`` URL such as ``file:///path``; under torchrun it is
    ``env://``.  The backend is the
    caller's ``backend``, else ``nccl`` for ``device="cuda"`` and ``gloo``
    for ``"cpu"``; it never changes on its own.  On CUDA each rank takes
    the card ``LOCAL_RANK`` (else its rank) modulo the card count, so two
    ranks on one card share it (which ``nccl`` refuses: pass
    ``backend="gloo"`` there).

    The runtime captures NCCL collectives in CUDA graphs
    (``graphs.Program``).  PyTorch 2.11 with NCCL 2.28 needs no setting
    for that: its defaults (``TORCH_NCCL_ASYNC_ERROR_HANDLING`` among them)
    capture and replay exactly, and ``chip_smoke.py`` phase 13d checks it on
    every run; the program synchronises before a capture and captures
    thread-locally, so the watchdog's event queries do not meet it."""
    if dist.is_initialized():
        return True
    addr = coordinator_address or _env("COORDINATOR_ADDRESS")
    if addr is None and _env("MASTER_ADDR"):
        addr = "env://"  # torchrun's rendezvous (MASTER_ADDR / MASTER_PORT, or its agent's store)
    world = int(num_processes or _env("NUM_PROCESSES", "WORLD_SIZE") or 1)
    rank = int(process_id if process_id is not None else (_env("PROCESS_ID", "RANK") or 0))
    if addr is None or world == 1:
        return False
    device = torch.device(device)
    backend = backend or {"cuda": "nccl", "cpu": "gloo"}[device.type]
    if device.type == "cuda":
        torch.cuda.set_device(int(_env("LOCAL_RANK") or rank) % torch.cuda.device_count())
    init_method = addr if "://" in addr else f"tcp://{addr}"
    dist.init_process_group(backend, init_method=init_method, world_size=world, rank=rank)
    return True


def global_mesh(axis_names: Tuple[str, ...] = ("data",)) -> Mesh:
    """A mesh over every rank of every process (after initialisation)."""
    return make_mesh(axis_names=axis_names)


def host_local_demo_slice(n_demos: int) -> range:
    """The contiguous demo range this process owns (demo-level data
    parallelism): ``ceil(n_demos / processes)`` demos a process, the last
    range shorter."""
    p = dist.get_rank() if dist.is_initialized() else 0
    n = dist.get_world_size() if dist.is_initialized() else 1
    per = (n_demos + n - 1) // n
    return range(p * per, min((p + 1) * per, n_demos))
