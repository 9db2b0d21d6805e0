"""The port's ``parallel/distributed.py`` in two processes on the CPU, as
``tests/test_distributed.py`` runs the JAX package's: the process group
joined from the environment (the JAX package's variable names, and
torchrun's), a cross-process sum, a mesh over both processes and
``host_local_demo_slice(10)``; and the no-op of a single process."""
import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]

_WORKER = r"""
import json, sys
import torch
import torch.distributed as dist
sys.path.insert(0, sys.argv[1])
from diffusion_edf_tpu_torch.parallel.distributed import global_mesh, host_local_demo_slice, initialize_distributed
from diffusion_edf_tpu_torch.parallel.mesh import gather_batch, shard_batch
assert initialize_distributed(device="cpu")
mesh = global_mesh()
x = torch.full((2,), float(dist.get_rank() + 1))
dist.all_reduce(x)
block, n = shard_batch(mesh, torch.arange(5.0))
sl = host_local_demo_slice(10)
print(json.dumps({"rank": dist.get_rank(), "world": dist.get_world_size(), "backend": dist.get_backend(),
                  "total": x.tolist(), "mesh": mesh.axis_size("data"), "block": block.tolist(),
                  "gathered": gather_batch(mesh, block, n).tolist(), "slice": [sl.start, sl.stop]}))
dist.destroy_process_group()
"""


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _env(names, tmp_path, rank):
    if names == "jax":
        return {"COORDINATOR_ADDRESS": f"file://{tmp_path}/rendezvous", "NUM_PROCESSES": "2", "PROCESS_ID": str(rank)}
    return {"MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(_PORT), "WORLD_SIZE": "2", "RANK": str(rank)}


_PORT = _free_port()


@pytest.mark.parametrize("names", ["jax", "torchrun"])
def test_two_process_group(tmp_path, names):
    base = {k: v for k, v in os.environ.items()
            if k not in ("COORDINATOR_ADDRESS", "NUM_PROCESSES", "PROCESS_ID", "MASTER_ADDR", "MASTER_PORT",
                         "WORLD_SIZE", "RANK", "LOCAL_RANK")}
    procs = [subprocess.Popen([sys.executable, "-c", _WORKER, str(REPO)], env={**base, **_env(names, tmp_path, r)},
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True) for r in range(2)]
    outs = []
    for p in procs:
        out, err = p.communicate(timeout=120)
        assert p.returncode == 0, err[-3000:]
        outs.append(json.loads(out.strip().splitlines()[-1]))
    outs.sort(key=lambda o: o["rank"])
    for o in outs:
        assert o["world"] == 2 and o["backend"] == "gloo" and o["mesh"] == 2
        assert o["total"] == [3.0, 3.0]
        assert o["gathered"] == [0.0, 1.0, 2.0, 3.0, 4.0]
    assert [o["block"] for o in outs] == [[0.0, 1.0, 2.0], [3.0, 4.0, 4.0]]
    assert [tuple(o["slice"]) for o in outs] == [(0, 5), (5, 10)]


def test_single_process_is_a_no_op(monkeypatch):
    import torch.distributed as dist

    from diffusion_edf_tpu_torch.parallel.distributed import host_local_demo_slice, initialize_distributed

    for k in ("COORDINATOR_ADDRESS", "MASTER_ADDR", "NUM_PROCESSES", "WORLD_SIZE"):
        monkeypatch.delenv(k, raising=False)
    assert initialize_distributed(device="cpu") is False and not dist.is_initialized()
    assert initialize_distributed("127.0.0.1:1", 1, 0, device="cpu") is False and not dist.is_initialized()
    assert host_local_demo_slice(10) == range(0, 10)
