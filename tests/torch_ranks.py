"""Rank entry points of the port's multi-process tests (torch only: spawned
ranks import this module, never a test file that imports JAX).

:func:`spawn` starts ``world`` processes on the CPU, each of which joins a
gloo process group through the port's ``initialize_distributed`` (a
``file://`` rendezvous in the test's directory, so concurrent test workers
never race for a port), runs one case and saves its result; the results
come back in rank order."""
from __future__ import annotations

import os
import uuid
from pathlib import Path
from typing import Dict, List

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from diffusion_edf_tpu_torch.data import FeaturedPoints, stack_points
from diffusion_edf_tpu_torch.diffusion.langevin import LangevinSchedule
from diffusion_edf_tpu_torch.parallel.distributed import initialize_distributed
from diffusion_edf_tpu_torch.parallel.mesh import make_mesh, use_mesh
from diffusion_edf_tpu_torch.parallel.sharded import (
    make_sharded_train_step, scene_sharded_score_fn, sharded_langevin_sample,
)
from diffusion_edf_tpu_torch.train.factory import build_score_model
from diffusion_edf_tpu_torch.weights import flat_arrays


def spawn(case: str, world: int, tmp: Path, **kw) -> List[Dict]:
    run = Path(tmp) / f"ranks_{uuid.uuid4().hex[:8]}"
    run.mkdir(parents=True)
    mp.spawn(_main, args=(world, str(run), case, kw), nprocs=world, join=True)
    return [torch.load(run / f"rank{r}.pt", weights_only=False) for r in range(world)]


def _main(rank: int, world: int, run: str, case: str, kw: Dict) -> None:
    torch.set_num_threads(1)
    assert initialize_distributed(f"file://{run}/rendezvous", world, rank, device="cpu")
    try:
        out = CASES[case](**kw)
        torch.save(out, os.path.join(run, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def toy_score(T, t):
    """The analytic score of ``tests/test_parallel.py``: poses pulled toward
    the identity."""
    return -T[..., 1:4], -T[..., 4:]


def _langevin(T0, schedule, seed):
    mesh = make_mesh()
    g = torch.Generator().manual_seed(seed)
    T, traj = sharded_langevin_sample(mesh, toy_score, g, torch.as_tensor(T0), LangevinSchedule(*schedule), 1.0, 1.0,
                                      record_trajectory=True)
    return {"T": T, "traj": traj}


def _agent(cfg_dir, scene, grasp, Ts_init, seed, mesh_shape):
    from diffusion_edf_tpu_torch.agent import DiffusionEdfAgent, load_model_bundle

    mesh = make_mesh(axis_names=("data",), shape=mesh_shape) if mesh_shape else None
    bundle = load_model_bundle(cfg_dir, n_scene_pad=256, n_grasp_pad=64, device="cpu")
    agent = DiffusionEdfAgent([bundle], [], [], critic=None, mesh=mesh)
    traj, _, _, _ = agent.sample(scene, grasp, Ts_init, N_steps_list=[[4]], timesteps_list=[[0.02]],
                                 temperatures_list=[[1.0]], diffusion_schedules_list=[[[1.0, 0.1]]],
                                 generator=torch.Generator().manual_seed(seed))
    return {"traj": traj}


def _model(cfg, state, **axes):
    """The tiny model of ``cfg`` with its weights ``state``, built with the
    mesh axis names ``axes``."""
    model = build_score_model(cfg["model_name"], cfg["model_kwargs"], **axes)
    model.load_state_dict(state)
    return model.eval()


def _scores(cfg, state, scene, Ts, time, mesh_shape, critic=False):
    """The query-sharded and the scene-sharded score (and, for a critic,
    energy) of one request on a (data, model) mesh."""
    mesh = make_mesh(axis_names=("data", "model"), shape=mesh_shape)
    pcd = FeaturedPoints(*(torch.as_tensor(a) for a in scene))
    Ts, time = torch.as_tensor(Ts)[None], torch.as_tensor(time)[None]
    out = {}
    mq = _model(cfg, state, query_shard_axes=["data", "model"])
    ms = _model(cfg, state, scene_axis_name="model")
    with torch.no_grad():
        key_ms = [stack_points([p]) for p in ms.get_key_pcd_multiscale(pcd)]
        query = stack_points([ms.get_query_pcd(pcd)])
        with use_mesh(mesh):
            out["query"] = mq.score(Ts, key_ms, query, time)
            if critic:
                out["query_energy"] = mq.energy(Ts, key_ms, query, time)
        out["scene"] = scene_sharded_score_fn(mesh, ms, key_ms, query)(Ts, time)
        if critic:
            out["scene_energy"] = scene_sharded_score_fn(mesh, ms, key_ms, query, method="energy")(Ts, time)
    return out


def _train(cfg_dir, demos):
    """One data-parallel ``loss_and_grads`` on the first draw, then one
    data-parallel step on the same draw: its statistics, the gradients its
    update was given, and the parameters and EMA after it."""
    from diffusion_edf_tpu_torch.train.trainer import DiffusionEdfTrainer

    mesh = make_mesh()
    tr = DiffusionEdfTrainer(cfg_dir, log_dir=os.path.join(cfg_dir, f"log{mesh.rank}"), n_scene_pad=512,
                             n_grasp_pad=160, device="cpu")
    tr.init(demos)
    step = make_sharded_train_step(mesh, tr)
    state = tr.generator.get_state()
    inputs = tr.draw_step(tr.batches[0])
    tr.model.train()
    loss, stats, grads = tr.loss_and_grads(inputs, mesh)
    out = {"inputs": inputs, "loss": float(loss.detach()), "stats": {k: float(v.detach()) for k, v in stats.items()},
           "grads": flat_arrays(tr.model, grads)}
    applied = []
    apply_grads = tr.apply_grads
    tr.apply_grads = lambda grads: (applied.append([g.detach().clone() for g in grads]), apply_grads(grads))
    tr.generator.set_state(state)  # the step draws the same inputs again
    out["step_stats"] = step(tr.batches[0])
    out["step_grads"], = applied
    out["params"] = flat_arrays(tr.model)
    out["ema"] = flat_arrays(tr.model, tr.ema)
    return out


CASES = {"langevin": _langevin, "agent": _agent, "scores": _scores, "train": _train}
