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

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from diffusion_edf_tpu_torch.data import FeaturedPoints, stack_points
from diffusion_edf_tpu_torch.diffusion.langevin import LangevinSchedule
from diffusion_edf_tpu_torch.graphs import Program
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


def _agent(cfg_dir, scene, grasp, Ts_init, seed, mesh_shape, critic_dir=None):
    """The agent's trajectory (through its runtime) on the mesh, or in one
    process without ``mesh_shape``; with ``critic_dir``, also a two-stage
    cascade with that critic through the runtime and eagerly
    (``use_runtime=False``) on the mesh, ``sample`` and ``sample_batch`` of
    two requests, and the runtimes' entries after a ``warmup`` and after
    the ``sample`` of its shapes."""
    from diffusion_edf_tpu_torch.agent import DiffusionEdfAgent, load_model_bundle

    mesh = make_mesh(axis_names=("data",), shape=mesh_shape) if mesh_shape else None
    bundle = load_model_bundle(cfg_dir, n_scene_pad=256, n_grasp_pad=64, device="cpu")
    agent = DiffusionEdfAgent([bundle], [], [], critic=None, mesh=mesh)
    traj, _, _, _ = agent.sample(scene, grasp, Ts_init, N_steps_list=[[4]], timesteps_list=[[0.02]],
                                 temperatures_list=[[1.0]], diffusion_schedules_list=[[[1.0, 0.1]]],
                                 generator=torch.Generator().manual_seed(seed))
    out = {"traj": traj}
    if critic_dir is None:
        return out
    critic = load_model_bundle(critic_dir, n_scene_pad=256, n_grasp_pad=64, device="cpu", init_seed=5)
    high = load_model_bundle(cfg_dir, n_scene_pad=256, n_grasp_pad=64, device="cpu", init_seed=4)
    cfg = dict(N_steps_list=[[2, 1], [1, 1]], timesteps_list=[[0.04, 0.02], [0.02, 0.01]],
               temperatures_list=[[1.0, 0.0], [1.0, 1.0]],
               diffusion_schedules_list=[[[1.0, 0.15], [0.15, 0.09]], [[0.09, 0.03], [0.03, 0.012]]])
    agents = [DiffusionEdfAgent([bundle, high], [], [], critic=critic, mesh=mesh, use_runtime=u) for u in (True, False)]
    runtimes = agents[0]._runtimes + [agents[0]._critic_runtime]
    agents[0].warmup(scene, grasp, n_seeds=len(Ts_init), diffusion_configs=cfg, record_trajectory=True)
    out["sizes_warm"] = [rt.cache_sizes() for rt in runtimes]
    for name, a in zip(("runtime", "eager"), agents):
        traj, _, _, info = a.sample(scene, grasp, Ts_init, generator=torch.Generator().manual_seed(seed + 1), **cfg)
        out[name] = {"traj": traj, "energy": info["energy"]}
        if name == "runtime":
            out["sizes_after"] = [rt.cache_sizes() for rt in runtimes]
        batch, binfo = a.sample_batch([scene, scene], [grasp, grasp], np.stack([Ts_init, Ts_init[::-1]]),
                                      generator=torch.Generator().manual_seed(seed + 2), n_seeds=[len(Ts_init), 3],
                                      **cfg)
        out[name].update(batch=batch, batch_energy=binfo["energy"])
    out["rollout_entries"] = sorted(agents[0]._runtimes[0].entries["rollout"])
    return out


def _model(cfg, state, **axes):
    """The tiny model of ``cfg`` with its weights ``state``, built with the
    mesh axis names ``axes``."""
    model = build_score_model(cfg["model_name"], cfg["model_kwargs"], **axes)
    model.load_state_dict(state)
    return model.eval()


def _scores(cfg, state, scene, Ts, time, mesh_shape, critic=False):
    """The query-sharded and the scene-sharded score (and, for a critic,
    energy) of one request on a (data, model) mesh, eagerly and through the
    runtime (the scene-sharded score's programs; the query-sharded score in
    one ``Program``), on the poses and on the poses reversed; the gloo
    mesh's capturability and a CUDA program's refusal of it."""
    mesh = make_mesh(axis_names=("data", "model"), shape=mesh_shape)
    pcd = FeaturedPoints(*(torch.as_tensor(a) for a in scene))
    Ts, time = torch.as_tensor(Ts)[None], torch.as_tensor(time)[None]
    out = {"capturable": {"cuda": mesh.capturable("cuda"), "cpu": mesh.capturable("cpu")},
           "backends": mesh.backends()}
    try:  # a gloo mesh cannot run inside a CUDA graph: a program over it on CUDA refuses before it runs anything
        Program(lambda: None, torch.device("cuda"), mesh=mesh)
    except RuntimeError as e:
        out["refused"] = str(e)
    mq = _model(cfg, state, query_shard_axes=["data", "model"])
    ms = _model(cfg, state, scene_axis_name="model")
    methods = ("score", "energy") if critic else ("score",)
    with torch.no_grad():
        key_ms = [stack_points([p]) for p in ms.get_key_pcd_multiscale(pcd)]
        query = stack_points([ms.get_query_pcd(pcd)])
        for method in methods:
            sfx = "" if method == "score" else "_energy"
            with use_mesh(mesh):
                out["query" + sfx] = getattr(mq, method)(Ts, key_ms, query, time)
            out["scene" + sfx] = scene_sharded_score_fn(mesh, ms, key_ms, query, method=method,
                                                        use_runtime=False)(Ts, time)
            # the runtime: the scene-sharded score's own programs, the query-sharded score in one Program, each
            # called on the poses and then (a replay on the card) on other poses
            scene_fn = scene_sharded_score_fn(mesh, ms, key_ms, query, method=method)
            T_s, t_s = Ts.clone(), time.clone()

            def query_fn(method=method):
                with use_mesh(mesh):
                    return getattr(mq, method)(T_s, key_ms, query, t_s)
            program = Program(query_fn, torch.device("cpu"), mesh=mesh)
            out["runtime" + sfx] = {"scene": scene_fn(Ts, time), "query": _clone(program.out)}  # replays overwrite it
            T_s.copy_(Ts.flip(1))
            t_s.copy_(time.flip(1))
            with use_mesh(mesh):
                out["eager_flipped" + sfx] = {"query": getattr(mq, method)(T_s, key_ms, query, t_s)}
            out["eager_flipped" + sfx]["scene"] = scene_sharded_score_fn(
                mesh, ms, key_ms, query, method=method, use_runtime=False)(T_s, t_s)
            out["runtime_flipped" + sfx] = {"scene": scene_fn(T_s, t_s), "query": program()}
            out["entries" + sfx] = len(scene_fn.entries)
    return out


def _clone(x):
    return x.clone() if isinstance(x, torch.Tensor) else tuple(t.clone() for t in x)


def _train(cfg_dir, demos, epochs=0):
    """One data-parallel ``loss_and_grads`` on the first draw, then one
    data-parallel step (through the trainer's runtime) on the same draw: its
    statistics, the gradients its update was given, and the parameters and
    EMA after it.  With ``epochs``, also that many data-parallel epochs of
    a trainer through its runtime and of one stepping eagerly
    (``use_runtime=False``) from the same state: every epoch's statistics,
    and the parameters, EMA and optimizer state after them."""
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
    for use_runtime in (True, False) if epochs else ():
        tr = DiffusionEdfTrainer(cfg_dir, log_dir=os.path.join(cfg_dir, f"log{mesh.rank}_{use_runtime}"),
                                 n_scene_pad=512, n_grasp_pad=160, device="cpu", use_runtime=use_runtime)
        tr.init(demos)
        make_sharded_train_step(mesh, tr)
        stats = [tr.train_epoch(mesh=mesh) for _ in range(epochs)]
        out[f"epochs_{'runtime' if use_runtime else 'eager'}"] = dict(
            stats=stats, params=flat_arrays(tr.model), ema=flat_arrays(tr.model, tr.ema),
            opt={k: [t.clone() for t in v] for k, v in tr.optimizer.state_arrays().items()},
            count=int(tr.optimizer.count), entries=tr.cache_size())
    return out


CASES = {"langevin": _langevin, "agent": _agent, "scores": _scores, "train": _train}
