"""Four-card measurements of the port's multi-device paths (the counterpart
of ``__graft_entry__.py::dryrun_multichip``), one rank a card over NCCL:

    python -m torch.distributed.run --nproc-per-node 4 tools/torch_multichip.py [--out FILE]

(a) the seed-sharded ``pick_lowres`` stage (``DiffusionEdfAgent(mesh=)``),
    128 seeds x 100 steps on ``kernel`` with ``chip_smoke.py``'s scene and
    schedule: pose-steps/s on all ranks against rank 0 alone on the same 128
    seeds, and the final-pose drift between the two (same seeds and noise);
(b) one ``place_lowres`` score (32 seeds, the served preprocessing,
    ``chip_smoke.place_clouds``) with the scene sharded over a (data, model)
    mesh of (1, 4) and of (2, 2): ms a score and peak memory per rank
    against the replicated score on rank 0 alone, its error, the cap-bound
    query rows and the valid key points of every scene block;
(c) the same score with its query rows sharded over all ranks;
(d) ms a data-parallel ``pick_lowres`` train step (8 synthetic demos,
    dropout on) on all ranks against rank 0 alone.

Every time is the median of ``--reps`` runs, each run's time printed too;
rank 0 prints one JSON object as its last line and writes it to ``--out``.
The kernels are built by rank 0 before the others load them.  ``--device
cpu`` (gloo, the kernels' plain versions) with small ``--seeds``,
``--stage-steps`` and ``--train-steps`` rehearses the script on the host;
its times are the host's, not the card's.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch
import torch.distributed as dist
import yaml

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402
from diffusion_edf_tpu_torch.agent import DiffusionEdfAgent, load_model_bundle  # noqa: E402
from diffusion_edf_tpu_torch.nn import cuda_build  # noqa: E402
from diffusion_edf_tpu_torch.parallel.distributed import initialize_distributed  # noqa: E402
from diffusion_edf_tpu_torch.parallel.mesh import make_mesh, use_mesh  # noqa: E402
from diffusion_edf_tpu_torch.parallel.sharded import (  # noqa: E402
    cap_bound_rows, make_sharded_train_step, scene_sharded_score_fn, valid_points_by_block,
)
from diffusion_edf_tpu_torch.train.data import pad_pointcloud  # noqa: E402
from diffusion_edf_tpu_torch.train.factory import build_score_model  # noqa: E402
from diffusion_edf_tpu_torch.train.synthetic import make_synthetic_dataset  # noqa: E402
from diffusion_edf_tpu_torch.train.trainer import DiffusionEdfTrainer, load_configs  # noqa: E402
from diffusion_edf_tpu_torch.weights import load_params_npz  # noqa: E402

PLACE = os.path.join(cs.CONFIGS, "place_lowres")


def sync():
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()


def timed(fn):
    sync()
    t = time.perf_counter()
    out = fn()
    sync()
    return out, time.perf_counter() - t


def gathered(x: float):
    """``x`` of every rank, in rank order."""
    out = [None] * dist.get_world_size()
    dist.all_gather_object(out, x)
    return out


def on_rank0(fn):
    """``fn()`` on rank 0 while the others wait."""
    out = fn() if dist.get_rank() == 0 else None
    dist.barrier()
    return out


def peak(fn):
    """(result, seconds, peak GB above the memory held before; None on the
    host)."""
    if not torch.cuda.is_initialized():
        return (*timed(fn), None)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out, s = timed(fn)
    return out, s, (torch.cuda.max_memory_allocated() - base) / 1e9


def seed_sharded_stage(mesh, dev, reps, n_seeds, n_steps):
    bundle = load_model_bundle(cs.CONFIG, cs.CHECKPOINT, device=dev)
    pre = load_configs(cs.CONFIG)[0]["preprocess_config"]
    scene, grasp = cs.scene_clouds()
    Ts = cs.seed_poses(n_seeds)
    schedule = dict(cs.SCHEDULE, N_steps_list=[[n_steps // 2, n_steps - n_steps // 2]])

    def run(m):
        agent = DiffusionEdfAgent([bundle], pre, cs.UNPROCESS, preprocess_seed=0, mesh=m)
        traj, _, _, info = agent.sample(scene, grasp, Ts, generator=torch.Generator(device=dev).manual_seed(1),
                                        record_trajectory=False, **schedule)
        return traj[-1], info["rollout_s"][0], info["steps"][0]

    run(mesh)  # warm-up
    one = on_rank0(lambda: [run(None) for _ in range(reps)])
    many = [run(mesh) for _ in range(reps)]
    rec = dict(seeds=n_seeds, steps=many[0][2], world_rollout_s=gathered([r[1] for r in many]))
    if one is not None:
        rec["one_rollout_s"] = [r[1] for r in one]
        rec["one_pose_steps_per_s"] = n_seeds * rec["steps"] / float(np.median(rec["one_rollout_s"]))
        rec["world_pose_steps_per_s"] = n_seeds * rec["steps"] / float(np.median(rec["world_rollout_s"][0]))
        rec["speedup"] = rec["world_pose_steps_per_s"] / rec["one_pose_steps_per_s"]
        rec["drift"] = float(np.abs(many[0][0] - one[0][0]).max())
    return rec


def place_inputs(dev, n_seeds):
    with open(os.path.join(cs.CONFIGS, "preprocess.yaml")) as f:
        pre = yaml.safe_load(f)
    bundle = load_model_bundle(PLACE, os.path.join(cs.CHECKPOINTS, "place_lowres.npz"), device=dev)
    scene, grasp = cs.place_clouds()
    scene_p, grasp_p = DiffusionEdfAgent([], pre["preprocess_config"], pre["unprocess_config"])._prep(scene, grasp)
    with torch.no_grad():
        key_ms = bundle.model.get_key_pcd_multiscale(pad_pointcloud(scene_p, bundle.n_scene_pad, dev))
        query = bundle.model.get_query_pcd(pad_pointcloud(grasp_p, bundle.n_grasp_pad, dev))
    T = torch.as_tensor(cs.seed_poses(n_seeds), device=dev)
    T = torch.cat([T[:, :4], T[:, 4:] * 100.0], dim=-1)
    return bundle, cs.one_request(T, key_ms, query, torch.full((n_seeds,), 0.3, device=dev))


def place_model(dev, **axes):
    _, _, cfg = load_configs(PLACE)
    model = build_score_model(cfg["model_name"], cfg["model_kwargs"], **axes)
    return load_params_npz(model, os.path.join(cs.CHECKPOINTS, "place_lowres.npz")).to(dev).eval()


def sharded_scores(dev, reps, n_seeds):
    world = dist.get_world_size()
    bundle, (T, key_ms, query, t) = place_inputs(dev, n_seeds)

    def score_err(out, ref):
        return max(float((a.cpu() - b).abs().max()) for a, b in zip(out, ref))

    def measure(fn):
        fn()
        runs = [peak(fn) for _ in range(reps)]
        return runs[0][0], [r[1] * 1e3 for r in runs], max(r[2] for r in runs)

    with torch.no_grad():
        rep = on_rank0(lambda: measure(lambda: bundle.model.score(T, key_ms, query, t)))
        ref = [s.cpu() for s in rep[0]] if rep is not None else None
        out = dict(seeds=n_seeds, rows=int(query.mask.sum()) * n_seeds,
                   cap_bound_rows=cap_bound_rows(bundle.model, T, key_ms, query))
        if rep is not None:
            out["replicated"] = dict(ms=rep[1], peak_gb=rep[2], max_abs=max(float(s.abs().max()) for s in ref))
        for shape in ((1, world), (2, world // 2)):
            mesh = make_mesh(axis_names=("data", "model"), shape=shape)
            fn = scene_sharded_score_fn(mesh, place_model(dev, scene_axis_name="model"), key_ms, query)
            res, ms, gb = measure(lambda: fn(T, t))
            blocks = valid_points_by_block(bundle.model, key_ms, shape[1])
            out[f"scene_{shape[0]}x{shape[1]}"] = dict(ms_by_rank=gathered(ms), peak_gb_by_rank=gathered(gb),
                                                      err=score_err(res, ref) if ref is not None else None,
                                                      valid_points_by_block=blocks)
        mesh = make_mesh(axis_names=("data", "model"), shape=(2, world // 2))
        mq = place_model(dev, query_shard_axes=["data", "model"])
        with use_mesh(mesh):
            res, ms, gb = measure(lambda: mq.score(T, key_ms, query, t))
        out["query_all_ranks"] = dict(ms_by_rank=gathered(ms), peak_gb_by_rank=gathered(gb),
                                      err=score_err(res, ref) if ref is not None else None)
    return out


def train_steps(mesh, dev, steps):
    demos = make_synthetic_dataset(n_demos=8, seed=0)

    def trainer():
        tr = DiffusionEdfTrainer(cs.CONFIG, log_dir=os.path.join(ROOT, "build", "multichip", str(dist.get_rank())),
                                 device=dev, seed=0)
        tr.init(demos, checkpoint=cs.CHECKPOINT)
        return tr

    def run(step, batches):
        step(batches[0])  # warm-up
        return [timed(lambda: step(batches[i % len(batches)]))[1] * 1e3 for i in range(steps)]

    def one():
        tr = trainer()
        return run(tr.step, tr.batches)

    one_ms = on_rank0(one)
    tr = trainer()
    many_ms = run(make_sharded_train_step(mesh, tr), tr.batches)
    rec = dict(poses_a_step=tr.n_samples_x_ref * len(tr.time_schedules), world_ms=gathered(many_ms))
    if one_ms is not None:
        rec.update(one_ms=one_ms, one_median_ms=float(np.median(one_ms)),
                   world_median_ms=float(np.median(many_ms)))
    return rec


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--reps", type=int, default=3)
    p.add_argument("--seeds", type=int, default=128, help="(a)'s seeds; (b) and (c) score a quarter of them")
    p.add_argument("--stage-steps", type=int, default=100)
    p.add_argument("--train-steps", type=int, default=10)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    p.add_argument("--out", default=os.path.join(ROOT, "chiprun_out", "multichip.json"))
    args = p.parse_args(argv)
    if not initialize_distributed(device=args.device):
        raise SystemExit("run under torchrun (python -m torch.distributed.run --nproc-per-node N ...)")
    rank, world = dist.get_rank(), dist.get_world_size()
    if args.device == "cuda":
        dev = torch.device("cuda", torch.cuda.current_device())
        if rank == 0:
            cuda_build.build_all()
        dist.barrier()
        cuda_build.build_all()
    else:
        dev = torch.device("cpu")
        torch.set_num_threads(1)
    mesh = make_mesh()
    result = dict(card=cs.card_line() if rank == 0 and args.device == "cuda" else "host (rehearsal)", world=world,
                  backend=dist.get_backend(), torch=torch.__version__)
    t0 = time.perf_counter()
    result["a_seed_sharded_stage"] = seed_sharded_stage(mesh, dev, args.reps, args.seeds, args.stage_steps)
    result["bc_place_scores"] = sharded_scores(dev, args.reps, max(args.seeds // 4, 1))
    result["d_train_step"] = train_steps(mesh, dev, args.train_steps)
    result["seconds"] = time.perf_counter() - t0
    if rank == 0:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
        print(json.dumps(result))
    dist.barrier()
    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
