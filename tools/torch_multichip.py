"""Four-card measurements of the port's multi-device paths (the counterpart
of ``__graft_entry__.py::dryrun_multichip``), one rank a card over NCCL:

    python -m torch.distributed.run --nproc-per-node 4 tools/torch_multichip.py [--out FILE]

Each path runs compiled (the runtime: CUDA graphs with the NCCL collectives
inside them) and eagerly (``use_runtime=False``) on the same inputs, and is
timed against one card's compiled path (rank 0 alone, no mesh):

(a) the seed-sharded ``pick_lowres`` stage (``DiffusionEdfAgent(mesh=)``),
    128 seeds x 100 steps on ``kernel`` with ``chip_smoke.py``'s scene and
    schedule and the served preprocessing (``preprocess.yaml``):
    pose-steps/s, ms a step and peak memory a rank; gate: the
    compiled final poses within ``POSE_EQUAL`` of the first eager run's
    (or twice the two eager runs' difference), K1 launched on every rank;
(b) one ``place_lowres`` score (32 seeds, the served preprocessing,
    ``chip_smoke.place_clouds``) with the scene sharded over a (data, model)
    mesh of (1, 4) and of (2, 2) (``scene_sharded_score_fn``): ms a score and
    peak memory a rank; gate: compiled against eager within
    ``chip_smoke.KERNEL_GATE``, K1 launched on every rank; the error against
    the replicated score, the cap-bound query rows and the valid key points
    of every scene block are reported;
(c) the same score with its query rows sharded over all ranks
    (``query_shard_axes``) in one ``graphs.Program``, on ``kernel`` and
    ``fused``: the same gate, K1 (K3 on ``fused``) launched on every rank;
(d) a data-parallel ``pick_lowres`` epoch (8 synthetic demos, dropout on,
    ``make_sharded_train_step`` and ``train_epoch(mesh=)``) from the shipped
    checkpoint: ms a train step and peak memory a rank; gate:
    ``chip_smoke.spread_gate`` over two eager epochs with
    ``chip_smoke.TRAIN_GATES`` as its floor (phase 10f's), the parameters
    equal on every rank; the compiled four-card epoch against one card's
    compiled epoch is reported (one process's step when the step's 20 poses
    split evenly).

Every time is the median of ``--reps`` runs, each run's time printed too;
rank 0 prints one JSON object as its last line and writes it to ``--out``.
Exits non-zero if a gate fails.  The kernels are built by rank 0 before the
others load them.  ``--device cpu`` (gloo, eager programs, the kernels'
plain versions) with small ``--seeds``, ``--stage-steps``, ``--demos`` and
``--reps`` rehearses the script on the host; its times are the host's, not
the card's.
"""
from __future__ import annotations

import argparse
import faulthandler
import hashlib
import json
import os
import shutil
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
from diffusion_edf_tpu_torch.graphs import Program  # noqa: E402
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
from diffusion_edf_tpu_torch.weights import flat_arrays, load_params_npz  # noqa: E402

PLACE = os.path.join(cs.CONFIGS, "place_lowres")
POSE_EQUAL = 1e-5  # (a): the same kernels in the same order on each rank's block; phase 15's runtime gate
FAILURES: list = []


def sync():
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()


def timed(fn):
    sync()
    t = time.perf_counter()
    out = fn()
    sync()
    return out, time.perf_counter() - t


def gathered(x):
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


def gate(label: str, ok: bool, detail) -> None:
    """Record a gate on every rank (each rank's verdict is gathered, so all
    agree); a failed gate makes the script exit non-zero."""
    oks = gathered(bool(ok))
    if not all(oks):
        FAILURES.append(f"{label}: {detail} (ok by rank {oks})")
        if dist.get_rank() == 0:
            print(f"GATE FAILED {label}: {detail} (ok by rank {oks})", flush=True)


def launched(fn, counter: str):
    """``fn()``'s result and the launches of ``counter`` it made on this rank."""
    cs.reset_counters()
    out = fn()
    sync()
    return out, cs.counters()[counter]


def seed_sharded_stage(mesh, dev, reps, n_seeds, n_steps):
    bundle = load_model_bundle(cs.CONFIG, cs.CHECKPOINT, device=dev)
    with open(os.path.join(cs.CONFIGS, "preprocess.yaml")) as f:  # the served preprocessing: no jitter, so every
        pre = yaml.safe_load(f)["preprocess_config"]  # call of an agent samples the same clouds
    scene, grasp = cs.scene_clouds()
    Ts = cs.seed_poses(n_seeds)
    schedule = dict(cs.SCHEDULE, N_steps_list=[[n_steps // 2, n_steps - n_steps // 2]])

    def agent(m, use_runtime):
        return DiffusionEdfAgent([bundle], pre, cs.UNPROCESS, preprocess_seed=0, mesh=m, use_runtime=use_runtime)

    def run(a):
        traj, _, _, info = a.sample(scene, grasp, Ts, generator=torch.Generator(device=dev).manual_seed(1),
                                    record_trajectory=False, **schedule)
        return traj[-1], info["rollout_s"][0], info["steps"][0]

    def measure(a):
        """The first (capturing) run, then ``reps`` timed runs: (runs, s and peak GB of the first, pool GB)."""
        _, first, gb = peak(lambda: run(a))
        runs = [timed(lambda: run(a))[0] for _ in range(reps)]
        return runs, first, gb, (a._runtimes[0].pool_bytes() or 0) / 1e9 if a.use_runtime else None

    def rates(runs):
        steps = runs[0][2]
        med = float(np.median([r[1] for r in runs]))
        return dict(rollout_s=[r[1] for r in runs], ms_a_step=med / steps * 1e3, pose_steps_per_s=n_seeds * steps / med)

    compiled = agent(mesh, True)
    runs_c, first_c, gb_c, pool_c = measure(compiled)
    _, k1 = launched(lambda: run(compiled), "edge_kernel")
    runs_e, first_e, gb_e, _ = measure(agent(mesh, False))
    one = on_rank0(lambda: measure(agent(None, True)))
    rec = dict(seeds=n_seeds, steps=runs_c[0][2], k1_launches_by_rank=gathered(k1),
               compiled=dict(rates(runs_c), first_call_s=first_c, first_call_peak_gb_by_rank=gathered(gb_c),
                             pool_gb_by_rank=gathered(pool_c)),
               eager=dict(rates(runs_e), first_call_s=first_e, peak_gb_by_rank=gathered(gb_e)))
    spread = float(np.abs(runs_e[0][0] - runs_e[-1][0]).max())
    drift = float(np.abs(runs_c[0][0] - runs_e[0][0]).max())
    rec.update(compiled_vs_eager=drift, eager_spread=spread)
    if one is not None:
        rec["one_card_compiled"] = dict(rates(one[0]), first_call_s=one[1], first_call_peak_gb=one[2],
                                        pool_gb=one[3])
        rec["speedup_vs_one_card_compiled"] = (rec["compiled"]["pose_steps_per_s"]
                                               / rec["one_card_compiled"]["pose_steps_per_s"])
        rec["four_vs_one_card"] = float(np.abs(runs_c[0][0] - one[0][0][0]).max())
    gate("a: seed-sharded stage, compiled against eager", drift <= max(POSE_EQUAL, 2 * spread) and
         np.isfinite(runs_c[0][0]).all(), f"final-pose max-abs {drift:.3g}, eager spread {spread:.3g}")
    gate("a: K1 on every rank", k1 > 0 or dev.type != "cuda", f"K1 launches {k1}")  # the host runs plain versions
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


def place_model(dev, edge_impl=None, **axes):
    _, _, cfg = load_configs(PLACE)
    model = build_score_model(cfg["model_name"], cfg["model_kwargs"], edge_impl=edge_impl, **axes)
    return load_params_npz(model, os.path.join(cs.CHECKPOINTS, "place_lowres.npz")).to(dev).eval()


def sharded_scores(dev, reps, n_seeds):
    world = dist.get_world_size()
    bundle, (T, key_ms, query, t) = place_inputs(dev, n_seeds)

    def err(out, ref):
        return max(float((a - b).abs().max()) for a, b in zip(out, ref))

    def measure(fn):
        """The first call (for a compiled path the capture), then ``reps``
        timed calls: (last result, ms each, peak GB of the first call)."""
        gb = peak(fn)[2]
        runs = [timed(fn) for _ in range(reps)]
        return [o.clone() for o in runs[-1][0]], [r[1] * 1e3 for r in runs], gb

    def row(ms, gb, **kw):
        return dict(ms_by_rank=gathered(ms), median_ms_by_rank=gathered(float(np.median(ms))),
                    first_call_peak_gb_by_rank=gathered(gb), **kw)

    def compare(label, compiled, eager, counter):
        """Compiled against eager on every rank, the counter's launches on every rank: the record."""
        res_c, ms_c, gb_c = measure(compiled)
        _, n = launched(compiled, counter)
        res_e, ms_e, gb_e = measure(eager)
        e = err(res_c, res_e)
        gate(f"{label}: compiled against eager", e <= cs.KERNEL_GATE, f"max-abs {e:.3g}")
        gate(f"{label}: {counter} on every rank", n > 0 or dev.type != "cuda", f"launches {n}")
        vs_ref = err(res_c, [r.to(dev) for r in ref]) if ref is not None else None
        return dict(compiled=row(ms_c, gb_c), eager=row(ms_e, gb_e), compiled_vs_eager=gathered(e),
                    launches_by_rank=gathered(n), compiled_vs_replicated=vs_ref)

    with torch.no_grad():
        def replicated():
            T_s, t_s = T.clone(), t.clone()
            program = Program(lambda: bundle.model.score(T_s, key_ms, query, t_s), dev,
                              torch.cuda.graph_pool_handle() if dev.type == "cuda" else None)
            res_c, ms_c, gb_c = measure(program)
            res_e, ms_e, gb_e = measure(lambda: bundle.model.score(T, key_ms, query, t))
            return dict(result=[r.cpu() for r in res_c], compiled_ms=ms_c, compiled_first_call_peak_gb=gb_c,
                        eager_ms=ms_e, eager_peak_gb=gb_e, compiled_vs_eager=err(res_c, res_e))

        one = on_rank0(replicated)
        ref = one.pop("result") if one is not None else None
        out = dict(seeds=n_seeds, rows=int(query.mask.sum()) * n_seeds,
                   cap_bound_rows=cap_bound_rows(bundle.model, T, key_ms, query), one_card=one)
        if one is not None:
            out["one_card"]["max_abs"] = max(float(s.abs().max()) for s in ref)
        for shape in ((1, world), (2, world // 2)):
            mesh = make_mesh(axis_names=("data", "model"), shape=shape)
            model = place_model(dev, scene_axis_name="model")
            compiled = scene_sharded_score_fn(mesh, model, key_ms, query)
            eager = scene_sharded_score_fn(mesh, model, key_ms, query, use_runtime=False)
            out[f"scene_{shape[0]}x{shape[1]}"] = dict(
                compare(f"b: scene-sharded score {shape}", lambda: compiled(T, t), lambda: eager(T, t),
                        "edge_kernel"), valid_points_by_block=valid_points_by_block(bundle.model, key_ms, shape[1]))
        mesh = make_mesh(axis_names=("data", "model"), shape=(2, world // 2))
        for impl, counter in (("kernel", "edge_kernel"), ("fused", "fused_attention")):
            mq = place_model(dev, edge_impl=impl, query_shard_axes=["data", "model"])
            T_s, t_s = T.clone(), t.clone()

            def query_score(mq=mq, T_s=T_s, t_s=t_s):
                with use_mesh(mesh):
                    return mq.score(T_s, key_ms, query, t_s)
            program = Program(query_score, dev, torch.cuda.graph_pool_handle() if dev.type == "cuda" else None,
                              mesh=mesh)
            out[f"query_all_ranks_{impl}"] = compare(f"c: query-sharded score on {impl}", program, query_score,
                                                     counter)
    return out


def train_epochs(mesh, dev, n_demos):
    demos = make_synthetic_dataset(n_demos=n_demos, seed=0)
    rank = dist.get_rank()

    def trainer(use_runtime, tag):
        log_dir = os.path.join(ROOT, "build", "multichip", f"{tag}_{rank}")
        shutil.rmtree(log_dir, ignore_errors=True)  # the epoch's losses are read back from its log
        tr = DiffusionEdfTrainer(cs.CONFIG, log_dir=log_dir, device=dev, seed=0, use_runtime=use_runtime)
        tr.init(demos, checkpoint=cs.CHECKPOINT)
        return tr

    def epoch(tr, m):
        """One epoch (its statistics read at its end), its state and the
        peak memory; a compiled trainer's second epoch replays it."""
        def one():
            stats, s, gb = peak(lambda: tr.train_epoch(mesh=m))
            return s / n_demos * 1e3, gb
        (ms, gb), capture_s = cs.capture_seconds(one)
        rec = dict(ms_a_step=ms, peak_gb=gb, count=int(tr.optimizer.count),
                   poses_a_step=tr.n_samples_x_ref * len(tr.time_schedules))
        with open(os.path.join(tr.log_dir, "metrics.jsonl")) as f:
            losses = [json.loads(line)["loss/train"] for line in f]
        rec["state"] = dict(loss=losses, params=[p.detach().clone() for p in tr.params],
                            ema=[e.clone() for e in tr.ema], opt=[x.clone() for x in tr.optimizer.state_tensors()[1:]])
        if tr.use_runtime:
            rec["replay_ms_a_step"], _ = one()
            rec.update(entries=tr.cache_size(), capture_s=capture_s, pool_gb=(tr.pool_bytes() or 0) / 1e9)
        return rec

    def data_parallel(use_runtime, tag):
        tr = trainer(use_runtime, tag)
        start = dict(params=[p.detach().clone() for p in tr.params], ema=[e.clone() for e in tr.ema])
        make_sharded_train_step(mesh, tr)
        rec = epoch(tr, mesh)
        digest = hashlib.sha256(b"".join(v.tobytes() for _, v in sorted(flat_arrays(tr.model).items()))).hexdigest()
        del tr
        return rec, start, digest

    eager = [data_parallel(False, f"eager{i}") for i in range(2)]
    cap, start, digest = data_parallel(True, "compiled")
    states = [e[0]["state"] for e in eager]
    try:
        g = cs.spread_gate("d: data-parallel epoch, compiled against eager", states, cap["state"],
                           cs.train_floor(states[0], start))
        ok = True
    except cs.SmokeFailure as e:
        g, ok = str(e), False
    digests = gathered(digest)
    gate("d: data-parallel epoch, compiled against eager (spread_gate)", ok, g)
    gate("d: parameters equal on every rank", len(set(digests)) == 1, digests)
    gate("d: step counts", cap["count"] == n_demos and all(e[0]["count"] == n_demos for e in eager),
         [cap["count"]] + [e[0]["count"] for e in eager])
    def one_card(poses_divisor):
        """One card's compiled epoch, the poses a step divided by ``poses_divisor``
        (the share of the step that a rank of the mesh scores)."""
        tr = trainer(True, f"one_card_{poses_divisor}")
        tr.n_samples_x_ref //= poses_divisor
        return epoch(tr, None)

    one = on_rank0(lambda: one_card(1))
    quarter = on_rank0(lambda: one_card(dist.get_world_size()))
    rec = dict(demos=n_demos, poses_a_step=cap["poses_a_step"], gate=g,
               compiled=dict(ms_a_step_by_rank=gathered(cap["replay_ms_a_step"]),
                             capturing_epoch_ms_a_step_by_rank=gathered(cap["ms_a_step"]),
                             capturing_epoch_peak_gb_by_rank=gathered(cap["peak_gb"]),
                             pool_gb_by_rank=gathered(cap["pool_gb"]), entries=cap["entries"],
                             capture_s=cap["capture_s"]),
               eager=dict(ms_a_step_by_rank=gathered([e[0]["ms_a_step"] for e in eager]),
                          peak_gb_by_rank=gathered(max(e[0]["peak_gb"] or 0.0 for e in eager))))
    if one is not None:
        for name, r in (("one_card_compiled", one), ("one_card_compiled_rank_share_of_poses", quarter)):
            rec[name] = dict(ms_a_step=r["replay_ms_a_step"], capturing_epoch_ms_a_step=r["ms_a_step"],
                             capturing_epoch_peak_gb=r["peak_gb"], pool_gb=r["pool_gb"], capture_s=r["capture_s"],
                             poses_a_step=r["poses_a_step"])
        rec["speedup_vs_one_card_compiled"] = one["replay_ms_a_step"] / cap["replay_ms_a_step"]
        rec["four_vs_one_card"] = cs.state_diff(cap["state"], one["state"])
    return rec


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--reps", type=int, default=3)
    p.add_argument("--seeds", type=int, default=128, help="(a)'s seeds; (b) and (c) score a quarter of them")
    p.add_argument("--stage-steps", type=int, default=100)
    p.add_argument("--demos", type=int, default=8, help="(d)'s demos: the steps of an epoch")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    p.add_argument("--out", default=os.path.join(ROOT, "chiprun_out", "multichip.json"))
    p.add_argument("--deadline", type=float, default=600.0,
                   help="seconds after which a rank prints its stack and exits (a hung collective ends the run)")
    args = p.parse_args(argv)
    faulthandler.dump_traceback_later(args.deadline, exit=True)
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
    for key, fn in (("a_seed_sharded_stage", lambda: seed_sharded_stage(mesh, dev, args.reps, args.seeds,
                                                                        args.stage_steps)),
                    ("bc_place_scores", lambda: sharded_scores(dev, args.reps, max(args.seeds // 4, 1))),
                    ("d_train_epoch", lambda: train_epochs(mesh, dev, args.demos))):
        t = time.perf_counter()
        result[key] = fn()
        result[key]["s"] = time.perf_counter() - t
        if rank == 0:
            print(f"{key}: {time.perf_counter() - t:.1f} s", flush=True)
    result["seconds"] = time.perf_counter() - t0
    result["failures"] = FAILURES
    if rank == 0:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1, default=str)
        print(json.dumps(result, default=str))
    dist.barrier()
    dist.destroy_process_group()
    return 1 if FAILURES else 0


if __name__ == "__main__":
    sys.exit(main())
