"""Dump a cascade's real samples with their true pose errors, for the critic
fine-tune (counterpart of the JAX repository's
``tools/gen_cascade_samples.py``; the same ``.npz``).

Per demo: the processed and padded scene and grasp clouds, the final poses
of one ``agent.sample`` call, and each pose's translation (cm) and rotation
(deg) error against the processed targets (for place, their 72-point
orbit about world z): the distribution the critic ranks at inference.
``train_critic_cascade`` of either package reads the dump::

    python -m diffusion_edf_tpu_torch.tools.gen_cascade_samples --task-type pick \\
        --checkpoint-dir checkpoints/panda_mug/pick_lowres.npz \\
        --cascade-checkpoint-dir checkpoints/panda_mug/pick_highres.npz \\
        --schedule-json reports/schedule_sweep_pick_r2.json \\
        --n-demos 30 --n-seeds 24 --demo-seed 0 --out build/cascade_samples_pick_train.npz [--device cpu]

The seed poses come from ``np.random.default_rng(--seed)`` in demo order, as
in the JAX tool; the Langevin noise of demo ``i`` from a ``torch.Generator``
on the models' device seeded ``seed * 1000 + i``.  As in the JAX tool, a
pick demo is scored against its targets alone (no orbit)."""
from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from ..eval import PREPROCESS, UNPROCESS, _symmetry_orbit, pose_errors, reference_inference_config

__all__ = ["main"]


def main(argv=None) -> str:
    p = argparse.ArgumentParser(description="Dump cascade samples with their true pose errors")
    p.add_argument("--task-type", default="pick", choices=["pick", "place"])
    p.add_argument("--task-family", default="mug", choices=["mug", "bowl", "bottle"])
    p.add_argument("--configs-root-dir", default=None,
                   help="default: diffusion_edf_tpu_torch/configs/panda_mug/{task}_lowres")
    p.add_argument("--checkpoint-dir", required=True, help="the first stage's flat .npz weights")
    p.add_argument("--cascade-configs-root-dir", default=None)
    p.add_argument("--cascade-checkpoint-dir", default=None)
    p.add_argument("--n-demos", type=int, default=30)
    p.add_argument("--n-seeds", type=int, default=32)
    p.add_argument("--demo-seed", type=int, default=0,
                   help="base seed of the demo draw (train: 0, held-out: e.g. 500)")
    p.add_argument("--diverse", action="store_true", default=True)
    p.add_argument("--split", default=None,
                   help="draw demos from a generalization split instead of the training distribution")
    p.add_argument("--schedule-json", default=None,
                   help="schedule-sweep report; uses its winner instead of the reference schedule")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--smoke", action="store_true", help="5-step schedule (plumbing check; samples are garbage)")
    p.add_argument("--out", required=True)
    p.add_argument("--device", default="cuda", help="the models' device (cuda or cpu)")
    args = p.parse_args(argv)

    from ..agent import DiffusionEdfAgent, load_model_bundle
    from ..train.data import TargetPoseDemo, pad_pointcloud
    from ..train.synthetic import make_split_dataset, make_synthetic_dataset
    from .sweep_schedule import to_diffusion_configs

    family = "place" if args.task_type == "place" else "pick"
    root = args.configs_root_dir or f"diffusion_edf_tpu_torch/configs/panda_mug/{family}_lowres"
    cas_root = args.cascade_configs_root_dir or f"diffusion_edf_tpu_torch/configs/panda_mug/{family}_highres"
    bundles = [load_model_bundle(root, checkpoint=args.checkpoint_dir, device=args.device)]
    if args.cascade_checkpoint_dir:
        bundles.append(load_model_bundle(cas_root, checkpoint=args.cascade_checkpoint_dir, device=args.device))
    agent = DiffusionEdfAgent(bundles, PREPROCESS, UNPROCESS)

    if args.schedule_json and os.path.exists(args.schedule_json):
        with open(args.schedule_json) as f:
            sweep = json.load(f)
        win = next(c for c in sweep["candidates"] if c["name"] == sweep["winner"])
        cfg = to_diffusion_configs({**win["schedule"], "name": win["name"]}, n_stages=len(bundles))
        print(f"using sweep winner schedule: {win['name']}", flush=True)
    else:
        cfg = reference_inference_config(n_stages=len(bundles))
    if args.smoke:
        n = len(bundles)
        cfg = dict(N_steps_list=[[5]] * n, timesteps_list=[[0.01]] * n, temperatures_list=[[1.0]] * n,
                   diffusion_schedules_list=[[[1.0, 0.1]]] * n, log_t_schedule=True, time_exponent_temp=1.0,
                   time_exponent_alpha=0.5)

    if args.split:
        seqs = make_split_dataset(args.split, n_demos=args.n_demos, seed=args.demo_seed, family=args.task_family)
    else:
        seqs = make_synthetic_dataset(n_demos=args.n_demos, seed=args.demo_seed, diverse=args.diverse,
                                      family=args.task_family)
    step_idx = 0 if args.task_type == "pick" else 1
    sym_orbit = 72 if args.task_type == "place" else 0

    rng = np.random.default_rng(args.seed)
    device = bundles[0].device
    cols = {k: [] for k in ("scene_x", "scene_f", "scene_mask", "grasp_x", "grasp_f", "grasp_mask",
                            "samples", "trans_err", "rot_err_deg", "target", "names")}
    for di, seq in enumerate(seqs):
        demo = seq[step_idx]
        center = demo.scene_pcd.points.mean(0)
        spread = demo.scene_pcd.points.std(0).mean() + 0.05
        q = rng.normal(size=(args.n_seeds, 4))
        q /= np.linalg.norm(q, axis=-1, keepdims=True)
        t = center + rng.normal(scale=spread, size=(args.n_seeds, 3))
        Ts_init = np.concatenate([q, t], axis=-1)

        t0 = time.perf_counter()
        traj, scene_p, grasp_p, _ = agent.sample(
            demo.scene_pcd, demo.grasp_pcd, Ts_init,
            generator=torch.Generator(device=device).manual_seed(args.seed * 1000 + di), record_trajectory=False,
            **cfg,
        )
        final = traj[-1]  # (n_seeds, 7) in cm
        demo_proc = agent.proc_fn(TargetPoseDemo(
            scene_pcd=demo.scene_pcd, grasp_pcd=demo.grasp_pcd, target_poses=demo.target_poses,
            symmetry=getattr(demo, "symmetry", None),
        ))
        target_proc = demo_proc.target_poses
        if sym_orbit:
            sym = demo_proc.symmetry or {}
            target_proc = _symmetry_orbit(target_proc, sym_orbit, center=sym.get("center"))
        errs = pose_errors(final, target_proc)

        for name, pcd, n_pad in (("scene", scene_p, bundles[0].n_scene_pad),
                                 ("grasp", grasp_p, bundles[0].n_grasp_pad)):
            fp = pad_pointcloud(pcd, n_pad)
            cols[f"{name}_x"].append(fp.x.numpy())
            cols[f"{name}_f"].append(fp.f.numpy())
            cols[f"{name}_mask"].append(fp.mask.numpy())
        cols["samples"].append(final)
        cols["trans_err"].append(errs["trans_err"])
        cols["rot_err_deg"].append(errs["rot_err_deg"])
        cols["target"].append(np.asarray(demo_proc.target_poses[0]))
        cols["names"].append(getattr(demo, "name", str(di)))
        bad = errs["trans_err"] + 0.2 * errs["rot_err_deg"]
        print(f"[{di}] {cols['names'][-1]}: badness min {bad.min():.2f} med {np.median(bad):.2f} "
              f"max {bad.max():.2f} cm-eq ({time.perf_counter() - t0:.1f} s)", flush=True)

    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    arrays = {k: np.stack(v) for k, v in cols.items() if k != "names"}
    for k in ("samples", "trans_err", "rot_err_deg", "target"):
        arrays[k] = arrays[k].astype(np.float32)
    meta = dict(task_type=args.task_type, n_demos=args.n_demos, n_seeds=args.n_seeds, demo_seed=args.demo_seed,
                split=args.split, sym_orbit=sym_orbit)
    np.savez_compressed(args.out, **arrays, names=np.asarray(cols["names"]),
                        meta=np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8))
    bad_all = arrays["trans_err"] + 0.2 * arrays["rot_err_deg"]
    print(f"wrote {args.out}: {len(seqs)} demos x {args.n_seeds} samples; badness med {np.median(bad_all):.2f}, "
          f"p90 {np.percentile(bad_all, 90):.2f}, gross(>5cm-eq) {(bad_all > 5).mean():.3f}", flush=True)
    return args.out


if __name__ == "__main__":
    main()
