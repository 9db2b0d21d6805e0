"""Evaluation harness: pose-quality metrics for sampled pick and place poses
(counterpart of the JAX package's ``eval.py``, same metrics, same report).

Seed poses -> cascaded denoising -> compare against the demo's target poses.
Per demo: the translation error (cm) and rotation error (deg) of each final
sample to its nearest target pose, and success at (1 cm, 5 deg).  The seed
poses come from one ``np.random.default_rng(seed)`` drawn in demo order, as in
the JAX harness, so a demo gets the same ``Ts_init`` in both; the Langevin
noise of demo ``i`` comes from a ``torch.Generator`` seeded ``seed + i`` on
the agent's device.

    python -m diffusion_edf_tpu_torch.eval \\
        --configs-root-dir diffusion_edf_tpu_torch/configs/panda_mug/pick_lowres \\
        --checkpoint-dir checkpoints/panda_mug/pick_lowres.npz \\
        --splits default --synthetic-demos 30 --n-seeds 10 [--device cpu]
"""
from __future__ import annotations

import argparse
import json
from typing import Dict, Optional

import numpy as np
import torch

__all__ = ["pose_errors", "reference_inference_config", "to_diffusion_configs", "evaluate_agent", "main",
           "PREPROCESS", "UNPROCESS"]

# the clouds as ``main`` prepares them: 1 cm voxels, metres -> cm (no jitter); poses back to metres
PREPROCESS = [
    dict(name="downsample", kwargs=dict(voxel_size=0.01, coord_reduction="average")),
    dict(name="rescale", kwargs=dict(rescale_factor=100.0)),
]
UNPROCESS = [dict(name="rescale", kwargs=dict(rescale_factor=0.01))]


def reference_inference_config(n_stages: int = 1) -> Dict:
    """The full inference recipe of ``configs/panda_mug/server.yaml``: 900
    Langevin steps over five t-brackets from t=1.0 down to t=0.012, ending in
    a temperature-0 quench.  A two-model cascade (``n_stages=2``) runs the
    first two brackets on lowres and the last three on highres; one model
    runs all five."""
    steps = [200, 200, 200, 200, 100]
    dts = [0.04, 0.04, 0.02, 0.02, 0.01]
    temps = [1.0, 1.0, 1.0, 1.0, 0.0]
    scheds = [[1.0, 0.15], [0.15, 0.09], [0.09, 0.03], [0.03, 0.012], [0.012, 0.012]]
    if n_stages == 2:
        split = ([steps[:2], steps[2:]], [dts[:2], dts[2:]], [temps[:2], temps[2:]], [scheds[:2], scheds[2:]])
    else:
        assert n_stages == 1, n_stages
        split = ([steps], [dts], [temps], [scheds])
    return dict(
        N_steps_list=split[0],
        timesteps_list=split[1],
        temperatures_list=split[2],
        diffusion_schedules_list=split[3],
        log_t_schedule=True,
        time_exponent_temp=1.0,
        time_exponent_alpha=0.5,
    )


def to_diffusion_configs(c: Dict, n_stages: int) -> Dict:
    """The diffusion configs of one candidate schedule of a schedule-sweep
    report (``steps``, ``dts``, ``temps``, ``scheds`` per bracket and the
    cascade ``split``): the first ``split`` brackets on the first stage."""
    s = c["split"] if n_stages == 2 else len(c["steps"])

    def parts(xs):
        return [xs[:s], xs[s:]] if n_stages == 2 else [xs]

    return dict(
        N_steps_list=parts(c["steps"]),
        timesteps_list=parts(c["dts"]),
        temperatures_list=parts(c["temps"]),
        diffusion_schedules_list=parts(c["scheds"]),
        log_t_schedule=True,
        time_exponent_temp=1.0,
        time_exponent_alpha=0.5,
    )


def pose_errors(samples: np.ndarray, targets: np.ndarray) -> Dict[str, np.ndarray]:
    """samples (nS, 7), targets (nT, 7) -> per-sample nearest-target errors:
    the geodesic angle between quaternions (deg) and the L2 translation."""
    samples = np.asarray(samples, dtype=np.float64).reshape(-1, 7)
    targets = np.asarray(targets, dtype=np.float64).reshape(-1, 7)
    qs, ts = samples[:, :4], samples[:, 4:]
    qt, tt = targets[:, :4], targets[:, 4:]
    qs = qs / np.linalg.norm(qs, axis=-1, keepdims=True)
    qt = qt / np.linalg.norm(qt, axis=-1, keepdims=True)
    dots = np.abs(qs @ qt.T)  # (nS, nT)
    ang = 2.0 * np.arccos(np.clip(dots, -1.0, 1.0)) * 180.0 / np.pi
    trans = np.linalg.norm(ts[:, None, :] - tt[None, :, :], axis=-1)
    nearest = np.argmin(trans / 1.0 + ang / 5.0, axis=1)  # combined normalised distance
    idx = np.arange(len(samples))
    return {"trans_err": trans[idx, nearest], "rot_err_deg": ang[idx, nearest]}


def _symmetry_orbit(targets: np.ndarray, n: int, center: Optional[np.ndarray] = None) -> np.ndarray:
    """Each target pose expanded into its ``n``-point orbit under rotation
    about the world z-axis through ``center`` (the demo's symmetry centre),
    or, with no centre, about the target's own translation."""
    thetas = np.linspace(0.0, 2 * np.pi, n, endpoint=False)
    qz = np.stack([np.cos(thetas / 2), np.zeros(n), np.zeros(n), np.sin(thetas / 2)], axis=-1)
    cos_t, sin_t = np.cos(thetas), np.sin(thetas)
    out = []
    for T in np.asarray(targets, dtype=np.float64).reshape(-1, 7):
        w1, x1, y1, z1 = qz[:, 0], qz[:, 1], qz[:, 2], qz[:, 3]
        w2, x2, y2, z2 = T[0], T[1], T[2], T[3]
        q = np.stack(
            [
                w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
                w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
                w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
                w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
            ],
            axis=-1,
        )
        if center is None:
            trans = np.tile(T[4:], (n, 1))
        else:
            c = np.asarray(center, dtype=np.float64)
            d = T[4:] - c
            trans = c + np.stack([cos_t * d[0] - sin_t * d[1], sin_t * d[0] + cos_t * d[1], np.full(n, d[2])],
                                 axis=-1)
        out.append(np.concatenate([q, trans], axis=-1))
    return np.concatenate(out, axis=0)


def _agent_device(agent) -> torch.device:
    models = getattr(agent, "models", None)
    return models[0].device if models else torch.device("cpu")


def evaluate_agent(
    agent,
    demos,
    task_type: str = "pick",
    n_seeds: int = 10,
    diffusion_configs: Optional[Dict] = None,
    seed: int = 0,
    success_trans_cm: float = 1.0,
    success_rot_deg: float = 5.0,
    symmetry_orbit: Optional[int] = None,
) -> Dict:
    """Run the agent on every demo (a list of ``DemoSequence``; targets are
    compared in model (cm) units) and return the aggregate pose metrics.

    ``symmetry_orbit``: the number of points of the z-orbit the targets are
    expanded into (``None``: 72 for place, and for a pick whose demos
    declare a symmetry; else off).  As in the JAX harness, an explicit
    orbit applies to a pick demo only if the demo declares a symmetry, and a
    declared axis other than world z fails an assert."""
    from scipy.stats import spearmanr

    from .train.data import TargetPoseDemo

    step_idx = 0 if task_type == "pick" else 1
    if symmetry_orbit is None:
        declared = any(getattr(seq[step_idx], "symmetry", None) for seq in demos)
        symmetry_orbit = 72 if (task_type == "place" or declared) else 0
    cfg = diffusion_configs or reference_inference_config(
        n_stages=2 if len(getattr(agent, "models", [None])) >= 2 else 1
    )
    device = _agent_device(agent)
    rng = np.random.default_rng(seed)
    all_trans, all_rot = [], []
    exec_trans, exec_rot = [], []  # critic-ranked sample 0: the pose a robot executes
    calib_corrs = []  # per-demo Spearman(energy, pose error)
    per_demo = []
    for di, seq in enumerate(demos):
        demo = seq[step_idx]
        # seed poses: random rotations, translations near the scene
        center = demo.scene_pcd.points.mean(0)
        spread = demo.scene_pcd.points.std(0).mean() + 0.05
        q = rng.normal(size=(n_seeds, 4))
        q /= np.linalg.norm(q, axis=-1, keepdims=True)
        t = center + rng.normal(scale=spread, size=(n_seeds, 3))
        Ts_init = np.concatenate([q, t], axis=-1)

        traj, _, _, info = agent.sample(
            demo.scene_pcd, demo.grasp_pcd, Ts_init,
            generator=torch.Generator(device=device).manual_seed(seed + di), record_trajectory=False, **cfg,
        )
        final = traj[-1]  # (nSeeds, 7) in cm
        demo_proc = agent.proc_fn(TargetPoseDemo(
            scene_pcd=demo.scene_pcd, grasp_pcd=demo.grasp_pcd,
            target_poses=demo.target_poses, symmetry=getattr(demo, "symmetry", None),
        ))
        target_proc = demo_proc.target_poses
        if symmetry_orbit and (task_type == "place" or demo_proc.symmetry):
            sym = demo_proc.symmetry or {}
            axis = sym.get("axis")
            assert axis is None or np.allclose(axis, [0.0, 0.0, 1.0]), (
                f"symmetry-orbit scoring only supports a world-z axis, got {axis}"
            )
            target_proc = _symmetry_orbit(target_proc, symmetry_orbit, center=sym.get("center"))
        errs = pose_errors(final, target_proc)
        all_trans.append(errs["trans_err"])
        all_rot.append(errs["rot_err_deg"])
        if "energy" in info:
            # sample() sorts the poses by ascending critic energy: index 0 is executed
            exec_trans.append(errs["trans_err"][0])
            exec_rot.append(errs["rot_err_deg"][0])
            # energy against error, ranked within the demo; a constant-energy critic counts 0
            e = np.asarray(info["energy"]).reshape(-1)
            err = errs["trans_err"] + errs["rot_err_deg"] * 0.2  # cm + 0.2 cm/deg
            if len(e) >= 5 and err.std() > 0:
                calib_corrs.append(0.0 if e.std() == 0 else float(spearmanr(e, err).statistic))
        per_demo.append({
            "demo": getattr(demo, "name", str(di)),
            "trans_err_cm_median": float(np.median(errs["trans_err"])),
            "rot_err_deg_median": float(np.median(errs["rot_err_deg"])),
            "best_trans_err_cm": float(errs["trans_err"].min()),
            "best_rot_err_deg": float(errs["rot_err_deg"].min()),
        })
    trans = np.concatenate(all_trans)
    rot = np.concatenate(all_rot)
    success = (trans <= success_trans_cm) & (rot <= success_rot_deg)
    return {
        "n_demos": len(per_demo),
        "n_samples": int(len(trans)),
        "n_seeds": int(n_seeds),
        "symmetry_orbit": {"n": int(symmetry_orbit), "axis": [0.0, 0.0, 1.0]},
        "success_thresholds": {"trans_cm": success_trans_cm, "rot_deg": success_rot_deg},
        "target_matching": "nearest",
        "trans_err_cm": {"mean": float(trans.mean()), "median": float(np.median(trans))},
        "rot_err_deg": {"mean": float(rot.mean()), "median": float(np.median(rot))},
        "success_rate": float(success.mean()),
        "best_sample_success_rate": float(np.mean([
            d["best_trans_err_cm"] <= success_trans_cm and d["best_rot_err_deg"] <= success_rot_deg
            for d in per_demo
        ])),
        "per_demo": per_demo,
        **(
            {
                "executed_trans_err_cm_median": float(np.median(exec_trans)),
                "executed_rot_err_deg_median": float(np.median(exec_rot)),
                "executed_success_rate": float(np.mean(
                    (np.asarray(exec_trans) <= success_trans_cm) & (np.asarray(exec_rot) <= success_rot_deg)
                )),
                "energy_error_spearman_mean": float(np.mean(calib_corrs)) if calib_corrs else None,
                "energy_error_spearman_per_demo": [round(c, 3) for c in calib_corrs],
            }
            if exec_trans
            else {}
        ),
    }


def main(argv=None):
    p = argparse.ArgumentParser(description="Evaluate a diffusion-EDF agent")
    p.add_argument("--configs-root-dir", required=True)
    p.add_argument("--checkpoint-dir", default=None, help="the stage's flat .npz weights")
    p.add_argument("--task-type", default="pick", choices=["pick", "place"])
    p.add_argument("--task-family", default="mug", choices=["mug", "bowl", "bottle"],
                   help="synthetic task geometry (train/synthetic.py FAMILIES)")
    p.add_argument("--n-seeds", type=int, default=10)
    p.add_argument("--synthetic-demos", type=int, default=5)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--splits", nargs="*", default=None,
                   help="evaluate generalization splits (default: plain eval); "
                        "no value = all of default/unseen_poses/distractors/unseen_instances")
    p.add_argument("--n-scene-pad", type=int, default=2048)
    p.add_argument("--critic-configs-root-dir", default=None,
                   help="EBM critic config family; enables energy-ranked executed-sample metrics")
    p.add_argument("--critic-checkpoint-dir", default=None)
    p.add_argument("--cascade-configs-root-dir", default=None,
                   help="second-stage (highres) config family: evaluates the lowres->highres cascade, "
                        "the final pose of stage k seeding stage k+1")
    p.add_argument("--cascade-checkpoint-dir", default=None)
    p.add_argument("--schedule-json", default=None,
                   help="a schedule-sweep report: run inference with its winner schedule instead of the "
                        "reference recipe")
    p.add_argument("--out", default=None)
    p.add_argument("--device", default="cuda", help="the models' device (cuda or cpu)")
    args = p.parse_args(argv)

    from .agent import DiffusionEdfAgent, load_model_bundle
    from .train.synthetic import SPLITS, make_split_dataset, make_synthetic_dataset

    def bundle(cfg_dir, ckpt):
        return load_model_bundle(cfg_dir, checkpoint=ckpt, n_scene_pad=args.n_scene_pad, device=args.device)

    bundles = [bundle(args.configs_root_dir, args.checkpoint_dir)]
    if args.cascade_configs_root_dir:
        if not args.cascade_checkpoint_dir:
            p.error("--cascade-configs-root-dir requires --cascade-checkpoint-dir")
        bundles.append(bundle(args.cascade_configs_root_dir, args.cascade_checkpoint_dir))
    critic = None
    if args.critic_configs_root_dir:
        # a critic of random weights would rank by noise
        if not args.critic_checkpoint_dir:
            p.error("--critic-configs-root-dir requires --critic-checkpoint-dir "
                    "(refusing to rank with randomly initialized critic weights)")
        critic = bundle(args.critic_configs_root_dir, args.critic_checkpoint_dir)
    agent = DiffusionEdfAgent(bundles, PREPROCESS, UNPROCESS, critic=critic)
    diffusion_configs = None
    if args.schedule_json:
        with open(args.schedule_json) as f:
            sweep = json.load(f)
        win = next(c for c in sweep["candidates"] if c["name"] == sweep["winner"])
        diffusion_configs = to_diffusion_configs({**win["schedule"], "name": win["name"]}, n_stages=len(bundles))
        print(f"schedule: sweep winner {win['name']!r}", flush=True)
    if args.splits is not None:
        report = {}
        for name in args.splits or list(SPLITS):
            demos = make_split_dataset(name, n_demos=args.synthetic_demos, seed=args.seed + 1000,
                                       family=args.task_family)
            report[name] = evaluate_agent(agent, demos, task_type=args.task_type, n_seeds=args.n_seeds,
                                          seed=args.seed, diffusion_configs=diffusion_configs)
            print(
                f"[{name}] trans_cm median {report[name]['trans_err_cm']['median']:.2f} "
                f"rot_deg median {report[name]['rot_err_deg']['median']:.2f} "
                f"success {report[name]['success_rate']:.2f}",
                flush=True,
            )
    else:
        demos = make_synthetic_dataset(n_demos=args.synthetic_demos, seed=args.seed, family=args.task_family)
        report = evaluate_agent(agent, demos, task_type=args.task_type, n_seeds=args.n_seeds, seed=args.seed,
                                diffusion_configs=diffusion_configs)
    text = json.dumps(report, indent=2)
    print(text)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text)


if __name__ == "__main__":
    main()
