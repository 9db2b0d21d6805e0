"""Train with periodic held-out evaluation, best-checkpoint selection and a
float16 export (counterpart of the JAX repository's
``tools/train_eval_loop.py``; the same options, curve and export).

Every ``--eval-every`` epochs (and before the first) the trainer's model is
evaluated in process on each split of ``train/synthetic.py::
make_split_dataset`` and one JSON line is appended to
``<log dir>/learning_curve.jsonl``: per split the median errors, success and
best-sample success from ``eval.evaluate_agent`` (optionally after a
trained first cascade stage, ``--seed-stage-*``), and for an EBM critic the
Spearman correlation of its energies with the badness of ranked poses
around each held-out target, on clean preprocessing.  The best epoch
(mean success over the splits less 0.001 of the first split's error, or the
mean rank Spearman for a critic) is saved to ``<log dir>/
checkpoint_best.npz`` and described in ``best.json``; ``--export-best``
writes its parameters as float16 with ``__meta__``::

    python -m diffusion_edf_tpu_torch.tools.train_eval_loop \\
        --configs-root-dir diffusion_edf_tpu_torch/configs/panda_bowl/pick_lowres \\
        --task-type pick --task-family bowl --synthetic-demos 30 --diverse --max-epochs 1200 \\
        --eval-every 300 --eval-demos 3 --splits default unseen_poses --grad-clip-norm 1.0 \\
        --lr-min-factor 0.1 --log-name bowl_pick_lr --export-best build/bowl_pick_lowres.npz [--device cpu]

The log directory is ``runs/<log name>`` under the working directory.  The
trainer draws from ``torch.Generator``s seeded ``--seed``; the rank
evaluation's poses around demo ``i`` from one seeded ``9000 + i``."""
from __future__ import annotations

import argparse
import json
import os
import time
from typing import Dict

import numpy as np
import torch

from ..eval import PREPROCESS, UNPROCESS

__all__ = ["main"]


def main(argv=None) -> Dict:
    p = argparse.ArgumentParser(description="Train with periodic held-out evaluation")
    p.add_argument("--configs-root-dir", required=True)
    p.add_argument("--task-type", default="pick", choices=["pick", "place"])
    p.add_argument("--synthetic-demos", type=int, default=10)
    p.add_argument("--task-family", default="mug", choices=["mug", "bowl", "bottle"],
                   help="synthetic task geometry (train/synthetic.py FAMILIES)")
    p.add_argument("--diverse", action="store_true",
                   help="per-demo mug-scale/pole-tilt/clutter diversity (the training distribution)")
    p.add_argument("--max-epochs", type=int, default=3000)
    p.add_argument("--eval-every", type=int, default=100)
    p.add_argument("--eval-demos", type=int, default=4)
    p.add_argument("--n-seeds", type=int, default=10)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--log-name", default=None)
    p.add_argument("--splits", nargs="*", default=["default", "unseen_poses"])
    p.add_argument("--resume-from", default=None, help="a checkpoint that the trainer's save() wrote")
    p.add_argument("--init-params-npz", default=None,
                   help="warm-start params (and EMA) from a flat .npz (fresh optimizer and epoch counter)")
    p.add_argument("--seed-stage-configs", default=None,
                   help="config family of a trained first cascade stage; eval runs it -> this model")
    p.add_argument("--seed-stage-checkpoint", default=None, help="flat .npz of the seed stage")
    p.add_argument("--skip-sampler-eval", action="store_true",
                   help="critic runs: skip the sampling eval; the rank Spearman is still measured")
    p.add_argument("--export-best", default=None,
                   help="write the best checkpoint's params as a flat float16 .npz here")
    p.add_argument("--train-demo-distractors", type=int, default=None,
                   help="force every training demo to carry this many distractors")
    p.add_argument("--clutter-heavy", action="store_true",
                   help="reweight the diverse per-demo distractor draw toward the top of the training range")
    p.add_argument("--lr", type=float, default=None, help="override optimizer_kwargs.lr")
    p.add_argument("--grad-clip-norm", type=float, default=None, help="override optimizer_kwargs.grad_clip_norm")
    p.add_argument("--lr-min-factor", type=float, default=None,
                   help="override optimizer_kwargs.lr_min_factor (cosine decay floor)")
    p.add_argument("--ema-decay", type=float, default=None, help="override optimizer_kwargs.ema_decay")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)
    if args.seed_stage_configs and not args.seed_stage_checkpoint:
        p.error("--seed-stage-configs needs --seed-stage-checkpoint")

    from ..agent import DiffusionEdfAgent, ModelBundle, load_model_bundle
    from ..data import stack_points
    from ..eval import evaluate_agent
    from ..train.data import TargetPoseDemo, compose_proc_fn, pad_pointcloud
    from ..train.ranking import RankConfig, sample_ranked_poses
    from ..train.synthetic import make_split_dataset, make_synthetic_dataset
    from ..train.trainer import DiffusionEdfTrainer
    from .train_critic_cascade import export_float16

    log_name = args.log_name or f"{args.task_type}_{time.strftime('%m%d-%H%M')}"
    log_dir = os.path.join("runs", log_name)
    tr = DiffusionEdfTrainer(args.configs_root_dir, log_dir=log_dir, device=args.device, seed=args.seed)
    for key in ("lr", "grad_clip_norm", "lr_min_factor"):
        if getattr(args, key) is not None:
            tr.opt_kwargs[key] = getattr(args, key)
    if args.ema_decay is not None:
        tr.ema_decay = args.ema_decay
    mk_kwargs = {} if args.train_demo_distractors is None else {"n_distractors": args.train_demo_distractors}
    demos = make_synthetic_dataset(n_demos=args.synthetic_demos, seed=args.seed, diverse=args.diverse,
                                   clutter_heavy=args.clutter_heavy, family=args.task_family, **mk_kwargs)
    warm = args.init_params_npz if not args.resume_from else None
    tr.init(demos, checkpoint=warm, total_epochs=args.max_epochs)
    if args.resume_from:
        tr.restore(args.resume_from)
        print(f"resumed from {args.resume_from} at epoch {tr.epoch}", flush=True)
    elif warm:
        print(f"warm-started params from {warm}", flush=True)
    print(f"model: {tr.model_cfg['model_name']}  params: {tr.n_params():,}"
          f"{'  [EBM + rank loss]' if tr.rank_cfg is not None else ''}", flush=True)

    # the in-process eval agent shares the trainer's model (its current parameters at every eval)
    bundle = ModelBundle(model=tr.model, ang_mult=tr.ang_mult, lin_mult=tr.lin_mult, n_scene_pad=tr.n_scene_pad,
                         n_grasp_pad=tr.n_grasp_pad)
    bundles = [bundle]
    if args.seed_stage_configs:
        bundles = [load_model_bundle(args.seed_stage_configs, checkpoint=args.seed_stage_checkpoint,
                                     n_scene_pad=tr.n_scene_pad, device=args.device), bundle]
    agent = DiffusionEdfAgent(bundles, PREPROCESS, UNPROCESS)
    eval_sets = {name: make_split_dataset(name, n_demos=args.eval_demos, seed=args.seed + 1000,
                                          family=args.task_family)
                 for name in args.splits}
    curve_path = os.path.join(log_dir, "learning_curve.jsonl")
    os.makedirs(log_dir, exist_ok=True)
    dev = tr.device

    rank_demos = {}
    if tr.is_ebm:
        # clean (deterministic) preprocessing: the trainer's own carries the jitter of training
        eval_proc = compose_proc_fn(PREPROCESS)
        step_idx = 0 if args.task_type == "pick" else 1
        for name, dset in eval_sets.items():
            rank_demos[name] = []
            for seq in dset:
                d = eval_proc(TargetPoseDemo(scene_pcd=seq[step_idx].scene_pcd, grasp_pcd=seq[step_idx].grasp_pcd,
                                             target_poses=seq[step_idx].target_poses))
                rank_demos[name].append((pad_pointcloud(d.scene_pcd, tr.n_scene_pad, dev),
                                         pad_pointcloud(d.grasp_pcd, tr.n_grasp_pad, dev),
                                         torch.as_tensor(np.asarray(d.target_poses[0], np.float32), device=dev)))
        rank_eval_cfg = (tr.rank_cfg or RankConfig())._replace(n_negatives=48)

    @torch.no_grad()
    def rank_spearman(name: str) -> float:
        from scipy.stats import spearmanr

        m = tr.model
        corrs = []
        for di, (scene, grasp, T) in enumerate(rank_demos[name]):
            Ts, b = sample_ranked_poses(T, rank_eval_cfg, torch.Generator(device=dev).manual_seed(9000 + di))
            key_ms = [stack_points([p]) for p in m.get_key_pcd_multiscale(scene)]
            e = m.energy(Ts[None], key_ms, stack_points([m.get_query_pcd(grasp)]), Ts.new_ones(1, Ts.shape[0]))
            e = e[0].cpu().numpy()
            corrs.append(0.0 if np.std(e) == 0 else float(spearmanr(e, b.cpu().numpy()).statistic))
        return float(np.mean(corrs))

    best = {"score": -np.inf, "epoch": -1}
    best_path = os.path.join(log_dir, "checkpoint_best.npz")

    def run_eval() -> Dict:
        tr.model.eval()
        rec = {"epoch": tr.epoch, "steps": tr.steps, "wall_s": round(time.time() - t0, 1)}
        for name, dset in eval_sets.items():
            if not (tr.is_ebm and args.skip_sampler_eval):
                r = evaluate_agent(agent, dset, task_type=args.task_type, n_seeds=args.n_seeds, seed=args.seed)
                rec[name] = {
                    "trans_cm_median": r["trans_err_cm"]["median"],
                    "rot_deg_median": r["rot_err_deg"]["median"],
                    "success": r["success_rate"],
                    "best_success": r["best_sample_success_rate"],
                }
                print(f"  eval[{name}] @epoch {tr.epoch}: trans {r['trans_err_cm']['median']:.2f} cm  "
                      f"rot {r['rot_err_deg']['median']:.1f} deg  success {r['success_rate']:.2f}", flush=True)
            if tr.is_ebm:
                sp = rank_spearman(name)
                rec.setdefault(name, {})["rank_spearman"] = sp
                print(f"  eval[{name}] @epoch {tr.epoch}: rank_spearman {sp:.3f}", flush=True)
        with open(curve_path, "a") as f:
            f.write(json.dumps(rec) + "\n")
        # model selection: mean success over every split, the first split's errors as the tie-break
        d0 = rec.get(args.splits[0], {})
        if tr.is_ebm:
            score = float(np.mean([rec[n]["rank_spearman"] for n in eval_sets if n in rec]))
        elif "success" in d0:
            succs = [rec[n]["success"] for n in eval_sets if "success" in rec.get(n, {})]
            score = float(np.mean(succs)) - 0.001 * (d0["trans_cm_median"] + 0.2 * d0["rot_deg_median"])
        else:
            score = -np.inf
        if score > best["score"] and tr.epoch > 0:
            best.update(score=score, epoch=tr.epoch, record=dict(rec))
            tr.save(best_path)
            with open(os.path.join(log_dir, "best.json"), "w") as f:
                json.dump(best, f, indent=1, default=float)
            print(f"  new best @epoch {tr.epoch} (score {score:.4f}) -> {best_path}", flush=True)
        return rec

    t0 = time.time()
    run_eval()  # the epoch-0 (or resume-point) baseline
    while tr.epoch < args.max_epochs:
        stats = tr.train_epoch()
        if tr.epoch % 25 == 0 or tr.epoch == 1:
            extra = (f" rank_acc {stats['rank/pair_acc']:.3f} e_spread {stats['rank/e_spread']:.3f}"
                     if "rank/pair_acc" in stats else "")
            print(f"epoch {tr.epoch:4d}  loss {stats['loss/train']:.4f} "
                  f"(ang {stats['loss/angular']:.4f} lin {stats['loss/linear']:.4f}) "
                  f"align_ang {stats.get('alignment/normalized/ang', float('nan')):.3f}{extra} "
                  f"{time.time() - t0:.1f}s", flush=True)
        if tr.epoch % args.eval_every == 0 or tr.epoch == args.max_epochs:
            print(f"checkpoint -> {tr.save()}", flush=True)
            run_eval()

    if args.export_best and best["epoch"] > 0:
        with np.load(best_path) as z:
            flat = {k: z[k] for k in z.files if k.startswith("params/")}
        export_float16(args.export_best, flat, dict(log_name=log_name, best_epoch=best["epoch"], score=best["score"]))
        print(f"exported best (epoch {best['epoch']}) -> {args.export_best}", flush=True)
    tr.logger.close()
    print("done", flush=True)
    return best


if __name__ == "__main__":
    main()
