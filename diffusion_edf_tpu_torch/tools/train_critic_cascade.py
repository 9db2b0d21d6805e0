"""Fine-tune the EBM critic to rank real cascade samples (counterpart of the
JAX repository's ``tools/train_critic_cascade.py``; the same dumps, report
and export).

The critic's job is the energy order of the agent's final samples.  Each
step takes one training demo of a ``gen_cascade_samples`` dump, adds a fan
of synthetic negatives around its target (``train/ranking.py``) so that
gross failures keep a high energy, and minimises ``0.5 * rank_loss(all) +
0.5 * rank_loss(cascade samples only)`` with dropout on, through global-norm
clipping at 1.0 and AMSGrad with a cosine decay to 0.1 lr over
``max_epochs * D`` steps.  The steps run the plain attention path (the CUDA
kernels have no backward); the held-out evaluation runs under ``no_grad``
on the model's ``edge_impl`` (the edge kernel on CUDA).  The best epoch, by
held-out executed success minus 0.01 mean regret, is reported with the
noise-floor probe and exported as float16::

    python -m diffusion_edf_tpu_torch.tools.train_critic_cascade \\
        --configs-root-dir diffusion_edf_tpu_torch/configs/panda_mug/pick_ebm \\
        --init-params-npz checkpoints/panda_mug/pick_ebm.npz \\
        --train-dump build/cascade_samples_pick_train.npz --eval-dump build/cascade_samples_pick_eval.npz \\
        --export-best build/pick_ebm_cascade.npz --out build/critic_cascade_pick.json [--device cpu]

Randomness: the epoch order from ``np.random.default_rng(--seed)`` as in the
JAX tool; the fans and the dropout masks from one ``torch.Generator`` on the
device seeded ``--seed``."""
from __future__ import annotations

import argparse
import json
import os
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..data import FeaturedPoints, stack_points
from ..train.ranking import RankConfig, rank_loss, sample_ranked_poses

__all__ = ["load_dump", "noise_floor_probe", "dump_clouds", "build_critic", "energies", "step_loss",
           "make_optimizer", "make_train_step", "run_eval", "export_float16", "main"]


def load_dump(path: str) -> Dict[str, np.ndarray]:
    """A dump's arrays, plus ``badness = trans_err + 0.2 * rot_err_deg``."""
    with np.load(path) as z:
        d = {k: z[k] for k in z.files}
    d["badness"] = d["trans_err"] + 0.2 * d["rot_err_deg"]
    return d


def noise_floor_probe(energies, badness, n_deciles: int = 10) -> Dict:
    """Within-decile energy spread against the best-to-worst decile gap,
    pooled over demos after standardising each demo's energies (energies
    are compared only within a demo)."""
    stds, means = [], []
    for e, b in zip(energies, badness):
        e, b = np.asarray(e, np.float64), np.asarray(b, np.float64)
        if e.std() == 0:
            continue
        e = (e - e.mean()) / e.std()
        bins = np.array_split(np.argsort(b), min(n_deciles, len(e)))
        means.append([float(e[ix].mean()) for ix in bins if len(ix)])
        stds.append([float(e[ix].std()) for ix in bins if len(ix)])
    if not means:
        return {}
    k = min(len(m) for m in means)
    mean_curve = np.mean([m[:k] for m in means], axis=0)
    within_std = float(np.mean([s[:k] for s in stds]))
    gap = float(mean_curve[-1] - mean_curve[0])  # worst decile - best decile
    return {
        "decile_energy_mean_curve": [round(float(x), 3) for x in mean_curve],
        "within_decile_energy_std": round(within_std, 3),
        "best_to_worst_decile_gap": round(gap, 3),
        "gap_over_noise": round(gap / max(within_std, 1e-6), 3),
    }


def dump_clouds(d: Dict[str, np.ndarray], i: int, device) -> Tuple[FeaturedPoints, FeaturedPoints]:
    """Demo ``i``'s padded scene and grasp clouds on ``device``."""
    def fp(name):
        return FeaturedPoints(*(torch.as_tensor(d[f"{name}_{k}"][i], device=device) for k in ("x", "f", "mask")))
    return fp("scene"), fp("grasp")


def build_critic(configs_root_dir: str, device, init_params_npz: Optional[str] = None, seed: int = 0):
    """``(model, train config)`` of an EBM config family, in ``eval()``
    mode: seeded random weights, or those of a flat ``.npz``."""
    from ..train.factory import build_score_model
    from ..train.trainer import load_configs
    from ..weights import init_params, load_params_npz

    train_cfg, _, model_cfg = load_configs(configs_root_dir)
    if not model_cfg["model_kwargs"]["score_head_kwargs"].get("ebm", False):
        raise ValueError("the critic fine-tune needs an EBM config family")
    model = init_params(build_score_model(model_cfg["model_name"], model_cfg["model_kwargs"]),
                        torch.Generator().manual_seed(seed))
    if init_params_npz:
        load_params_npz(model, init_params_npz)
    return model.to(device).eval(), train_cfg


def energies(model, poses: torch.Tensor, scene: FeaturedPoints, grasp: FeaturedPoints) -> torch.Tensor:
    """The critic's energies (S,) of one demo's poses (S, 7): the features
    once, then one energy evaluation of every pose."""
    key_ms = [stack_points([p]) for p in model.get_key_pcd_multiscale(scene)]
    query = stack_points([model.get_query_pcd(grasp)])
    return model.energy(poses[None], key_ms, query, poses.new_ones(1, poses.shape[0]))[0]


def step_loss(model, scene, grasp, samples, badness, fan_Ts, fan_bad,
              rank_cfg: RankConfig) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The loss of one step on one demo: the rank loss over the fan and the
    cascade samples together and over the cascade samples alone, half
    each (the fan anchors gross failures; the samples are what the agent
    ranks)."""
    n_fan = fan_Ts.shape[0]
    E = energies(model, torch.cat([fan_Ts, samples]), scene, grasp)
    bad = torch.cat([fan_bad, badness])
    loss, acc = rank_loss(E, bad, rank_cfg)
    closs, cacc = rank_loss(E[n_fan:], bad[n_fan:], rank_cfg)
    total = 0.5 * loss + 0.5 * closs
    return total, dict(loss=total, acc=acc, cascade_loss=closs, cascade_acc=cacc)


def make_optimizer(params, lr: float, total_steps: int):
    """The JAX tool's optax chain: global-norm clipping at 1.0, then AMSGrad
    (optax's defaults) with a cosine decay from ``lr`` to ``0.1 lr`` over
    ``total_steps``."""
    from ..train.optim import Amsgrad

    return Amsgrad(params, lr=lr, betas=(0.9, 0.999), eps=1e-8, grad_clip_norm=1.0, lr_min_factor=0.1,
                   total_steps=total_steps)


def make_train_step(model, dump: Dict[str, np.ndarray], fan_cfg: RankConfig, rank_cfg: RankConfig, opt,
                    generator: torch.Generator):
    """``step(d)``: one update on demo ``d`` of ``dump`` with dropout on (the
    model's dropout draws from ``generator``, as does the fan), returning
    the step's statistics."""
    params = list(model.parameters())
    device = params[0].device
    model.set_dropout_generator(generator)

    def step(d: int) -> Dict[str, torch.Tensor]:
        scene, grasp = dump_clouds(dump, d, device)
        fan_Ts, fan_bad = sample_ranked_poses(torch.as_tensor(dump["target"][d], device=device), fan_cfg, generator)
        model.train()
        loss, stats = step_loss(model, scene, grasp, torch.as_tensor(dump["samples"][d], device=device),
                                torch.as_tensor(dump["badness"][d], device=device), fan_Ts, fan_bad, rank_cfg)
        opt.step(torch.autograd.grad(loss, params))
        return stats

    return step


@torch.no_grad()
def run_eval(model, ev: Dict[str, np.ndarray]) -> Tuple[Dict, List[np.ndarray]]:
    """Held-out metrics of the critic's deterministic energies on a dump:
    the mean per-demo Spearman correlation of energy and badness, the
    success of the lowest-energy sample (executed), of a random one
    (unranked) and of the best, the mean badness regret of the executed
    sample, and how often it avoids a gross failure when a demo has a good
    sample; and every demo's energies."""
    from scipy.stats import spearmanr

    was = model.training
    model.eval()
    device = next(model.parameters()).device
    Ed, sp = [], []
    sel_succ, unranked_succ, best_succ, regret, gross_ok = [], [], [], [], []
    try:
        for d in range(ev["samples"].shape[0]):
            scene, grasp = dump_clouds(ev, d, device)
            e = energies(model, torch.as_tensor(ev["samples"][d], device=device), scene, grasp).cpu().numpy()
            b = ev["badness"][d]
            succ = (ev["trans_err"][d] <= 1.0) & (ev["rot_err_deg"][d] <= 5.0)
            i = int(np.argmin(e))
            Ed.append(e)
            sp.append(float(spearmanr(e, b).statistic) if e.std() > 0 and b.std() > 0 else 0.0)
            sel_succ.append(bool(succ[i]))
            unranked_succ.append(float(succ.mean()))
            best_succ.append(bool(succ.any()))
            regret.append(float(b[i] - b.min()))
            gross_ok.append(bool(b[i] <= 5.0) if (b <= 5.0).any() else True)
    finally:
        model.train(was)
    return {
        "cascade_spearman_mean": round(float(np.mean(sp)), 3),
        "executed_success": round(float(np.mean(sel_succ)), 3),
        "unranked_success": round(float(np.mean(unranked_succ)), 3),
        "best_sample_success": round(float(np.mean(best_succ)), 3),
        "mean_regret_cm_eq": round(float(np.mean(regret)), 3),
        "gross_rejection_rate": round(float(np.mean(gross_ok)), 3),
    }, Ed


def export_float16(path: str, flat: Dict[str, np.ndarray], meta: Dict) -> str:
    """Write flat flax-keyed parameters as the JAX tools ship them: float32
    arrays cast to float16, plus ``__meta__`` (JSON bytes)."""
    out = {k: v.astype(np.float16) if v.dtype == np.float32 else v for k, v in flat.items()}
    out["__meta__"] = np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savez_compressed(path, **out)
    return path


def main(argv=None) -> Dict:
    p = argparse.ArgumentParser(description="Fine-tune an EBM critic on cascade-sample dumps")
    p.add_argument("--configs-root-dir", required=True)
    p.add_argument("--init-params-npz", default=None)
    p.add_argument("--train-dump", required=True)
    p.add_argument("--eval-dump", required=True)
    p.add_argument("--max-epochs", type=int, default=300)
    p.add_argument("--eval-every", type=int, default=25)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--fan-negatives", type=int, default=16,
                   help="per-step synthetic fan negatives (gross-failure anchor)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--export-best", default=None)
    p.add_argument("--out", default=None)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)

    from ..weights import flat_arrays, load_flat_params

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("train_critic_cascade: no CUDA device (pass --device cpu to run on the CPU)")
    model, train_cfg = build_critic(args.configs_root_dir, device, args.init_params_npz, args.seed)
    if args.init_params_npz:
        print(f"warm-started from {args.init_params_npz}", flush=True)
    tr, ev = load_dump(args.train_dump), load_dump(args.eval_dump)
    D, S = tr["samples"].shape[:2]
    print(f"train dump: {D} demos x {S} samples; eval dump: {ev['samples'].shape[0]} x {ev['samples'].shape[1]}",
          flush=True)
    fan_cfg = RankConfig(n_negatives=args.fan_negatives)
    rank_cfg = RankConfig.from_dict(train_cfg.get("critic_rank_configs", {}) or {})
    opt = make_optimizer(list(model.parameters()), args.lr, args.max_epochs * D)
    train_step = make_train_step(model, tr, fan_cfg, rank_cfg, opt,
                                 torch.Generator(device=device).manual_seed(args.seed))

    report = {"epochs": [], "train_dump": args.train_dump, "eval_dump": args.eval_dump}
    best = {"score": -np.inf, "epoch": -1, "params": None}

    def maybe_best(epoch, m):
        score = m["executed_success"] - 0.01 * m["mean_regret_cm_eq"]
        if score > best["score"]:
            best.update(score=score, epoch=epoch, params=flat_arrays(model), metrics=m)
            print(f"  new best @ep {epoch}: executed {m['executed_success']:.3f} "
                  f"(unranked {m['unranked_success']:.3f})", flush=True)

    t0 = time.time()
    m0, _ = run_eval(model, ev)
    print(f"epoch 0 (warm-start): {m0}", flush=True)
    report["epochs"].append({"epoch": 0, **m0})
    maybe_best(0, m0)

    rng = np.random.default_rng(args.seed)
    for epoch in range(1, args.max_epochs + 1):
        stats = [train_step(int(d)) for d in rng.permutation(D)]
        if epoch % 25 == 0 or epoch == 1:
            s = {k: float(torch.stack([st[k].detach() for st in stats]).mean()) for k in stats[0]}
            print(f"epoch {epoch:4d}  loss {s['loss']:.4f}  acc {s['acc']:.3f}  "
                  f"cascade_acc {s['cascade_acc']:.3f}  {time.time() - t0:.0f}s", flush=True)
        if epoch % args.eval_every == 0 or epoch == args.max_epochs:
            m, _ = run_eval(model, ev)
            print(f"  eval @ep {epoch}: {m}", flush=True)
            report["epochs"].append({"epoch": epoch, **m})
            maybe_best(epoch, m)
            if args.out:
                _write(args.out, report)

    # the noise-floor probe on the best parameters
    load_flat_params(model, best["params"])
    _, Ed = run_eval(model, ev)
    report["best"] = {"epoch": best["epoch"], **best["metrics"]}
    report["noise_floor"] = noise_floor_probe(Ed, [ev["badness"][d] for d in range(len(Ed))])
    print(f"best @ep {best['epoch']}: {best['metrics']}", flush=True)
    print(f"noise floor: {report['noise_floor']}", flush=True)
    if args.export_best:
        export_float16(args.export_best, best["params"],
                       dict(tool="train_critic_cascade", best_epoch=best["epoch"], metrics=best["metrics"]))
        print(f"exported best -> {args.export_best}", flush=True)
    if args.out:
        _write(args.out, report)
    return report


def _write(path: str, report: Dict) -> None:
    with open(path, "w") as f:
        json.dump(report, f, indent=1)


if __name__ == "__main__":
    main()
