"""Inference-schedule sweep for the pick / place cascade (counterpart of the
JAX repository's ``tools/sweep_schedule.py``: the same candidates, the same
report).

Each candidate spreads annealing brackets over the two-stage cascade (the
first ``split`` brackets on lowres, the rest on highres); every candidate is
evaluated with ``eval.evaluate_agent`` on each split's held-out demos, the
report is rewritten after each candidate (a cut run keeps what it
finished), and the winner is the candidate with the best mean success over
the splits::

    python -m diffusion_edf_tpu_torch.tools.sweep_schedule --task-type pick \\
        --checkpoint-dir checkpoints/panda_mug/pick_lowres.npz \\
        --cascade-checkpoint-dir checkpoints/panda_mug/pick_highres.npz \\
        --out build/schedule_sweep_pick.json [--round2] [--device cpu]
"""
from __future__ import annotations

import argparse
import json
import time
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

from ..eval import PREPROCESS, UNPROCESS, to_diffusion_configs

__all__ = ["candidate_schedules", "round2_schedules", "to_diffusion_configs", "sweep", "main"]

_HEAD = [[1.0, 0.15], [0.15, 0.09], [0.09, 0.03], [0.03, 0.012]]


def round2_schedules(task_type: str) -> List[Dict]:
    """Refinements around the first round's winner, ``low_floor`` (its
    control first): floors down to the highres models' training floor
    t = 0.003, a smaller quench step, a cold last bracket, and a floor
    slightly below the training range."""
    warm = [1.0, 1.0, 1.0, 1.0, 1.0, 0.0]
    dts = [0.04, 0.04, 0.02, 0.02, 0.01]
    floor3 = _HEAD + [[0.012, 0.003], [0.003, 0.003]]
    return [
        dict(name="low_floor", steps=[200, 200, 200, 200, 100, 150], dts=dts + [0.01], temps=warm,
             scheds=_HEAD + [[0.012, 0.005], [0.005, 0.005]], split=2),
        dict(name="floor3", steps=[200, 200, 200, 200, 150, 150], dts=dts + [0.01], temps=warm,
             scheds=floor3, split=2),
        dict(name="floor3_small_dt", steps=[200, 200, 200, 200, 150, 300], dts=dts + [0.005], temps=warm,
             scheds=floor3, split=2),
        dict(name="floor3_cold", steps=[200, 200, 200, 200, 150, 200], dts=dts + [0.008],
             temps=[1.0, 1.0, 1.0, 1.0, 0.5, 0.0], scheds=floor3, split=2),
        dict(name="floor2_extrap", steps=[200, 200, 200, 200, 150, 200], dts=dts + [0.008], temps=warm,
             scheds=_HEAD + [[0.012, 0.002], [0.002, 0.002]], split=2),
    ]


def candidate_schedules(task_type: str) -> List[Dict]:
    """The first round: the reference recipe (``server.yaml``), a 3x longer
    temperature-0 quench, annealing down to t = 0.005 before the quench
    (warm, cold, and with a smaller step at 0.004), and a budget moved from
    the coarse into the fine decade.  Each: ``name``, per bracket
    ``steps``, ``dts``, ``temps``, ``scheds``, and the cascade ``split``."""
    base = _HEAD + [[0.012, 0.012]]
    low = _HEAD + [[0.012, 0.005], [0.005, 0.005]]
    dts = [0.04, 0.04, 0.02, 0.02, 0.01]
    return [
        dict(name="reference", steps=[200, 200, 200, 200, 100], dts=dts, temps=[1.0, 1.0, 1.0, 1.0, 0.0],
             scheds=base, split=2),
        dict(name="long_quench", steps=[200, 200, 200, 200, 300], dts=dts, temps=[1.0, 1.0, 1.0, 1.0, 0.0],
             scheds=base, split=2),
        dict(name="low_floor", steps=[200, 200, 200, 200, 100, 150], dts=dts + [0.01],
             temps=[1.0, 1.0, 1.0, 1.0, 1.0, 0.0], scheds=low, split=2),
        dict(name="low_floor_cold", steps=[200, 200, 200, 200, 100, 200], dts=dts + [0.01],
             temps=[1.0, 1.0, 1.0, 1.0, 0.5, 0.0], scheds=low, split=2),
        dict(name="dense_low_t", steps=[150, 150, 250, 300, 250], dts=[0.04, 0.04, 0.02, 0.015, 0.008],
             temps=[1.0, 1.0, 1.0, 1.0, 0.0],
             scheds=[[1.0, 0.15], [0.15, 0.09], [0.09, 0.025], [0.025, 0.008], [0.008, 0.008]], split=2),
        dict(name="low_floor_small_dt", steps=[200, 200, 200, 200, 100, 300], dts=dts + [0.005],
             temps=[1.0, 1.0, 1.0, 1.0, 1.0, 0.0],
             scheds=_HEAD + [[0.012, 0.004], [0.004, 0.004]], split=2),
    ]


def sweep(agent, cands: Sequence[Dict], eval_sets: Dict, task_type: str, n_demos: int, n_seeds: int, seed: int,
          out: Optional[str] = None, on_entry: Optional[Callable[[Dict], None]] = None) -> Dict:
    """Evaluate every candidate on every split of ``eval_sets`` (name ->
    demos) and return the report; ``out`` is rewritten after each
    candidate, and ``on_entry`` is called with each candidate's entry as it
    is finished."""
    from ..eval import evaluate_agent

    n_stages = len(agent.models)
    report = {"task_type": task_type, "n_demos": n_demos, "n_seeds": n_seeds, "candidates": []}
    for c in cands:
        cfg = to_diffusion_configs(c, n_stages=n_stages)
        entry = {"name": c["name"], "total_steps": int(np.sum(c["steps"])),
                 "schedule": {k: c[k] for k in ("steps", "dts", "temps", "scheds", "split")}}
        t0 = time.time()
        for split, dset in eval_sets.items():
            r = evaluate_agent(agent, dset, task_type=task_type, n_seeds=n_seeds, diffusion_configs=cfg, seed=seed)
            entry[split] = {
                "success": r["success_rate"],
                "best_success": r["best_sample_success_rate"],
                "trans_cm_median": r["trans_err_cm"]["median"],
                "rot_deg_median": r["rot_err_deg"]["median"],
            }
            print(f"[{c['name']}][{split}] success {r['success_rate']:.3f} "
                  f"trans {r['trans_err_cm']['median']:.3f} cm rot {r['rot_err_deg']['median']:.2f} deg "
                  f"({time.time() - t0:.0f}s)", flush=True)
        entry["wall_s"] = round(time.time() - t0, 1)
        report["candidates"].append(entry)
        if on_entry is not None:
            on_entry(entry)
        if out:
            _write(out, report)
    splits = list(eval_sets)
    ranked = sorted(report["candidates"], key=lambda e: np.mean([e[s]["success"] for s in splits if s in e]),
                    reverse=True)
    report["winner"] = ranked[0]["name"]
    print(f"winner: {report['winner']}", flush=True)
    if out:
        _write(out, report)
    return report


def _write(path: str, report: Dict) -> None:
    with open(path, "w") as f:
        json.dump(report, f, indent=1)


def main(argv=None) -> Dict:
    p = argparse.ArgumentParser(description="Sweep inference schedules of a pick / place cascade")
    p.add_argument("--task-type", default="pick", choices=["pick", "place"])
    p.add_argument("--configs-root-dir", default="diffusion_edf_tpu_torch/configs/panda_mug/pick_lowres")
    p.add_argument("--checkpoint-dir", required=True, help="the first stage's flat .npz weights")
    p.add_argument("--cascade-configs-root-dir", default="diffusion_edf_tpu_torch/configs/panda_mug/pick_highres")
    p.add_argument("--cascade-checkpoint-dir", default=None)
    p.add_argument("--n-demos", type=int, default=10)
    p.add_argument("--n-seeds", type=int, default=10)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--splits", nargs="*", default=["default", "unseen_poses"])
    p.add_argument("--round2", action="store_true", help="refinement candidates around the round-1 winner")
    p.add_argument("--out", default=None)
    p.add_argument("--device", default="cuda", help="the models' device (cuda or cpu)")
    args = p.parse_args(argv)

    from ..agent import DiffusionEdfAgent, load_model_bundle
    from ..train.synthetic import make_split_dataset

    bundles = [load_model_bundle(args.configs_root_dir, checkpoint=args.checkpoint_dir, device=args.device)]
    if args.cascade_checkpoint_dir:
        bundles.append(load_model_bundle(args.cascade_configs_root_dir, checkpoint=args.cascade_checkpoint_dir,
                                         device=args.device))
    agent = DiffusionEdfAgent(bundles, PREPROCESS, UNPROCESS)
    eval_sets = {name: make_split_dataset(name, n_demos=args.n_demos, seed=args.seed + 1000)
                 for name in args.splits}
    cands = (round2_schedules if args.round2 else candidate_schedules)(args.task_type)
    return sweep(agent, cands, eval_sets, args.task_type, args.n_demos, args.n_seeds, args.seed, out=args.out)


if __name__ == "__main__":
    main()
