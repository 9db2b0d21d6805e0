"""How far the Langevin noise alone moves the evaluation's per-demo medians.

    python3 tools/torch_eval_noise.py [--demos 2] [--shifts 0 1 2 3 4] [--tasks pick place]
        [--matmul-precision highest] [--out build/eval_noise.json]

Runs the shipped pick and place cascades as ``chip_smoke.py`` phase 11 runs
them (``chip_smoke.eval_cascade``: the first ``--demos`` demos of the default
split, 10 seeds, the schedule sweeps' winners, the default ``edge_impl``)
through ``evaluate_agent`` once per noise shift s.  The seed poses stay the
committed reports' (numpy seed 0); only the generator of demo i moves, from
seed i to 1000 s + i, so s = 0 is phase 11's run.  Prints, per demo, the
committed JAX report's median translation (cm) and rotation (deg) errors,
each shift's, the largest |port - report| over the shifts and the spread
(max - min) of the port's own medians, and writes them as JSON to
``--out``.  ``--matmul-precision medium`` runs PyTorch's float32 matmuls
with bfloat16 inputs (``torch.set_float32_matmul_precision``; the kernels
keep their own float32 products), one pass as a TPU's default precision
does.  Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


class NoiseShift:
    """``agent`` with the Langevin noise of each ``sample`` call drawn from
    the generator's seed plus ``1000 * shift``."""

    def __init__(self, agent, shift: int):
        self.agent, self.shift = agent, shift
        self.models, self.proc_fn = agent.models, agent.proc_fn

    def sample(self, *args, generator, **kwargs):
        import torch

        g = torch.Generator(device=generator.device).manual_seed(generator.initial_seed() + 1000 * self.shift)
        return self.agent.sample(*args, generator=g, **kwargs)


def main() -> int:
    import numpy as np
    import torch

    import chip_smoke as cs
    from diffusion_edf_tpu_torch.eval import evaluate_agent

    ap = argparse.ArgumentParser()
    ap.add_argument("--demos", type=int, default=cs.EVAL_DEMOS)
    ap.add_argument("--shifts", type=int, nargs="+", default=[0, 1, 2, 3, 4])
    ap.add_argument("--tasks", nargs="+", default=list(cs.EVAL_CASCADES), choices=list(cs.EVAL_CASCADES))
    ap.add_argument("--matmul-precision", default="highest", choices=["highest", "high", "medium"])
    ap.add_argument("--out", default=os.path.join(ROOT, "build", "eval_noise.json"))
    args = ap.parse_args()
    torch.set_float32_matmul_precision(args.matmul_precision)
    if not torch.cuda.is_available():
        print("torch_eval_noise: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    out = dict(card=cs.card_line(), demos=args.demos, seeds=cs.EVAL_SEEDS, shifts=args.shifts,
               matmul_precision=args.matmul_precision, cascades={})
    print(f"card: {out['card']}", flush=True)
    for task in args.tasks:
        agent, bundles, demos, cfg, win_name, ref = cs.eval_cascade(dev, task, args.demos)
        runs = []
        for shift in args.shifts:
            t0 = time.perf_counter()
            report = evaluate_agent(NoiseShift(agent, shift), demos, task_type=task, n_seeds=cs.EVAL_SEEDS,
                                    diffusion_configs=cfg, seed=0)
            runs.append(report["per_demo"])
            print(f"{task} shift {shift}: {(time.perf_counter() - t0) / args.demos:.1f} s a demo", flush=True)
        rows = []
        for di, r in enumerate(ref["per_demo"][:args.demos]):
            row = dict(demo=r["demo"], report_trans_cm=r["trans_err_cm_median"],
                       report_rot_deg=r["rot_err_deg_median"])
            for key, rkey in (("trans_cm", "trans_err_cm_median"), ("rot_deg", "rot_err_deg_median")):
                port = np.array([run[di][rkey] for run in runs])
                row[key] = port.tolist()
                row[f"max_off_{key}"] = float(np.abs(port - r[rkey]).max())
                row[f"spread_{key}"] = float(port.max() - port.min())
            rows.append(row)
            print(f"{task} {r['demo']}: report {r['trans_err_cm_median']:.4f} cm {r['rot_err_deg_median']:.4f} deg; "
                  f"port by shift {', '.join(f'{t:.4f}' for t in row['trans_cm'])} cm, "
                  f"{', '.join(f'{a:.4f}' for a in row['rot_deg'])} deg; most off the report "
                  f"{row['max_off_trans_cm']:.4f} cm {row['max_off_rot_deg']:.4f} deg; spread "
                  f"{row['spread_trans_cm']:.4f} cm {row['spread_rot_deg']:.4f} deg", flush=True)
        out["cascades"][task] = dict(schedule=win_name, rows=rows)
        del agent, bundles
        torch.cuda.empty_cache()
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
