"""The shipped pick cascade on the first demo of the default split through
the JAX package's evaluation harness and through the port's, on the CPU,
with the same seed poses and at temperature 0, so that no noise enters:

    python tools/torch_eval_vs_jax.py [--n-seeds 10] [--out build/eval_vs_jax.json]

Both harnesses draw the seed poses from ``np.random.default_rng(0)`` in demo
order; the schedule is the one of the committed report
(``reports/schedule_sweep_pick_r2.json``'s winner, 400 + 650 steps) with
every temperature set to 0.  The JAX side runs as its own command line
(``python -m diffusion_edf_tpu.eval``, with ``JAX_PLATFORMS=cpu``), the port's
as ``python -m diffusion_edf_tpu_torch.eval --device cpu``; this script
imports neither package.  It prints both reports' per-demo medians and the
committed report's, and writes them to ``--out``.  It takes about half an
hour on 8 CPU cores at 10 seeds.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SWEEP = os.path.join(ROOT, "reports", "schedule_sweep_pick_r2.json")
REPORT = os.path.join(ROOT, "reports", "eval_pick_cascade.json")


def _args(configs: str, n_seeds: int, schedule: str, out: str):
    ck = os.path.join(ROOT, "checkpoints", "panda_mug")
    return ["--configs-root-dir", os.path.join(configs, "pick_lowres"),
            "--checkpoint-dir", os.path.join(ck, "pick_lowres.npz"),
            "--cascade-configs-root-dir", os.path.join(configs, "pick_highres"),
            "--cascade-checkpoint-dir", os.path.join(ck, "pick_highres.npz"),
            "--schedule-json", schedule, "--task-type", "pick", "--synthetic-demos", "1",
            "--n-seeds", str(n_seeds), "--splits", "default", "--out", out]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--n-seeds", type=int, default=10)
    p.add_argument("--out", default=os.path.join(ROOT, "build", "eval_vs_jax.json"))
    args = p.parse_args(argv)
    work = os.path.join(ROOT, "build", "eval_vs_jax")
    os.makedirs(work, exist_ok=True)
    with open(SWEEP) as f:
        sweep = json.load(f)
    for c in sweep["candidates"]:
        c["schedule"]["temps"] = [0.0] * len(c["schedule"]["temps"])
    schedule = os.path.join(work, "schedule_t0.json")
    with open(schedule, "w") as f:
        json.dump(sweep, f)

    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""), JAX_PLATFORMS="cpu")
    runs = {
        "jax": [sys.executable, "-m", "diffusion_edf_tpu.eval",
                *_args(os.path.join(ROOT, "diffusion_edf_tpu", "configs", "panda_mug"), args.n_seeds, schedule,
                       os.path.join(work, "jax.json"))],
        "port": [sys.executable, "-m", "diffusion_edf_tpu_torch.eval",
                 *_args(os.path.join(ROOT, "diffusion_edf_tpu_torch", "configs", "panda_mug"), args.n_seeds,
                        schedule, os.path.join(work, "port.json")), "--device", "cpu"],
    }
    result = {"n_seeds": args.n_seeds, "temperature": 0.0}
    for name, cmd in runs.items():
        t = time.perf_counter()
        proc = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True, text=True)
        if proc.returncode != 0:
            print(proc.stderr[-3000:], file=sys.stderr)
            raise SystemExit(f"{name} evaluation exited {proc.returncode}")
        with open(os.path.join(work, f"{name}.json")) as f:
            result[name] = json.load(f)["default"]["per_demo"][0]
        result[name]["seconds"] = time.perf_counter() - t
        print(f"{name}: {result[name]}", flush=True)
    with open(REPORT) as f:
        result["report"] = json.load(f)["default"]["per_demo"][0]
    result["port_minus_jax_cm"] = result["port"]["trans_err_cm_median"] - result["jax"]["trans_err_cm_median"]
    result["port_minus_jax_deg"] = result["port"]["rot_err_deg_median"] - result["jax"]["rot_err_deg_median"]
    print(f"committed report (temperature as swept, 10 seeds): {result['report']}")
    print(json.dumps(result))
    with open(args.out, "w") as f:
        json.dump(result, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
