"""The control of a cell's correctness check, read on the card: the numbers
that sound runs of the program give, beside those the control gives (the
reference in TF32, the precision below the configuration's float32 with
TF32 off, put in the program's place) and, for a train cell, those of its
planted faults.  The limits in the mixes were set between them.  The
benchmark's own runs never run this.

    python3 -m benchmark.harness.control --workload <cell> --seeds 1 2 3 --seconds 8 [--control-seeds N] --out <file>

A serve cell is set up once; each seed then drives a short window of the
cell's own load, and the reference reads every seed's sample of requests
twice: against the program's answers and against the control's.  A train
cell builds the trainer of each seed, runs its first epoch and takes the
next epoch's first steps; the reference reads them, then the control and
each fault take the same steps in the program's place.  ``--control-seeds
N`` reads the control and the faults on the first N seeds only.  Writes one JSON line a seed to ``--out`` and
prints the largest program reading and the smallest control and fault
reading of each number.
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile
import time
from typing import Any, Dict, List

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

from benchmark.harness import core, drivers, traffic  # noqa: E402

__all__ = ["serve_control", "train_control", "FAULTS"]


def _half_batch(ref) -> None:
    """Half of the poses left out of the loss, the mean taken over the rest."""
    loss = ref.loss

    def half(inputs):
        n = inputs.Ts.shape[0] // 2
        for name in ("Ts", "times", "tgt_ang", "tgt_lin"):
            setattr(inputs, name, getattr(inputs, name)[:n])
        return loss(inputs)

    ref.loss = half


def _ema_frozen(ref) -> None:
    """The EMA left where it is: the update is the optimizer's step alone."""
    ref.apply_grads = ref.optimizer.step


FAULTS = {"half_batch": _half_batch, "ema_frozen": _ema_frozen}


def serve_control(run: drivers.Run, seeds: List[int], seconds: float, n_control: int) -> List[Dict[str, Any]]:
    from . import serve
    from ..reference.serve_check import ReferenceModels

    session = serve.Session(run)
    try:
        windows = [(seed, session.window(seed, seconds)) for seed in seeds]
    finally:
        session.close()
    refs = ReferenceModels(run.spec.config, run.root, run.device)
    out = []
    for k, (seed, done) in enumerate(windows):
        row = {"seed": seed, "requests": len(done), "failed": sum(1 for r in done if not r["ok"]),
               "program": serve.readings(run, done, seed, session.calls, refs=refs)}
        if k < n_control:
            row["control"] = serve.readings(run, done, seed, session.calls, control=True, refs=refs)
        out.append(row)
        print(json.dumps(row), flush=True)
    return out


def train_control(run: drivers.Run, seeds: List[int], n_control: int) -> List[Dict[str, Any]]:
    import gc

    import torch

    from .train import first_steps
    from ..reference.train_check import numbers, reference_readings

    out = []
    for k, seed in enumerate(seeds):
        tmp = tempfile.mkdtemp(prefix="benchmark_")
        try:
            tr, prog, demos, warm, order = first_steps(run, seed, tmp)
            del tr
            gc.collect()
            torch.cuda.empty_cache()
            args = (run.spec.config, run.root, run.device, seed % 2**63, demos, warm, order)
            ref = reference_readings(*args)
            row = {"seed": seed, "program": numbers(prog, ref)}
            if k < n_control:
                row["control"] = numbers(reference_readings(*args, tf32=True), ref)
                for name, plant in FAULTS.items():
                    row[name] = numbers(reference_readings(*args, plant=plant), ref)
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
        out.append(row)
        print(json.dumps(row), flush=True)
    return out


def summary(rows: List[Dict[str, Any]]) -> Dict[str, Dict[str, float]]:
    """The largest program reading and the smallest reading of every other
    column, for each number."""
    out: Dict[str, Dict[str, float]] = {}
    for col in [k for k in rows[0] if isinstance(rows[0][k], dict)]:
        for name in rows[0][col]:
            vals = [r[col][name] for r in rows if col in r]
            out.setdefault(name, {})[col] = max(vals) if col == "program" else min(vals)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--seconds", type=float, default=8.0)
    p.add_argument("--control-seeds", type=int, default=None,
                   help="read the control and the faults on the first N seeds only (default: all)")
    p.add_argument("--out", required=True)
    args = p.parse_args(argv)
    n_control = len(args.seeds) if args.control_seeds is None else args.control_seeds
    t_start = time.perf_counter()
    spec = core.load_spec(args.workload)
    mix = traffic.load_mix(spec.traffic)
    run = drivers.Run(spec=spec, mix=mix, seed=args.seeds[0], seconds=args.seconds, trace=False, device="cuda",
                      root=core.ROOT, t_start=t_start)
    rows = (serve_control(run, args.seeds, args.seconds, n_control) if mix.kind == "serve"
            else train_control(run, args.seeds, n_control))
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        for r in rows:
            f.write(json.dumps(r) + "\n")
    print(json.dumps({"workload": args.workload, "card": drivers.card_power(), "summary": summary(rows)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
