"""The train driver: the port's ``DiffusionEdfTrainer`` (the compiled step,
``use_runtime=True``) on the mix's synthetic demos, from the
configuration's checkpoint.

Set-up builds the trainer and runs its first epoch (``train_epoch``: every
demo's entry made, its first step run eagerly and the step captured), then
drives it from the seed through the first steps of the next epoch, in
``train_epoch``'s order: replays of the captured steps, which the window
replays too.  Of those steps it keeps the readings the reference is held
to: each step's loss, the first gradient as the optimizer holds it (from
its first moment before and after the step), and the change of the
parameters and of their EMA over the steps.  The window repeats
``train_epoch`` until ``--seconds`` have passed; each epoch reads its
statistics once, so the window ends synchronised.  With ``--trace 1`` one
more epoch runs under the profiler once the window has closed.

After the window the peak memory is read, the trainer is dropped and the
reference trainer takes the same first steps.
"""
from __future__ import annotations

import gc
import math
import shutil
import sys
import tempfile
import time
from typing import Any, Dict, List

import numpy as np
import torch

from . import port, traffic
from .drivers import Run, device_record
from ..metrics.readers import plain_wall_s
from .trace import profile_call

__all__ = ["run", "first_steps", "epoch_order"]


def first_steps(run: Run, seed: int, tmp: str):
    """The trainer of ``seed``'s demos after its first epoch, driven through
    the first steps of the next, and (trainer, its readings, the demos, the
    first epoch's order, the order of the steps read)."""
    from ..reference.train_check import Readings, first_gradient, leaf_norms

    cfg, params = run.spec.config, run.mix.params
    demos = traffic.demos(params, seed)
    tr = port.build_trainer(cfg, tmp, run.root, run.device, seed % 2**63, demos)
    warm = epoch_order(len(tr.batches), tr.epoch)
    tr.train_epoch()
    order = epoch_order(len(tr.batches), tr.epoch)[:int(params["check"]["steps"])]
    p0, e0 = [p.detach().clone() for p in tr.params], [e.detach().clone() for e in tr.ema]
    losses, grad = [], None
    for k, i in enumerate(order):
        mu0 = [m.clone() for m in tr.optimizer.state_arrays()["mu"]] if k == 0 else None
        losses.append(tr.step(tr.batches[i])["loss/train"])
        if k == 0:
            grad = leaf_norms(first_gradient(mu0, tr.optimizer.state_arrays()["mu"], tr.optimizer.b1))
    prog = Readings(losses=losses, grad=grad, change=leaf_norms([p.detach() - q for p, q in zip(tr.params, p0)]),
                    ema=leaf_norms([e.detach() - q for e, q in zip(tr.ema, e0)]))
    return tr, prog, demos, warm, order


def epoch_order(n: int, epoch: int) -> List[int]:
    """``train_epoch``'s order of the demos in epoch ``epoch``."""
    order = np.arange(n)
    np.random.default_rng(epoch).shuffle(order)
    return order.tolist()


def run(run: Run) -> Dict[str, Any]:
    from ..reference.train_check import numbers, reference_readings

    cfg, params = run.spec.config, run.mix.params
    tmp = tempfile.mkdtemp(prefix="benchmark_")
    record: Dict[str, Any] = {"calls": []}
    try:
        tr, prog, demos, warm, order = first_steps(run, run.seed, tmp)
        entries0 = tr.cache_size()
        record["setup_s"] = time.perf_counter() - run.t_start
        steps, epochs, failed, ends = 0, 0, 0, []
        t0 = time.perf_counter()
        while True:
            last = tr.train_epoch()
            steps += len(tr.batches)
            epochs += 1
            ends.append(time.perf_counter())
            if not math.isfinite(last.get("loss/train", math.nan)):
                failed += len(tr.batches)
            if time.perf_counter() - t0 >= run.seconds:
                break
        record["window_s"] = time.perf_counter() - t0
        record["epoch_s"] = [b - a for a, b in zip([t0] + ends, ends)]
        print(f"window: {epochs} epochs of {len(tr.batches)} steps, epoch ms "
              f"{[round(1e3 * e, 1) for e in record['epoch_s']]}", file=sys.stderr)
        record["steps"], record["attempted"], record["failed"] = steps, steps, failed
        record["entries"] = (entries0, tr.cache_size())
        record["device"] = device_record(run.device)
        if run.trace:
            _, prof = profile_call(tr.train_epoch)
            record["calls"].append({"profile": prof, "steps": len(tr.batches)})
        del tr
        gc.collect()
        if run.device == "cuda":
            torch.cuda.empty_cache()
        ref = reference_readings(cfg, run.root, run.device, run.seed % 2**63, demos, warm, order)
        got = numbers(prog, ref)
        record["readings"] = got
        limits = params["check"]["limits"]
        record["checks"] = {k: {"value": got.get(k, float("inf")), "limit": limits[k]} for k in limits}
        for c in record["calls"]:
            c["profile"] = c["profile"]()
        prof = next((c["profile"] for c in record["calls"]), None)
        if prof is not None:
            record["device"].update(busy_s=prof["busy_s"], window_s=prof["window_s"])
            print(f"trace: busy_s {prof['busy_s']!r}, window_s (first kernel to last) {prof['window_s']!r}, "
                  f"profiled wall_s {prof['wall_s']!r}, the window's median epoch {plain_wall_s(record)!r}",
                  file=sys.stderr)
            record["breakdown"] = {"device_ops": prof.get("device_ops", []), "idle_gaps": prof.get("idle_gaps", [])}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return record
