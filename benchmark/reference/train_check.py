"""The plain reference of the first train steps, and the numbers that decide
``correct`` for a train cell.

The reference trainer (``edf/train/trainer.py``: the program's eager step,
copied) is built from the same config dicts, seed, demos and checkpoint as
the program's, and steps through the same demos in the same order: its
draws (one generator on the device, in the program's order) are the
program's.  Readings of a run, for each side:

Both sides first run one epoch (the program's first step on each demo is
eager, and captures the step), then the readings are taken over the first
steps of the next epoch, which the program replays:

* the loss of each of those steps;
* the gradient of the first of them as the optimizer gets it, worked out
  from its first moment before and after the step
  (``(mu_1 - beta1 mu_0) / (1 - beta1)``), as a norm a leaf;
* the parameters' change over the steps, as a norm a leaf;
* the EMA's change over the steps, as a norm a leaf.

The numbers compare the norms, not the norm of their difference, leaf by
leaf, each against the reference's norm of that leaf or of the median leaf,
whichever is larger, and take the worst leaf.  Leaves whose reference
gradient is under a thousandth of the median leaf's move by round-off alone
and are left out of the changes.
"""
from __future__ import annotations

import os
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from .edf.train.trainer import ReferenceTrainer
from .serve_check import precision

__all__ = ["Readings", "leaf_norms", "first_gradient", "reference_readings", "numbers", "TINY_GRAD"]

TINY_GRAD = 1e-3  # of the median leaf's gradient norm: leaves under it are not compared on their change


class Readings(dict):
    """``losses`` (per step), ``grad`` (leaf norms of the first gradient),
    ``change`` and ``ema`` (leaf norms of the parameters' and the EMA's
    change)."""


def leaf_norms(tensors: Sequence[torch.Tensor]) -> List[float]:
    return [float(torch.linalg.vector_norm(t.detach().double())) for t in tensors]


def first_gradient(mu0: Sequence[torch.Tensor], mu1: Sequence[torch.Tensor], b1: float) -> List[torch.Tensor]:
    """The gradient of one step as AMSGrad gets it, from its first moment
    before (``mu0``) and after (``mu1``) the step."""
    return [(b.double() - b1 * a.double()) / (1 - b1) for a, b in zip(mu0, mu1)]


def reference_readings(cfg: Dict[str, Any], root: str, device: str, seed: int, demos, warm: Sequence[int],
                       order: Sequence[int], tf32: bool = False,
                       plant: Optional[Callable[[ReferenceTrainer], None]] = None) -> Readings:
    """The reference's readings over the steps on ``demos`` in ``order``,
    after an epoch in the order ``warm``.  ``tf32``: the control's
    precision; ``plant``: plants a fault in the reference trainer (the
    control tool reads the faults so)."""
    name = cfg["train_model"]
    m = cfg["models"][name]
    with precision(tf32):
        ref = ReferenceTrainer(m["train_configs"], m["task_configs"], m["score_model_configs"], device, seed,
                               n_scene_pad=int(cfg["n_scene_pad"]), n_grasp_pad=int(cfg["n_grasp_pad"]))
        ckpt = m.get("checkpoint")
        ref.init(demos, None if ckpt is None else os.path.join(root, ckpt))
        if plant is not None:
            plant(ref)
        for i in warm:
            ref.update(ref.batches[i])
        p0, e0 = [p.detach().clone() for p in ref.params], [e.detach().clone() for e in ref.ema]
        losses, grad = [], None
        for k, i in enumerate(order):
            mu0 = [m.clone() for m in ref.optimizer.mu] if k == 0 else None
            stats = ref.update(ref.batches[i])
            losses.append(float(stats["loss/train"].detach()))
            if k == 0:
                grad = leaf_norms(first_gradient(mu0, ref.optimizer.mu, ref.optimizer.b1))
        change = leaf_norms([p.detach() - q for p, q in zip(ref.params, p0)])
        ema = leaf_norms([e.detach() - q for e, q in zip(ref.ema, e0)])
    return Readings(losses=losses, grad=grad, change=change, ema=ema)


def numbers(prog: Readings, ref: Readings) -> Dict[str, float]:
    """``loss_gap``, ``grad_gap``, ``change_gap``, ``ema_gap`` of ``prog``
    against ``ref``."""
    out = {"loss_gap": max(abs(a - b) / max(abs(b), 1e-30) for a, b in zip(prog["losses"], ref["losses"]))}
    gr, gp = np.asarray(ref["grad"]), np.asarray(prog["grad"])
    med = float(np.median(gr))
    out["grad_gap"] = float(np.max(np.abs(gp - gr) / np.maximum(gr, med)))
    keep = gr >= TINY_GRAD * med
    for key in ("change", "ema"):
        cr, cp = np.asarray(ref[key])[keep], np.asarray(prog[key])[keep]
        out[f"{key}_gap"] = float(np.max(np.abs(cp - cr) / np.maximum(cr, np.median(cr))))
    return {k: (v if np.isfinite(v) else float("inf")) for k, v in out.items()}
