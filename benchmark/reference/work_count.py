"""The work of one profiled agent call, counted by the reference: the least
time of its edge-kernel (K1) calls, and its model FLOPs.

The reference runs the call's extractions on the call's raw clouds, its
score at fixed steps of each stage of the call's own trajectory, and the
critic's energy of its final poses, with every ``GraphAttention`` computing
its edge segment on the slots the mask keeps (``kept_only``).  A hook on each
attention records the rows it is handed and the slots its mask keeps; every
attention call on the card is one K1 launch, whose least time ``work.py``
gives.  Requests served together share one score and one energy call (the
request axis is folded into the rows), and extract one by one.  The FLOPs
are every product of the calls (``torch.utils.flop_counter``), the edge
segments at their kept slots.  A stage's steps are sampled at
``sample_steps`` evenly spaced steps and scaled to all of them.
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch
from torch.utils.flop_counter import FlopCounterMode

from .. import work
from .edf.nn.attention import GraphAttention
from .serve_check import ReferenceModels, precision, stage_schedules

__all__ = ["call_work"]


class _Recorder:
    def __init__(self, models):
        self.calls: List[Tuple[GraphAttention, int, int, int]] = []
        self.seg = {}
        self.gas = [m for model in models for m in model.modules() if isinstance(m, GraphAttention)]
        self.handles = [ga.register_forward_pre_hook(self._hook, with_kwargs=True) for ga in self.gas]
        for ga in self.gas:
            ga.kept_only = True

    def _hook(self, ga, args, kwargs):
        message, _attr, scalars, mask = args[:4]
        nd, nk = message.shape[:2]
        self.calls.append((ga, nd * nk, int(mask.sum()), int(scalars.shape[-1])))

    def least(self, ga, rows: int, kept: int, S: int) -> float:
        if ga not in self.seg:
            self.seg[ga] = work.segment_work(ga)
        flops, _, _, nbytes = work.edge_work(ga, rows, S, valid=kept, seg=self.seg[ga])
        return work.least_seconds(flops, nbytes)

    def folded(self, groups: Sequence[List[Tuple]]) -> float:
        """The least time of calls made once for all requests: each group is
        one request's calls, in the same order."""
        total = 0.0
        for calls in zip(*groups):
            ga, S = calls[0][0], calls[0][3]
            total += self.least(ga, sum(c[1] for c in calls), sum(c[2] for c in calls), S)
        return total

    def close(self):
        for h in self.handles:
            h.remove()
        for ga in self.gas:
            ga.kept_only = False


def _counted(rec: _Recorder, fn):
    rec.calls = []
    with FlopCounterMode(display=False) as fc:
        out = fn()
    return out, rec.calls, fc.get_total_flops()


@torch.no_grad()
def call_work(refs: ReferenceModels, requests: Sequence[Tuple], traj: np.ndarray, sample_steps: int = 5
              ) -> Dict[str, float]:
    """``requests``: the call's (scene, grasp) raw clouds, padding copies
    included; ``traj`` (R, rows, nT, 7): the call's trajectories in the
    models' units.  Returns K1's least seconds and the FLOPs."""
    cfg, dev = refs.cfg, refs.device
    rec = _Recorder(refs.models.values())
    least, flops = 0.0, 0.0
    try:
        with precision(False):
            preps = [refs.prep(s, g) for s, g in requests]
            schedules = stage_schedules(refs)
            off = 0
            for name, sched in zip(cfg["cascade"], schedules):
                feats = []
                for sp, gp in preps:
                    f, calls, fl = _counted(rec, lambda: refs.extract(name, sp, gp))
                    feats.append(f)
                    flops += fl
                    least += sum(rec.least(*c) for c in calls)
                n = len(sched.t)
                js = sorted(set(np.linspace(0, n - 1, sample_steps).round().astype(int).tolist()))
                s_least = s_flops = 0.0
                for j in js:
                    groups = []
                    for r, (key_ms, query) in enumerate(feats):
                        T = torch.as_tensor(traj[r, off + j], device=dev)[None]
                        t = torch.full(T.shape[:2], float(np.float32(sched.t[j])), device=dev)
                        _, calls, fl = _counted(rec, lambda: refs.models[name].score(T, key_ms, query, t))
                        groups.append(calls)
                        s_flops += fl
                    s_least += rec.folded(groups)
                least += s_least / len(js) * n
                flops += s_flops / len(js) * n
                off += n + 1
            if cfg.get("critic"):
                name, groups = cfg["critic"], []
                for r, (sp, gp) in enumerate(preps):
                    (key_ms, query), calls, fl = _counted(rec, lambda: refs.extract(name, sp, gp))
                    flops += fl
                    least += sum(rec.least(*c) for c in calls)
                    T = torch.as_tensor(traj[r, -1], device=dev)[None]
                    _, calls, fl = _counted(rec, lambda: refs.models[name].energy(
                        T, key_ms, query, torch.ones(T.shape[:2], device=dev)))
                    groups.append(calls)
                    flops += fl
                least += rec.folded(groups)
    finally:
        rec.close()
    return {"k1_least_s": least, "flops": flops}
