"""The plain reference of a served request, and the numbers that decide
``correct`` for a serve cell.

The reference (``edf/``: the program's plain PyTorch path, copied, with no
kernel, no compiled runtime and no batching) loads the same ``.npz``
weights, preprocesses the request's raw clouds itself and extracts its own
features.  The served trajectory is the program's answer; of it the
reference reads:

* ``step_gap``: each served step ``T_k -> T_{k+1}`` is a function of the
  served ``T_k`` and of the step's noise.  The noise is the program's own
  draw, and the reference draws it again: the agent seeds one generator a
  call from numpy's global generator, whose state the harness keeps at each
  call, and draws each stage's blocks for the whole call's batch, in its
  order (``noise_blocks``).  The reference takes the step from the served
  ``T_k`` (metres to the model's centimetres, as the reply's unit says),
  with the noise of the seed behind each served pose (the reply sorts them
  by energy), at steps drawn from the seed in every segment of every stage.
  The gap to the served ``T_{k+1}`` is taken as a share of the largest move
  that the score makes in the segment's sampled steps (the step without its
  noise), rotation (quaternion) and translation each; ``step_gap`` is the
  largest over the segments.  It covers the preprocessing, each stage's
  extraction (the place query's keypoint extractor too), its score and
  Langevin update on the replayed graphs, and the reply's unit and order.
* ``energy_gap``: the critic's energy of each served final pose against the
  energy served beside it, as a share of the largest reference energy: the
  critic's preprocessing, extraction and energy, and the order it gives.

``control=True`` puts the reference in TF32 (the precision below float32
with TF32 off) in the program's place: the served ``T_{k+1}`` and energies
are replaced by what TF32 gives from the same served ``T_k``, noise and
poses.
"""
from __future__ import annotations

import contextlib
import math
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .edf.data import stack_points
from .edf.diffusion.langevin import build_schedule, draws_noise, langevin_step, schedule_table
from .edf.train.data import PointCloud, TargetPoseDemo, compose_proc_fn, pad_pointcloud
from .edf.train.factory import build_score_model
from .edf.weights import init_params, load_params_npz

__all__ = ["ReferenceModels", "precision", "check_request", "stage_schedules", "noise_blocks"]


@contextlib.contextmanager
def precision(tf32: bool):
    """Float32 products in float32 (``tf32=False``, the configuration's
    precision) or in TF32 (the control), restored after."""
    old = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


class ReferenceModels:
    """The configuration's models built by the reference, with its own
    weights: the checkpoint, or seeded ones where the configuration gives
    none (the tests' tiny models)."""

    def __init__(self, cfg: Dict[str, Any], root: str, device: str):
        import os

        self.cfg, self.device = cfg, torch.device(device)
        self.models, self.mults = {}, {}
        for name in list(cfg["cascade"]) + ([cfg["critic"]] if cfg.get("critic") else []):
            m = cfg["models"][name]
            mc = m["score_model_configs"]
            model = build_score_model(mc["model_name"], mc["model_kwargs"])
            init_params(model, torch.Generator().manual_seed(int(m.get("init_seed", 0))))
            if m.get("checkpoint") is not None:
                load_params_npz(model, os.path.join(root, m["checkpoint"]))
            self.models[name] = model.to(self.device).eval()
            sh = mc["model_kwargs"]["score_head_kwargs"]
            self.mults[name] = (float(sh["ang_mult"]), float(sh["lin_mult"]))
        prep = cfg["preprocess"]
        self.proc_fn = compose_proc_fn(prep["preprocess_config"])
        self.unrescale = 1.0
        for op in prep["unprocess_config"]:
            if op["name"] == "rescale":
                self.unrescale *= float(op["kwargs"]["rescale_factor"])

    def prep(self, scene: PointCloud, grasp: PointCloud):
        demo = self.proc_fn(TargetPoseDemo(scene_pcd=scene, grasp_pcd=grasp, target_poses=np.zeros((1, 7))))
        return demo.scene_pcd, demo.grasp_pcd

    def extract(self, name: str, scene_p: PointCloud, grasp_p: PointCloud):
        """One request's key scales and query, as R = 1."""
        model, dev = self.models[name], self.device
        keys = model.get_key_pcd_multiscale(pad_pointcloud(scene_p, int(self.cfg["n_scene_pad"]), dev))
        query = model.get_query_pcd(pad_pointcloud(grasp_p, int(self.cfg["n_grasp_pad"]), dev))
        return [stack_points([p]) for p in keys], stack_points([query])

    def to_model_units(self, T_m: np.ndarray) -> np.ndarray:
        """Served poses (metres) in the models' units, float32."""
        T = np.array(T_m, dtype=np.float64)
        T[..., 4:] /= self.unrescale
        return T.astype(np.float32)


def stage_schedules(refs: ReferenceModels) -> List[Any]:
    """Each stage's schedule (``build_schedule``) under the configuration's
    diffusion configs."""
    dc = refs.cfg["diffusion_configs"]
    out = []
    for i, name in enumerate(refs.cfg["cascade"]):
        ang, lin = refs.mults[name]
        out.append(build_schedule(
            diffusion_schedules=dc["diffusion_schedules_list"][i], N_steps=dc["N_steps_list"][i],
            timesteps=dc["timesteps_list"][i], ang_mult=ang, lin_mult=lin,
            temperatures=dc["temperatures_list"][i], log_t_schedule=dc.get("log_t_schedule", True),
            time_exponent_temp=dc.get("time_exponent_temp", 1.0),
            time_exponent_alpha=dc.get("time_exponent_alpha", 0.5)))
    return out


def noise_blocks(schedules, seed: int, R: int, nT: int, row: int, device) -> List[Dict[int, torch.Tensor]]:
    """The Langevin noise of row ``row`` of an agent call of ``R`` requests
    of ``nT`` seeds whose noise generator was seeded with ``seed``: for each
    stage, each step that draws noise to its (2, nT, 3) block.  The draws are
    the program's, in its order: one generator for the call, and at each
    stage one (R, nT, 3) block for the angular part, then one for the
    linear part, for every step at a temperature above 0."""
    gen = torch.Generator(device=device).manual_seed(int(seed))
    out = []
    for sched in schedules:
        blocks = {}
        for j in np.flatnonzero(draws_noise(sched)):
            ang = torch.randn((R, nT, 3), generator=gen, device=device)
            lin = torch.randn((R, nT, 3), generator=gen, device=device)
            blocks[int(j)] = torch.stack([ang[row], lin[row]])
        out.append(blocks)
    return out


def sampled_steps(refs: ReferenceModels, schedules, n: int, rng: np.random.Generator):
    """(stage, segment, step, row offset in the trajectory) of ``n`` steps
    drawn by ``rng`` from every segment of every stage (all of a shorter
    segment)."""
    out, off = [], 0
    for s, sched in enumerate(schedules):
        a = 0
        for g, length in enumerate(refs.cfg["diffusion_configs"]["N_steps_list"][s]):
            steps = np.arange(a, a + int(length))
            pick = steps if len(steps) <= n else np.sort(rng.choice(steps, size=n, replace=False))
            out += [(s, g, int(j), off) for j in pick]
            a += int(length)
        off += len(sched.t) + 1
    return out


def seed_order(traj0_m: np.ndarray, Ts_init_m: np.ndarray) -> Optional[np.ndarray]:
    """The seed of the request behind each served pose (the reply sorts the
    poses by energy): the nearest initial seed to each served first pose,
    or None where that is not one to one."""
    d = np.abs(np.asarray(traj0_m, np.float64)[:, None, :] - np.asarray(Ts_init_m, np.float64)[None]).max(-1)
    perm = d.argmin(1)
    return perm if len(set(perm.tolist())) == len(perm) else None


@torch.no_grad()
def check_request(refs: ReferenceModels, scene: PointCloud, grasp: PointCloud, Ts_init_m: np.ndarray,
                  traj_m: np.ndarray, energy: Optional[Sequence[float]], n_steps: int, rng: np.random.Generator,
                  noise: Tuple[int, int, int, int], control: bool = False) -> Dict[str, float]:
    """``step_gap`` and ``energy_gap`` of one served request (``Ts_init_m``:
    its seeds, metres; ``traj_m``: the reply's trajectories (rows, nT, 7),
    metres; ``energy``: the reply's energies; ``noise``: (the seed of the
    call's noise generator, the request's row in the call, the call's
    request and seed counts)).  ``control``: TF32 in the program's place."""
    cfg, dev = refs.cfg, refs.device
    scene_p, grasp_p = refs.prep(scene, grasp)
    traj = refs.to_model_units(traj_m)
    schedules = stage_schedules(refs)
    out: Dict[str, float] = {}
    order = seed_order(traj_m[0], Ts_init_m)
    if order is None:
        return {"step_gap": math.inf}
    seed, row, R, nT = noise
    blocks = noise_blocks(schedules, seed, R, nT, row, dev)
    # per (stage, segment): [largest gap, largest move of the score's part of the step], rotation and translation
    gaps: Dict[Tuple[int, int], Dict[str, List[float]]] = {}
    feats = {}
    for s, g, j, off in sampled_steps(refs, schedules, n_steps, rng):
        name = cfg["cascade"][s]
        model = refs.models[name]
        ang, lin = refs.mults[name]
        table = torch.as_tensor(schedule_table(schedules[s], ang, lin), device=dev)
        eps = blocks[s].get(j)
        eps = None if eps is None else eps[:, torch.as_tensor(order, device=dev)][:, None]

        def one_step(tf32: bool, with_noise: bool = True):
            with precision(tf32):
                if (name, tf32) not in feats:
                    feats[name, tf32] = refs.extract(name, scene_p, grasp_p)
                key_ms, query = feats[name, tf32]
                T = torch.as_tensor(traj[off + j], device=dev)[None].clone()
                langevin_step(lambda Ts, t: model.score(Ts, key_ms, query, t), T, table,
                              torch.tensor([j], device=dev), eps if with_noise else None)
            return T[0].cpu().numpy().astype(np.float64)

        ref = one_step(False)
        drift = ref if eps is None else one_step(False, with_noise=False)
        got = one_step(True) if control else traj[off + j + 1].astype(np.float64)
        prev = traj[off + j].astype(np.float64)
        seg = gaps.setdefault((s, g), {"q": [0.0, 0.0], "x": [0.0, 0.0]})
        for key, sl in (("q", slice(0, 4)), ("x", slice(4, 7))):
            gap = float(np.abs(got[:, sl] - ref[:, sl]).max())
            seg[key][0] = max(seg[key][0], gap if math.isfinite(gap) else math.inf)
            seg[key][1] = max(seg[key][1], float(np.abs(drift[:, sl] - prev[:, sl]).max()))
    for (s, g), seg in gaps.items():
        ratio = max(seg[k][0] / max(seg[k][1], 1e-30) for k in ("q", "x"))
        out[f"step_gap.{cfg['cascade'][s]}.{g}"] = ratio
        out["step_gap"] = max(out.get("step_gap", 0.0), ratio)
    if cfg.get("critic") and energy is not None:
        name = cfg["critic"]
        T = torch.as_tensor(traj[-1], device=dev)[None]
        with precision(False):
            key_ms, query = refs.extract(name, scene_p, grasp_p)
            E_ref = refs.models[name].energy(T, key_ms, query, torch.ones(T.shape[:2], device=dev))[0]
        E_ref = E_ref.cpu().numpy().astype(np.float64)
        if control:
            with precision(True):
                key_ms, query = refs.extract(name, scene_p, grasp_p)
                E = refs.models[name].energy(T, key_ms, query, torch.ones(T.shape[:2], device=dev))[0]
            E = E.cpu().numpy().astype(np.float64)
        else:
            E = np.asarray(energy, dtype=np.float64)
        out["energy_gap"] = float(np.abs(E - E_ref).max() / max(np.abs(E_ref).max(), 1e-30))
    if not all(math.isfinite(v) for v in out.values()):
        out = {k: (v if math.isfinite(v) else math.inf) for k, v in out.items()}
    return out
