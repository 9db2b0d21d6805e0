"""The train step of the program's ``train/trainer.py``, copied as the plain
reference: eager, on one device, with no compiled runtime and no mesh.
The same seed, demos and checkpoint give the same draws (one generator on
the device, in the program's order) and, up to float32 rounding, the same
losses, gradients and updates."""
from __future__ import annotations

import dataclasses
import math
import os
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import yaml

from ..data import FeaturedPoints, stack_points
from ..diffusion.diffuse import biequiv_diffusion, random_time
from ..geom import so3
from ..models.score_model import train_loss
from ..weights import init_params, load_params_npz
from .augment import AugmentConfig, _frame_about, augment_batch
from .data import DemoSequence, compose_proc_fn, pad_pointcloud
from .factory import build_score_model
from .optim import Amsgrad, global_norm
from .ranking import RankConfig, rank_loss, sample_ranked_poses


def load_configs(
    configs_root_dir: str,
    train_configs_file: str = "train_configs.yaml",
    task_configs_file: str = "task_configs.yaml",
) -> Tuple[Dict, Dict, Dict]:
    """Load the (train, task, model) config dicts of one config directory."""
    with open(os.path.join(configs_root_dir, train_configs_file)) as f:
        train_cfg = yaml.safe_load(f)
    with open(os.path.join(configs_root_dir, task_configs_file)) as f:
        task_cfg = yaml.safe_load(f)
    with open(os.path.join(configs_root_dir, train_cfg["model_config_file"])) as f:
        model_cfg = yaml.safe_load(f)
    return train_cfg, task_cfg, model_cfg


@dataclasses.dataclass
class DemoBatch:
    """One preprocessed, padded demo on the trainer's device: the target
    pose (1, 7) and, for a demo that records a world-z symmetry orbit, the
    orbit's centre (3,) (``sym_on``)."""

    scene: FeaturedPoints
    grasp: FeaturedPoints
    T: torch.Tensor
    sym_center: torch.Tensor
    sym_on: bool


@dataclasses.dataclass
class StepInputs:
    """What the loss of one step reads, all random draws made: the
    augmented clouds, the diffused poses (N, 7), their times (N,) and score
    targets (N, 3), and for a critic the ranked poses (1 + n, 7) with their
    badness."""

    scene: FeaturedPoints
    grasp: FeaturedPoints
    Ts: torch.Tensor
    times: torch.Tensor
    tgt_ang: torch.Tensor
    tgt_lin: torch.Tensor
    Ts_rank: Optional[torch.Tensor] = None
    badness: Optional[torch.Tensor] = None


class ReferenceTrainer:
    """The program's ``DiffusionEdfTrainer`` reduced to its eager step:
    built from the same config dicts, it draws, scores, differentiates and
    updates as the program's ``update`` does."""

    def __init__(self, train_cfg: Dict, task_cfg: Dict, model_cfg: Dict, device: Union[str, torch.device],
                 seed: int, n_scene_pad: int = 2048, n_grasp_pad: int = 512):
        self.device = torch.device(device)
        self.train_cfg, self.task_cfg, self.model_cfg = train_cfg, task_cfg, model_cfg
        self.task_type: str = task_cfg["task_type"]
        self.contact_radius = float(task_cfg["contact_radius"]) * float(train_cfg.get("rescale_factor", 1.0))
        self.n_samples_x_ref = int(train_cfg.get("n_samples_x_ref", 10))
        diff = train_cfg.get("diffusion_configs", {})
        self.time_schedules: List[Tuple[float, float]] = [tuple(s) for s in diff.get("time_schedules", [[1.0, 0.01]])]
        self.t_augment = diff.get("t_augment", None)
        aug_cfg = dict(train_cfg.get("augment_configs", {}) or {})
        self.sym_orbit_augment = bool(aug_cfg.pop("sym_orbit", True))
        self.augment = AugmentConfig.from_dict(aug_cfg)
        self.n_scene_pad, self.n_grasp_pad = n_scene_pad, n_grasp_pad
        self.seed = seed
        self.model = build_score_model(model_cfg["model_name"], model_cfg["model_kwargs"]).to(self.device)
        self.params = list(self.model.parameters())
        head = model_cfg["model_kwargs"]["score_head_kwargs"]
        self.is_ebm = bool(head.get("ebm", False))
        self.rank_cfg: Optional[RankConfig] = (
            RankConfig.from_dict(train_cfg.get("critic_rank_configs", {})) if self.is_ebm else None)
        if self.rank_cfg is not None and self.rank_cfg.weight <= 0.0:
            self.rank_cfg = None
        self.ang_mult, self.lin_mult = float(head["ang_mult"]), float(head["lin_mult"])
        self.proc_fn = compose_proc_fn(train_cfg.get("preprocess_config", []), seed=seed)
        self.opt_kwargs = dict(train_cfg.get("optimizer_kwargs", {}) or {})
        self.ema_decay = self.opt_kwargs.pop("ema_decay", None)
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        self.model.set_dropout_generator(self.generator)
        self.batches: List[DemoBatch] = []

    def prepare_batches(self, demos: Sequence[DemoSequence]) -> None:
        """Preprocess and pad every demo of this task once (the demo sets are
        small, so they live on the device)."""
        step_idx = 0 if self.task_type == "pick" else 1
        self.batches = []
        for seq in demos:
            demo = self.proc_fn(seq[step_idx])
            sym = demo.symmetry or {}
            sym_on = self.sym_orbit_augment and "center" in sym
            if sym_on and not np.allclose(sym.get("axis", [0.0, 0.0, 1.0]), [0.0, 0.0, 1.0]):
                raise ValueError(f"the symmetry-orbit augmentation takes a world-z axis only, got {sym['axis']}")
            self.batches.append(DemoBatch(
                scene=pad_pointcloud(demo.scene_pcd, self.n_scene_pad, self.device),
                grasp=pad_pointcloud(demo.grasp_pcd, self.n_grasp_pad, self.device),
                T=torch.as_tensor(demo.target_poses[:1], device=self.device),
                sym_center=torch.as_tensor(np.asarray(sym.get("center", [0.0, 0.0, 0.0]), np.float32),
                                           device=self.device),
                sym_on=bool(sym_on),
            ))

    def init(self, demos: Sequence[DemoSequence], checkpoint: Optional[str] = None,
             total_epochs: Optional[int] = None) -> None:
        """Prepare the demos and the parameters: those of ``checkpoint`` (a
        flat ``.npz``, e.g. a shipped one) or seeded random ones.
        ``total_epochs`` is the learning-rate schedule's horizon (default the
        config's ``max_epochs``), read only when ``lr_min_factor`` is set."""
        self.prepare_batches(demos)
        if checkpoint is not None:
            load_params_npz(self.model, checkpoint)
        else:
            init_params(self.model, torch.Generator().manual_seed(self.seed))
        total_epochs = total_epochs or int(self.train_cfg.get("max_epochs", 0))
        self.optimizer = Amsgrad.from_config(self.params, self.opt_kwargs, total_epochs * len(self.batches))
        # EMA of the parameters (ema_decay unset: it tracks them exactly)
        self.ema = [p.detach().clone() for p in self.params]

    def orbit_target(self, batch: DemoBatch) -> torch.Tensor:
        """The demo's target (1, 7) rotated about its recorded orbit (world z
        through ``sym_center``) by a uniform angle; every representative of
        the orbit is an equally valid target.  A demo without an orbit keeps
        its target and draws nothing."""
        if not batch.sym_on:
            return batch.T
        theta = torch.rand((), generator=self.generator, device=self.device) * (2 * math.pi)
        zero = torch.zeros_like(theta)
        qz = torch.stack([torch.cos(theta / 2), zero, zero, torch.sin(theta / 2)])
        return so3.multiply_se3(_frame_about(qz, batch.sym_center)[None], batch.T)

    def draw_step(self, batch: DemoBatch) -> StepInputs:
        """Every random draw of one step on ``batch``, from the trainer's
        generator (dropout masks aside, which the forward draws)."""
        g = self.generator
        scene, grasp, T_target = augment_batch(batch.scene, batch.grasp, self.orbit_target(batch), self.augment, g)
        kw = dict(ang_mult=self.ang_mult, lin_mult=self.lin_mult, contact_radius=self.contact_radius, generator=g)
        if self.t_augment is not None:
            T_target = biequiv_diffusion(T_target, float(self.t_augment), scene, grasp, n_samples_x_ref=1, **kw)[0][:1]
        Ts, times, tgt_ang, tgt_lin = [], [], [], []
        for t_max, t_min in self.time_schedules:
            t = random_time(float(t_min), float(t_max), generator=g, device=self.device)
            T_d, _, t_in, (ga, gl), _ = biequiv_diffusion(T_target, t, scene, grasp,
                                                          n_samples_x_ref=self.n_samples_x_ref, **kw)
            Ts.append(T_d)
            times.append(t_in)
            tgt_ang.append(ga)
            tgt_lin.append(gl)
        inputs = StepInputs(scene=scene, grasp=grasp, Ts=torch.cat(Ts), times=torch.cat(times),
                            tgt_ang=torch.cat(tgt_ang), tgt_lin=torch.cat(tgt_lin))
        if self.rank_cfg is not None:
            inputs.Ts_rank, inputs.badness = sample_ranked_poses(T_target[0], self.rank_cfg, g)
        return inputs

    def loss(self, inputs: StepInputs) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """The loss of one step and its statistics: one forward extracts the
        scene and query features once, then the score on the diffused poses
        and, for a critic, the energies of the ranked poses (at time 1: the
        critic's energy is time-independent)."""
        m = self.model
        key_ms = [stack_points([p]) for p in m.get_key_pcd_multiscale(inputs.scene)]  # one request
        query = stack_points([m.get_query_pcd(inputs.grasp)])

        ang, lin = m.score(inputs.Ts[None], key_ms, query, inputs.times[None])
        ang, lin = ang[0], lin[0]
        loss, stats = train_loss(ang, lin, inputs.tgt_ang, inputs.tgt_lin, inputs.times, self.ang_mult, self.lin_mult)
        if self.rank_cfg is not None:
            Tr = inputs.Ts_rank
            E = m.energy(Tr[None], key_ms, query, Tr.new_ones(1, len(Tr)))[0]
            rloss, racc = rank_loss(E, inputs.badness, self.rank_cfg)
            loss = loss + self.rank_cfg.weight * rloss
            stats.update({"loss/train": loss, "rank/loss": rloss, "rank/pair_acc": racc, "rank/e_target": E[0],
                          "rank/e_spread": E.max() - E.min()})
        return loss, stats

    def update(self, batch: DemoBatch) -> Dict[str, torch.Tensor]:
        """One training step on ``batch`` (dropout on): the draws, the loss
        and its gradient, the update."""
        inputs = self.draw_step(batch)
        self.model.train()
        loss, stats = self.loss(inputs)
        grads = list(torch.autograd.grad(loss, self.params))
        stats["grad_norm"] = global_norm(grads)
        self.apply_grads(grads)
        return stats

    def apply_grads(self, grads: List[torch.Tensor]) -> None:
        """The update of one step: the optimizer's step on ``grads``, then the
        EMA of the parameters."""
        self.optimizer.step(grads)
        d = float(self.ema_decay) if self.ema_decay else 0.0
        with torch.no_grad():
            torch._foreach_mul_(self.ema, d)
            torch._foreach_add_(self.ema, self.params, alpha=1.0 - d)

