"""Training: config loading, the train step, epochs, EMA, checkpoints and
export (counterpart of the JAX package's ``train/trainer.py``).

One step on one demo: the symmetry-orbit target augmentation (a demo that
records a world-z orbit trains against a random representative), the
per-step demo augmentation (``train/augment.py``), then per time schedule a
random time, contact reference points and the SE(3) diffusion of the target
with its analytic score targets (``diffusion/diffuse.py``); the model's
score on the diffused poses against those targets (``train_loss``), and for
an EBM critic, whose score is the gradient of its energy, also the ranking
loss of its energies on perturbed targets (``train/ranking.py``); then the
gradient, the optimizer (``train/optim.py``) and the EMA of the parameters.

Every random number of a run comes from one seeded ``torch.Generator`` on
the trainer's device (times, reference points, IGSO(3), augmentation, the
orbit angle, rank negatives, dropout masks), and its state is part of the
checkpoint, so a resumed run continues as an uninterrupted one would.  The
model is in ``train()`` mode during steps, so dropout is on and every
attention runs its plain PyTorch path (the CUDA kernels have no backward;
``nn/attention.py``).  Float32 products stay float32 on the card: the
trainer refuses to run with TF32 matmuls enabled.

Checkpoints are one ``.npz``: ``params/...`` and ``ema_params/...`` in the
flat flax keys of ``weights.py``, ``opt_state/{mu,nu,nu_max}/...`` and
``opt_state/count``, ``__rng__`` (the generator's state) and ``__meta__``
(JSON: epoch, steps).  :meth:`DiffusionEdfTrainer.export` writes the
parameters alone in the layout of the shipped ``checkpoints/**/*.npz``."""
from __future__ import annotations

import dataclasses
import json
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
from ..weights import flat_arrays, init_params, load_params_npz, unflatten_arrays
from .augment import AugmentConfig, _frame_about, augment_batch
from .data import DemoSequence, compose_proc_fn, pad_pointcloud
from .factory import build_score_model
from .logging import JsonlLogger
from .optim import Amsgrad, global_norm
from .ranking import RankConfig, rank_loss, sample_ranked_poses

__all__ = ["load_configs", "DemoBatch", "StepInputs", "DiffusionEdfTrainer"]


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

    def to(self, device, dtype: Optional[torch.dtype] = None) -> "StepInputs":
        """A copy on ``device``, its floating tensors in ``dtype`` if given
        (to run the same step on another device or in another precision)."""
        def move(a):
            if a is None:
                return None
            return a.to(device, dtype) if dtype is not None and a.is_floating_point() else a.to(device)

        def field(v):
            if isinstance(v, FeaturedPoints):
                return FeaturedPoints(*(move(a) for a in (v.x, v.f, v.mask, v.w)))
            return move(v)
        return StepInputs(**{f.name: field(getattr(self, f.name)) for f in dataclasses.fields(self)})


class DiffusionEdfTrainer:
    """Trainer of one task variant::

        tr = DiffusionEdfTrainer("diffusion_edf_tpu_torch/configs/panda_mug/pick_lowres")
        tr.init(demos, checkpoint="checkpoints/panda_mug/pick_lowres.npz")
        for epoch in range(n):
            tr.train_epoch()
        tr.save(); tr.export("pick_lowres.npz")

    ``device`` is ``"cuda"`` unless the caller asks for ``"cpu"``; there is
    no fallback when CUDA is missing."""

    def __init__(
        self,
        configs_root_dir: str,
        train_configs_file: str = "train_configs.yaml",
        task_configs_file: str = "task_configs.yaml",
        log_dir: Optional[str] = None,
        n_scene_pad: int = 2048,
        n_grasp_pad: int = 512,
        device: Union[str, torch.device] = "cuda",
        seed: int = 0,
    ):
        self.device = torch.device(device)
        if self.device.type == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError("DiffusionEdfTrainer: no CUDA device (pass device='cpu' to train on the CPU)")
            if torch.backends.cuda.matmul.allow_tf32:
                raise RuntimeError("DiffusionEdfTrainer: TF32 matmuls are enabled "
                                   "(torch.backends.cuda.matmul.allow_tf32); training runs in float32")
        self.configs_root_dir = configs_root_dir
        self.train_cfg, self.task_cfg, self.model_cfg = load_configs(
            configs_root_dir, train_configs_file, task_configs_file)
        self.task_type: str = self.task_cfg["task_type"]
        self.contact_radius = float(self.task_cfg["contact_radius"]) * float(self.train_cfg.get("rescale_factor", 1.0))
        self.n_samples_x_ref = int(self.train_cfg.get("n_samples_x_ref", 10))
        diff = self.train_cfg.get("diffusion_configs", {})
        self.time_schedules: List[Tuple[float, float]] = [tuple(s) for s in diff.get("time_schedules", [[1.0, 0.01]])]
        self.t_augment = diff.get("t_augment", None)
        aug_cfg = dict(self.train_cfg.get("augment_configs", {}) or {})
        # a demo with a recorded symmetry orbit trains against a random representative of it
        self.sym_orbit_augment = bool(aug_cfg.pop("sym_orbit", True))
        self.augment = AugmentConfig.from_dict(aug_cfg)
        self.n_scene_pad, self.n_grasp_pad = n_scene_pad, n_grasp_pad
        self.seed = seed

        self.model = build_score_model(self.model_cfg["model_name"], self.model_cfg["model_kwargs"]).to(self.device)
        self.params = list(self.model.parameters())
        head = self.model_cfg["model_kwargs"]["score_head_kwargs"]
        self.is_ebm = bool(head.get("ebm", False))
        # EBM critics also learn to rank their energies (off with critic_rank_configs: {weight: 0})
        self.rank_cfg: Optional[RankConfig] = (
            RankConfig.from_dict(self.train_cfg.get("critic_rank_configs", {})) if self.is_ebm else None)
        if self.rank_cfg is not None and self.rank_cfg.weight <= 0.0:
            self.rank_cfg = None
        self.ang_mult, self.lin_mult = float(head["ang_mult"]), float(head["lin_mult"])
        self.proc_fn = compose_proc_fn(self.train_cfg.get("preprocess_config", []), seed=seed)
        self.opt_kwargs = dict(self.train_cfg.get("optimizer_kwargs", {}) or {})
        self.ema_decay = self.opt_kwargs.pop("ema_decay", None)
        self.optimizer: Optional[Amsgrad] = None  # built in init(): the LR schedule needs the horizon
        self.ema: List[torch.Tensor] = []

        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        self.model.set_dropout_generator(self.generator)
        self.log_dir = log_dir or os.path.join(self.train_cfg.get("log_root_dir", "runs"),
                                               os.path.basename(configs_root_dir))
        self.logger = JsonlLogger(self.log_dir)
        self.steps = 0
        self.epoch = 0
        self.batches: List[DemoBatch] = []

    # ------------------------------------------------------------------ #
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

    def n_params(self) -> int:
        return sum(p.numel() for p in self.params)

    # ------------------------------------------------------------------ #
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
            E = m.energy(inputs.Ts_rank[None], key_ms, query, inputs.Ts_rank.new_ones(1, inputs.Ts_rank.shape[0]))[0]
            rloss, racc = rank_loss(E, inputs.badness, self.rank_cfg)
            loss = loss + self.rank_cfg.weight * rloss
            stats.update({"loss/train": loss, "rank/loss": rloss, "rank/pair_acc": racc, "rank/e_target": E[0],
                          "rank/e_spread": E.max() - E.min()})
        return loss, stats

    def loss_and_grads(self, inputs: StepInputs) -> Tuple[torch.Tensor, Dict[str, torch.Tensor], List[torch.Tensor]]:
        loss, stats = self.loss(inputs)
        grads = torch.autograd.grad(loss, self.params)
        return loss, stats, list(grads)

    def step(self, batch: DemoBatch) -> Dict[str, float]:
        """One training step on ``batch`` (dropout on); its statistics."""
        assert self.optimizer is not None, "call init() first"
        inputs = self.draw_step(batch)
        self.model.train()
        _, stats, grads = self.loss_and_grads(inputs)
        stats["grad_norm"] = global_norm(grads)
        self.optimizer.step(grads)
        d = float(self.ema_decay) if self.ema_decay else 0.0
        with torch.no_grad():
            torch._foreach_mul_(self.ema, d)
            torch._foreach_add_(self.ema, self.params, alpha=1.0 - d)
        keys = list(stats)
        return dict(zip(keys, torch.stack([stats[k].detach().float() for k in keys]).tolist()))

    def evaluate(self, inputs: StepInputs) -> Dict[str, float]:
        """The loss statistics on ``inputs`` with dropout off, no gradient
        and no update."""
        was = self.model.training
        self.model.eval()
        try:
            with torch.no_grad():
                _, stats = self.loss(inputs)
        finally:
            self.model.train(was)
        keys = list(stats)
        return dict(zip(keys, torch.stack([stats[k].float() for k in keys]).tolist()))

    def train_epoch(self, shuffle: bool = True) -> Dict[str, float]:
        """One step on every demo, in an order shuffled by
        ``np.random.default_rng(epoch)``; every step's statistics go to the
        log.  Returns the last step's."""
        assert self.optimizer is not None, "call init() first"
        order = np.arange(len(self.batches))
        if shuffle:
            np.random.default_rng(self.epoch).shuffle(order)
        last: Dict[str, float] = {}
        for i in order:
            last = self.step(self.batches[i])
            self.steps += 1
            self.logger.log(step=self.steps, **last)
        self.epoch += 1
        return last

    # ------------------------------------------------------------------ #
    def record_pcd(self, demo_index: int = 0) -> None:
        """Save the demo's clouds, its target and poses diffused at t = 0.5
        for the log viewer (``custom_data/step_N``); the draws come from a
        generator seeded with the step count, not the training stream."""
        b = self.batches[demo_index]
        g = torch.Generator(device=self.device).manual_seed(self.steps)
        T_d = biequiv_diffusion(b.T, 0.5, b.scene, b.grasp, ang_mult=self.ang_mult, lin_mult=self.lin_mult,
                                n_samples_x_ref=self.n_samples_x_ref, contact_radius=self.contact_radius,
                                generator=g)[0]
        arrays = dict(scene_x=b.scene.x, scene_f=b.scene.f, scene_mask=b.scene.mask, grasp_x=b.grasp.x,
                      grasp_f=b.grasp.f, grasp_mask=b.grasp.mask, target_pose=b.T, diffused_poses=T_d)
        self.logger.log_3d(self.steps, "train_snapshot", {k: v.cpu().numpy() for k, v in arrays.items()})

    def _state(self) -> Dict[str, np.ndarray]:
        out = dict(flat_arrays(self.model))
        out.update({"ema_" + k: v for k, v in flat_arrays(self.model, self.ema).items()})
        for name, tensors in self.optimizer.state_arrays().items():
            out.update({f"opt_state/{name}/" + k[len("params/"):]: v
                        for k, v in flat_arrays(self.model, tensors).items()})
        out["opt_state/count"] = np.asarray(self.optimizer.count, np.int64)
        out["__rng__"] = self.generator.get_state().numpy()
        out["__meta__"] = _json_bytes(dict(epoch=self.epoch, steps=self.steps))
        return out

    def save(self, path: Optional[str] = None) -> str:
        """Write the whole train state to ``path`` (default
        ``<log_dir>/checkpoint/<epoch>.npz``); returns the path."""
        assert self.optimizer is not None, "call init() first"
        path = os.path.abspath(path or os.path.join(self.log_dir, "checkpoint", f"{self.epoch}.npz"))
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "wb") as f:
            np.savez(f, **self._state())
        return path

    def restore(self, path: str) -> None:
        """Load the train state that :meth:`save` wrote (after :meth:`init`)."""
        if self.optimizer is None:
            raise RuntimeError("call init() before restore()")
        with np.load(path) as z:
            flat = {k: z[k] for k in z.files}

        def arrays(prefix):
            sub = {"params/" + k[len(prefix):]: v for k, v in flat.items() if k.startswith(prefix)}
            return unflatten_arrays(self.model, sub)

        with torch.no_grad():
            for dst, src in ((self.params, arrays("params/")), (self.ema, arrays("ema_params/"))):
                for t, a in zip(dst, src):
                    t.copy_(torch.as_tensor(a))
            for name, tensors in self.optimizer.state_arrays().items():
                for t, a in zip(tensors, arrays(f"opt_state/{name}/")):
                    t.copy_(torch.as_tensor(a))
        self.optimizer.count = int(flat["opt_state/count"])
        self.generator.set_state(torch.as_tensor(flat["__rng__"]))
        meta = json.loads(bytes(flat["__meta__"]).decode())
        self.epoch, self.steps = int(meta["epoch"]), int(meta["steps"])

    def export(self, path: str) -> str:
        """Write the parameters alone as a flat ``.npz`` in the layout of the
        shipped checkpoints (``params/...`` and ``__meta__``), which both
        packages' loaders read with exact keys; returns the path."""
        path = os.path.abspath(path)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        meta = dict(epoch=self.epoch, steps=self.steps, configs=os.path.basename(self.configs_root_dir))
        with open(path, "wb") as f:
            np.savez_compressed(f, **flat_arrays(self.model), __meta__=_json_bytes(meta))
        return path


def _json_bytes(obj) -> np.ndarray:
    return np.frombuffer(json.dumps(obj).encode(), dtype=np.uint8)
