"""Inference agent: one or more cascade stages of annealed Langevin sampling,
then an optional EBM critic that ranks the final poses by energy (counterpart
of the JAX package's ``agent.py``; request batching is not ported yet).  Per
stage the scene and grasp features are extracted once, then the rollout runs
on the model's device; the final pose of one stage seeds the next."""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from .diffusion.langevin import build_schedule, langevin_sample
from .train.data import PointCloud, TargetPoseDemo, compose_proc_fn, pad_pointcloud
from .train.factory import build_score_model
from .train.trainer import load_configs
from .weights import init_params, load_params_npz

__all__ = ["ModelBundle", "DiffusionEdfAgent", "load_model_bundle", "load_params_npz"]


@dataclasses.dataclass
class ModelBundle:
    model: Any
    ang_mult: float
    lin_mult: float
    n_scene_pad: int = 2048
    n_grasp_pad: int = 512

    @property
    def device(self) -> torch.device:
        return next(self.model.parameters()).device


def load_model_bundle(
    configs_root_dir: str,
    checkpoint: Optional[str] = None,
    train_configs_file: str = "train_configs.yaml",
    task_configs_file: str = "task_configs.yaml",
    n_scene_pad: int = 2048,
    n_grasp_pad: int = 512,
    init_seed: int = 0,
    device: Union[str, torch.device] = "cuda",
    edge_impl: Optional[str] = None,
) -> ModelBundle:
    """Build a model from its config directory, with seeded random weights
    or the flat ``.npz`` ``checkpoint``, on ``device``.  ``edge_impl``
    selects the attention edge segment (see ``nn/attention.py``)."""
    _, _, model_cfg = load_configs(configs_root_dir, train_configs_file, task_configs_file)
    model = build_score_model(model_cfg["model_name"], model_cfg["model_kwargs"], edge_impl=edge_impl)
    init_params(model, torch.Generator().manual_seed(init_seed))
    if checkpoint is not None:
        load_params_npz(model, checkpoint)
    model.to(device).eval()
    sh = model_cfg["model_kwargs"]["score_head_kwargs"]
    return ModelBundle(
        model=model, ang_mult=float(sh["ang_mult"]), lin_mult=float(sh["lin_mult"]),
        n_scene_pad=n_scene_pad, n_grasp_pad=n_grasp_pad,
    )


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class DiffusionEdfAgent:
    def __init__(
        self,
        models: Sequence[ModelBundle],
        preprocess_config: Sequence[Dict],
        unprocess_config: Sequence[Dict],
        preprocess_seed: Optional[int] = None,
        critic: Optional[ModelBundle] = None,
    ):
        """``preprocess_seed`` seeds the jitter ops of the preprocessing;
        ``critic`` is an EBM model whose energy orders the sampled poses."""
        self.models = list(models)
        self.critic = critic
        self.proc_fn = compose_proc_fn(preprocess_config, seed=preprocess_seed)
        self.unrescale = 1.0  # the unprocess pipeline is a rescale (cm -> m) of poses
        for op in unprocess_config:
            if op["name"] == "rescale":
                self.unrescale *= float(op["kwargs"]["rescale_factor"])

    def _prep(self, scene_pcd: PointCloud, grasp_pcd: PointCloud):
        demo = self.proc_fn(TargetPoseDemo(scene_pcd=scene_pcd, grasp_pcd=grasp_pcd, target_poses=np.zeros((1, 7))))
        return demo.scene_pcd, demo.grasp_pcd

    @torch.no_grad()
    def sample(
        self,
        scene_pcd: PointCloud,
        grasp_pcd: PointCloud,
        Ts_init: np.ndarray,  # (nT, 7) in raw (metre) units
        N_steps_list: Sequence[Sequence[int]],
        timesteps_list: Sequence[Sequence[float]],
        temperatures_list: Sequence[Union[float, Sequence[float]]],
        diffusion_schedules_list: Sequence[Sequence[Sequence[float]]],
        log_t_schedule: bool = True,
        time_exponent_temp: float = 1.0,
        time_exponent_alpha: float = 0.5,
        generator: Optional[torch.Generator] = None,
        record_trajectory: bool = True,
    ) -> Tuple[np.ndarray, PointCloud, PointCloud, Dict[str, Any]]:
        """Cascaded annealed Langevin sampling.  ``generator`` draws the
        Langevin noise and must live on the models' device.  Returns
        (trajectory (steps + stages, nT, 7) in processed (cm) units, processed
        scene, processed grasp, info with per-stage host timings).  With a
        critic the trajectory's pose axis is sorted by the energy of the final
        poses, ascending, and ``info["energy"]`` holds the sorted energies."""
        scene_p, grasp_p = self._prep(scene_pcd, grasp_pcd)
        pose_scale = 1.0 / self.unrescale if self.unrescale != 1.0 else 1.0
        T0 = np.asarray(Ts_init, dtype=np.float32)
        T0 = np.concatenate([T0[:, :4], T0[:, 4:] * np.float32(pose_scale)], axis=-1)
        info: Dict[str, Any] = {"extract_s": [], "rollout_s": [], "steps": []}
        trajs = []
        T = None
        for mi, bundle in enumerate(self.models):
            model, dev = bundle.model, bundle.device
            T = torch.as_tensor(T0, device=dev) if T is None else T.to(dev)
            t0 = time.perf_counter()
            key_ms = model.get_key_pcd_multiscale(pad_pointcloud(scene_p, bundle.n_scene_pad, dev))
            query = model.get_query_pcd(pad_pointcloud(grasp_p, bundle.n_grasp_pad, dev))
            _sync(dev)
            t1 = time.perf_counter()
            sched = build_schedule(
                diffusion_schedules=diffusion_schedules_list[mi], N_steps=N_steps_list[mi],
                timesteps=timesteps_list[mi], ang_mult=bundle.ang_mult, lin_mult=bundle.lin_mult,
                temperatures=temperatures_list[mi], log_t_schedule=log_t_schedule,
                time_exponent_temp=time_exponent_temp, time_exponent_alpha=time_exponent_alpha,
            )
            T, traj = langevin_sample(
                lambda Ts, t: model.score(Ts, key_ms, query, t), T, sched,
                bundle.ang_mult, bundle.lin_mult, generator=generator, record_trajectory=record_trajectory,
            )
            _sync(dev)
            info["extract_s"].append(t1 - t0)
            info["rollout_s"].append(time.perf_counter() - t1)
            info["steps"].append(len(sched.t))
            trajs.append((traj if record_trajectory else T[None]).cpu().numpy())
        Ts_out = np.concatenate(trajs, axis=0)
        if self.critic is not None:
            c = self.critic
            model, dev = c.model, c.device
            t0 = time.perf_counter()
            key_ms = model.get_key_pcd_multiscale(pad_pointcloud(scene_p, c.n_scene_pad, dev))
            query = model.get_query_pcd(pad_pointcloud(grasp_p, c.n_grasp_pad, dev))
            Tl = torch.as_tensor(Ts_out[-1], device=dev)
            energy = model.energy(Tl, key_ms, query, torch.ones(Tl.shape[0], device=dev)).cpu().numpy()
            info["critic_s"] = time.perf_counter() - t0
            order = np.argsort(energy)
            Ts_out = Ts_out[:, order]
            info["energy"] = energy[order]
        return Ts_out, scene_p, grasp_p, info

    def unprocess_poses(self, Ts: np.ndarray) -> np.ndarray:
        """cm -> metres on the translation part."""
        Ts = np.asarray(Ts)
        return np.concatenate([Ts[..., :4], Ts[..., 4:] * self.unrescale], axis=-1)
