"""Inference agent: one or more cascade stages of annealed Langevin sampling,
then an optional EBM critic that ranks the final poses by energy (counterpart
of the JAX package's ``agent.py``).  Per stage the scene and grasp features
are extracted once, then the rollout runs on the model's device; the final
pose of one stage seeds the next.

``sample_batch`` serves R requests that share a diffusion config with one
score evaluation per Langevin step for all of them: the request axis is
folded into the rows of the key tensor field (each query point still attends
only to its own request's key points), so the edge kernels see R times the
rows of one request.  ``sample`` is ``sample_batch`` of one request.

Given a mesh, each Langevin rollout is seed-sharded over its ``data`` axis
(``parallel/sharded.py::sharded_langevin_sample``): every rank extracts the
features, rolls out its block of every request's seeds and gathers the
final poses; the critic and the next stage see all of them.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from .data import stack_points
from .diffusion.langevin import build_schedule, langevin_sample
from .nn import cuda_build
from .parallel.mesh import Mesh
from .parallel.sharded import sharded_langevin_sample
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
        mesh: Optional[Mesh] = None,
    ):
        """``preprocess_seed`` seeds the jitter ops of the preprocessing;
        ``critic`` is an EBM model whose energy orders the sampled poses;
        ``mesh`` shards the seeds of every rollout over its ``data`` axis
        (every rank of the mesh calls :meth:`sample` with the same
        arguments and a generator in the same state, and gets the same
        result: one process's on the seeds padded to a multiple of the axis
        size)."""
        self.models = list(models)
        self.mesh = mesh
        self.critic = critic
        self.proc_fn = compose_proc_fn(preprocess_config, seed=preprocess_seed)
        self.unrescale = 1.0  # the unprocess pipeline is a rescale (cm -> m) of poses
        for op in unprocess_config:
            if op["name"] == "rescale":
                self.unrescale *= float(op["kwargs"]["rescale_factor"])

    def _prep(self, scene_pcd: PointCloud, grasp_pcd: PointCloud):
        demo = self.proc_fn(TargetPoseDemo(scene_pcd=scene_pcd, grasp_pcd=grasp_pcd, target_poses=np.zeros((1, 7))))
        return demo.scene_pcd, demo.grasp_pcd

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
        """Cascaded annealed Langevin sampling of one request.  ``generator``
        draws the Langevin noise and must live on the models' device; without
        one, a generator is seeded from ``np.random``.  Returns (trajectory
        (steps + stages, nT, 7) in processed (cm) units, processed scene,
        processed grasp, info with per-stage host timings).  With a critic the
        trajectory's pose axis is sorted by the energy of the final poses,
        ascending, and ``info["energy"]`` holds the sorted energies."""
        scene_p, grasp_p = self._prep(scene_pcd, grasp_pcd)
        traj, info = self._run([(scene_p, grasp_p)], np.asarray(Ts_init, dtype=np.float32)[None], dict(
            N_steps_list=N_steps_list, timesteps_list=timesteps_list, temperatures_list=temperatures_list,
            diffusion_schedules_list=diffusion_schedules_list, log_t_schedule=log_t_schedule,
            time_exponent_temp=time_exponent_temp, time_exponent_alpha=time_exponent_alpha,
        ), generator, record_trajectory)
        if "energy" in info:
            info["energy"] = info["energy"][0]
        return traj[0], scene_p, grasp_p, info

    def sample_batch(
        self,
        scene_pcds: Sequence[PointCloud],
        grasp_pcds: Sequence[PointCloud],
        Ts_init: np.ndarray,  # (R, nT, 7) in raw (metre) units
        N_steps_list: Sequence[Sequence[int]],
        timesteps_list: Sequence[Sequence[float]],
        temperatures_list: Sequence[Union[float, Sequence[float]]],
        diffusion_schedules_list: Sequence[Sequence[Sequence[float]]],
        log_t_schedule: bool = True,
        time_exponent_temp: float = 1.0,
        time_exponent_alpha: float = 0.5,
        generator: Optional[torch.Generator] = None,
        record_trajectory: bool = True,
        n_seeds: Optional[Sequence[int]] = None,
    ) -> Tuple[np.ndarray, Dict[str, Any]]:
        """R independent (scene, grasp, seeds) requests that share the
        diffusion config, sampled together: extraction runs per request, every
        Langevin step and the critic once for all.  Returns (trajectory (R,
        steps + stages, nT, 7) in processed (cm) units, info; with a critic
        every request's pose axis is sorted by its energies, ascending, and
        ``info["energy"]`` is (R, nT)).  ``n_seeds`` gives each request's
        count of real seeds when the caller padded the seed axis to a common
        nT: the critic gives the padding seeds of request i (those past
        ``n_seeds[i]``) energy +inf, so they sort after every real seed.

        Noise: every step draws one (R, nT, 3) block for the angular part,
        then one for the linear part, from ``generator``, request after
        request; so R = 1 with a generator of a given seed gives what
        ``sample`` gives with that seed."""
        assert len(scene_pcds) == len(grasp_pcds) == np.asarray(Ts_init).shape[0]
        preps = [self._prep(s, g) for s, g in zip(scene_pcds, grasp_pcds)]
        return self._run(preps, np.asarray(Ts_init, dtype=np.float32), dict(
            N_steps_list=N_steps_list, timesteps_list=timesteps_list, temperatures_list=temperatures_list,
            diffusion_schedules_list=diffusion_schedules_list, log_t_schedule=log_t_schedule,
            time_exponent_temp=time_exponent_temp, time_exponent_alpha=time_exponent_alpha,
        ), generator, record_trajectory, n_seeds)

    @staticmethod
    def _extract(bundle: ModelBundle, preps):
        """Every request's key scales and query, stacked over requests."""
        model, dev = bundle.model, bundle.device
        keys = [model.get_key_pcd_multiscale(pad_pointcloud(s, bundle.n_scene_pad, dev)) for s, _ in preps]
        query = stack_points([model.get_query_pcd(pad_pointcloud(g, bundle.n_grasp_pad, dev)) for _, g in preps])
        return [stack_points(scale) for scale in zip(*keys)], query

    @torch.no_grad()
    def _run(self, preps, Ts_init: np.ndarray, cfg: Dict[str, Any], generator, record_trajectory: bool,
             n_seeds: Optional[Sequence[int]] = None):
        R, nT = Ts_init.shape[:2]
        pose_scale = 1.0 / self.unrescale if self.unrescale != 1.0 else 1.0
        T0 = np.concatenate([Ts_init[..., :4], Ts_init[..., 4:] * np.float32(pose_scale)], axis=-1)
        info: Dict[str, Any] = {"extract_s": [], "rollout_s": [], "steps": []}
        trajs = []
        T = None
        for mi, bundle in enumerate(self.models):
            model, dev = bundle.model, bundle.device
            T = torch.as_tensor(T0, device=dev) if T is None else T.to(dev)
            if generator is None:
                generator = torch.Generator(device=dev).manual_seed(int(np.random.randint(0, 2**31 - 1)))
            t0 = time.perf_counter()
            key_ms, query = self._extract(bundle, preps)
            _sync(dev)
            t1 = time.perf_counter()
            sched = build_schedule(
                diffusion_schedules=cfg["diffusion_schedules_list"][mi], N_steps=cfg["N_steps_list"][mi],
                timesteps=cfg["timesteps_list"][mi], ang_mult=bundle.ang_mult, lin_mult=bundle.lin_mult,
                temperatures=cfg["temperatures_list"][mi], log_t_schedule=cfg["log_t_schedule"],
                time_exponent_temp=cfg["time_exponent_temp"], time_exponent_alpha=cfg["time_exponent_alpha"],
            )

            def score_fn(Ts, t, model=model, key_ms=key_ms, query=query):
                return model.score(Ts, key_ms, query, t)

            if self.mesh is None:
                T, traj = langevin_sample(score_fn, T, sched, bundle.ang_mult, bundle.lin_mult,
                                          generator=generator, record_trajectory=record_trajectory)
            else:
                T, traj = sharded_langevin_sample(self.mesh, score_fn, generator, T, sched, bundle.ang_mult,
                                                  bundle.lin_mult, record_trajectory=record_trajectory)
            _sync(dev)
            info["extract_s"].append(t1 - t0)
            info["rollout_s"].append(time.perf_counter() - t1)
            info["steps"].append(len(sched.t))
            traj = traj if record_trajectory else T[None]
            trajs.append(traj.transpose(0, 1).cpu().numpy())
        Ts_out = np.concatenate(trajs, axis=1)  # (R, steps + stages, nT, 7)
        if self.critic is not None:
            c = self.critic
            dev = c.device
            t0 = time.perf_counter()
            key_ms, query = self._extract(c, preps)
            Tl = torch.as_tensor(np.ascontiguousarray(Ts_out[:, -1]), device=dev)
            energy = c.model.energy(Tl, key_ms, query, torch.ones(R, nT, device=dev)).cpu().numpy()
            info["critic_s"] = time.perf_counter() - t0
            if n_seeds is not None:
                energy[np.arange(nT)[None, :] >= np.asarray(n_seeds)[:, None]] = np.inf
            order = np.argsort(energy, axis=-1)
            Ts_out = np.take_along_axis(Ts_out, order[:, None, :, None], axis=2)
            info["energy"] = np.take_along_axis(energy, order, axis=-1)
        return Ts_out, info

    def warmup(self, scene_pcd: PointCloud, grasp_pcd: PointCloud) -> None:
        """Build the CUDA kernels (``nvcc`` at first use, ``nn/cuda_build.py``)
        and fill the operand caches of every attention (the folded weights and
        the tensor-core operands, built once per set of weights) with a
        one-step request of one seed, so that the first request served pays
        for neither.  Nothing else is warmed: PyTorch compiles nothing per
        shape, so the request's seeds and steps do not matter."""
        if any(b.device.type == "cuda" for b in self.models):
            cuda_build.build_all()
        n = len(self.models)
        self.sample(scene_pcd, grasp_pcd, np.array([[1.0, 0, 0, 0, 0, 0, 0]]), N_steps_list=[[1]] * n,
                    timesteps_list=[[0.01]] * n, temperatures_list=[[1.0]] * n,
                    diffusion_schedules_list=[[[1.0, 0.9]]] * n, record_trajectory=False)

    def unprocess_poses(self, Ts: np.ndarray) -> np.ndarray:
        """cm -> metres on the translation part."""
        Ts = np.asarray(Ts)
        return np.concatenate([Ts[..., :4], Ts[..., 4:] * self.unrescale], axis=-1)
