"""The system under test, built from a configuration's file: the port's
agents, service and trainer (``diffusion_edf_tpu_torch``).  This is the
only module of the benchmark that imports the port.

The port reads a model from a config directory, so each model's three
config dicts are written as YAML into a directory under ``TMPDIR`` that the
caller removes; the reference reads the same dicts from the same file.
"""
from __future__ import annotations

import os
from typing import Any, Dict, List, Optional

import yaml

__all__ = ["write_model_dir", "build_agent", "build_service", "build_trainer", "port_demos", "runtime_entries"]


def write_model_dir(cfg: Dict[str, Any], name: str, tmp: str) -> str:
    """The config directory of model ``name`` of ``cfg``, written under ``tmp``."""
    m = cfg["models"][name]
    d = os.path.join(tmp, name)
    os.makedirs(d, exist_ok=True)
    train = dict(m["train_configs"], model_config_file="score_model_configs.yaml")
    for fname, data in (("train_configs.yaml", train), ("task_configs.yaml", m["task_configs"]),
                        ("score_model_configs.yaml", m["score_model_configs"])):
        with open(os.path.join(d, fname), "w") as f:
            yaml.safe_dump(data, f)
    return d


def checkpoint_path(cfg: Dict[str, Any], name: str, root: str) -> Optional[str]:
    ckpt = cfg["models"][name].get("checkpoint")
    return None if ckpt is None else os.path.join(root, ckpt)


def _bundle(cfg, name, tmp, root, device):
    from diffusion_edf_tpu_torch.agent import load_model_bundle

    return load_model_bundle(write_model_dir(cfg, name, tmp), checkpoint_path(cfg, name, root),
                             n_scene_pad=int(cfg["n_scene_pad"]), n_grasp_pad=int(cfg["n_grasp_pad"]),
                             init_seed=int(cfg["models"][name].get("init_seed", 0)), device=device,
                             edge_impl=cfg.get("edge_impl"))


def build_agent(cfg: Dict[str, Any], tmp: str, root: str, device: str):
    """The configuration's cascade with its critic."""
    from diffusion_edf_tpu_torch.agent import DiffusionEdfAgent

    models = [_bundle(cfg, n, tmp, root, device) for n in cfg["cascade"]]
    critic = _bundle(cfg, cfg["critic"], tmp, root, device) if cfg.get("critic") else None
    prep = cfg["preprocess"]
    return DiffusionEdfAgent(models, prep["preprocess_config"], prep["unprocess_config"], critic=critic)


def build_service(cfg: Dict[str, Any], agent, batching: Optional[Dict[str, Any]]):
    """The service of the configuration's task with ``agent``, the
    configuration's schedule and ``batching``."""
    from diffusion_edf_tpu_torch.serve.server import AgentService

    task = cfg["task"]
    agents = {"pick": None, "place": None}
    agents[task] = agent
    return AgentService(agents["pick"], agents["place"], {f"{task}_diffusion_configs": cfg["diffusion_configs"]},
                        batching=batching)


def runtime_entries(agent) -> int:
    """Entries (shapes) held by every sampling runtime of ``agent``."""
    runtimes = list(agent._runtimes) + ([agent._critic_runtime] if agent._critic_runtime is not None else [])
    return sum(sum(rt.cache_sizes().values()) for rt in runtimes)


def port_demos(demos) -> List[Any]:
    """The generator's demos as the port's types."""
    from diffusion_edf_tpu_torch.train.data import DemoSequence, PointCloud, TargetPoseDemo

    def pcd(p):
        return PointCloud(points=p.points, colors=p.colors)

    return [DemoSequence(steps=[TargetPoseDemo(scene_pcd=pcd(d.scene_pcd), grasp_pcd=pcd(d.grasp_pcd),
                                               target_poses=d.target_poses, name=d.name, symmetry=d.symmetry)
                                for d in seq.steps]) for seq in demos]


def build_trainer(cfg: Dict[str, Any], tmp: str, root: str, device: str, seed: int, demos):
    """The trainer of the configuration's ``train_model``, initialised from
    its checkpoint on ``demos``; its log under ``tmp``."""
    from diffusion_edf_tpu_torch.train.trainer import DiffusionEdfTrainer

    name = cfg["train_model"]
    tr = DiffusionEdfTrainer(write_model_dir(cfg, name, tmp), log_dir=os.path.join(tmp, "log"),
                             n_scene_pad=int(cfg["n_scene_pad"]), n_grasp_pad=int(cfg["n_grasp_pad"]),
                             device=device, seed=seed)
    tr.init(port_demos(demos), checkpoint=checkpoint_path(cfg, name, root))
    return tr
