"""Agent-server CLI (counterpart of the JAX package's ``serve/cli.py``, same
options and ``--device``):

    python -m diffusion_edf_tpu_torch.serve.cli [--family-dir DIR] [--port 8329] [--batch 4]

Builds the pick and place agent cascades of a config family (``agent.yaml``,
``server.yaml``, ``preprocess.yaml``), warms them up with the served
diffusion configs (kernel build, operand caches, and on CUDA the graphs of
every entry a request of those shapes needs) and serves them over HTTP.  A model whose checkpoint file is
missing gets seeded initial weights, as in the JAX CLI.
"""
from __future__ import annotations

import argparse
import os
from typing import Any, Dict, Optional

import numpy as np
import yaml

from ..agent import DiffusionEdfAgent, load_model_bundle
from ..train.data import PointCloud
from .server import AgentService, run_server

__all__ = ["build_service", "warmup_service", "main"]


def build_service(family_dir: str, with_critic: bool = True, n_scene_pad: int = 2048, n_grasp_pad: int = 512,
                  batching: Optional[Dict[str, Any]] = None, device: str = "cuda") -> AgentService:
    with open(os.path.join(family_dir, "agent.yaml")) as f:
        agent_cfg = yaml.safe_load(f)
    with open(os.path.join(family_dir, "server.yaml")) as f:
        server_cfg = yaml.safe_load(f)
    with open(os.path.join(family_dir, "preprocess.yaml")) as f:
        prep_cfg = yaml.safe_load(f)

    def bundle(item):
        ckpt = item.get("checkpoint_dir")
        return load_model_bundle(
            item["configs_root_dir"], ckpt if ckpt and os.path.exists(ckpt) else None,
            train_configs_file=item.get("train_configs_file", "train_configs.yaml"),
            task_configs_file=item.get("task_configs_file", "task_configs.yaml"),
            n_scene_pad=n_scene_pad, n_grasp_pad=n_grasp_pad, device=device,
        )

    def build_agent(models_key: str, critic_key: str):
        mk = agent_cfg.get("model_kwargs", {})
        if models_key not in mk:
            return None
        critic = bundle(mk[critic_key]) if with_critic and mk.get(critic_key) else None
        return DiffusionEdfAgent([bundle(item) for item in mk[models_key]], prep_cfg["preprocess_config"],
                                 prep_cfg["unprocess_config"], critic=critic)

    pick_agent = build_agent("pick_models_kwargs", "pick_critic_kwargs")
    place_agent = build_agent("place_models_kwargs", "place_critic_kwargs")
    # server.yaml may declare batching; an explicit arg wins
    batching = batching if batching is not None else server_cfg.get("batching")
    return AgentService(pick_agent, place_agent, server_cfg, batching=batching)


def warmup_service(service: AgentService, n_points: int = 256, seed: int = 0, n_seeds: int = 1) -> None:
    """One request per agent on a random cloud, with the agent's served
    diffusion configs (``<task>_diffusion_configs``), ``n_seeds`` seeds and
    the trajectory recorded, as ``/denoise`` samples: builds the kernels,
    fills the operand caches and prepares the runtime entries of those
    shapes before the first request is served."""
    rng = np.random.default_rng(seed)
    cloud = PointCloud(rng.uniform(-0.1, 0.1, (n_points, 3)), rng.uniform(0, 1, (n_points, 3)))
    configs = service.get_configs()
    for task, agent in service.agents.items():
        if agent is not None:
            agent.warmup(cloud, cloud, n_seeds=n_seeds, diffusion_configs=configs[f"{task}_diffusion_configs"],
                         record_trajectory=True)


def main(argv=None):
    p = argparse.ArgumentParser(description="Serve diffusion-EDF agents over HTTP")
    p.add_argument("--family-dir", default="diffusion_edf_tpu_torch/configs/panda_mug",
                   help="config family dir containing agent.yaml/server.yaml/preprocess.yaml")
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--port", type=int, default=8329)
    p.add_argument("--no-critic", action="store_true")
    p.add_argument("--n-scene-pad", type=int, default=2048)
    p.add_argument("--n-grasp-pad", type=int, default=512)
    p.add_argument("--batch", type=int, default=0,
                   help="aggregate up to N concurrent /denoise requests into one device dispatch")
    p.add_argument("--batch-window-ms", type=float, default=20.0)
    p.add_argument("--device", default="cuda", help="torch device of the models (cpu runs the plain versions)")
    args = p.parse_args(argv)

    service = build_service(
        args.family_dir, with_critic=not args.no_critic,
        n_scene_pad=args.n_scene_pad, n_grasp_pad=args.n_grasp_pad,
        batching=(dict(max_batch=args.batch, window_ms=args.batch_window_ms) if args.batch > 1 else None),
        device=args.device,
    )
    warmup_service(service)
    print(f"serving on {args.host}:{args.port}")
    run_server(service, host=args.host, port=args.port, block=True)


if __name__ == "__main__":
    main()
