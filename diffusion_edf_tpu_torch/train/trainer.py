"""Config loading (the part of the JAX package's ``train/trainer.py`` that
sampling needs; training itself is not ported yet)."""
from __future__ import annotations

import os
from typing import Dict, Tuple

import yaml

__all__ = ["load_configs"]


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
