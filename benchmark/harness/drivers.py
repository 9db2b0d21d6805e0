"""The drivers of the traffic kinds; a mix's ``kind`` picks one."""
from __future__ import annotations

import dataclasses
import subprocess
from typing import Any, Dict

from .core import Spec
from .traffic import Mix

__all__ = ["Run", "DRIVERS", "device_record"]


@dataclasses.dataclass
class Run:
    spec: Spec
    mix: Mix
    seed: int
    seconds: float
    trace: bool
    device: str
    root: str
    t_start: float  # the process's start on the host's clock


def device_record(device: str) -> Dict[str, Any]:
    """``device`` of the result line: the card's name and the peak memory
    allocated on it (``platform`` "cpu" on the CPU, which no result of a
    measurement carries)."""
    import torch

    if device != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": 1,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated())}


def card_power() -> str:
    """The card's name and power limit, as ``nvidia-smi`` reads them."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return "nvidia-smi unavailable"
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout.strip() else "unavailable"


def _serve(run: Run):
    from .serve import run as serve_run

    return serve_run(run)


def _train(run: Run):
    from .train import run as train_run

    return train_run(run)


DRIVERS = {"serve": _serve, "train": _train}
