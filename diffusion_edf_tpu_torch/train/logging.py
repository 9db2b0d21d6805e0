"""Run logging (counterpart of the JAX package's ``train/logging.py``):
scalars append to ``<log_dir>/metrics.jsonl``, one JSON object a step with
``step``, ``time`` and the step's statistics; 3D snapshots save as
compressed ``.npz`` under ``<log_dir>/custom_data/step_N/``."""
from __future__ import annotations

import json
import os
import time
from typing import Any, Dict

import numpy as np

__all__ = ["JsonlLogger"]


class JsonlLogger:
    def __init__(self, log_dir: str):
        self.log_dir = log_dir
        self._fh = None

    def _ensure(self):
        if self._fh is None:
            os.makedirs(self.log_dir, exist_ok=True)
            self._fh = open(os.path.join(self.log_dir, "metrics.jsonl"), "a")

    def log(self, step: int, **scalars: float) -> None:
        self._ensure()
        rec = {"step": step, "time": time.time()}
        rec.update({k: float(v) for k, v in scalars.items()})
        self._fh.write(json.dumps(rec) + "\n")
        self._fh.flush()

    def log_3d(self, step: int, tag: str, arrays: Dict[str, Any]) -> None:
        self._ensure()
        d = os.path.join(self.log_dir, "custom_data", f"step_{step}")
        os.makedirs(d, exist_ok=True)
        np.savez_compressed(os.path.join(d, f"{tag}.npz"), **{k: np.asarray(v) for k, v in arrays.items()})

    def close(self):
        if self._fh:
            self._fh.close()
            self._fh = None
