"""The port imports no JAX: every module of ``diffusion_edf_tpu_torch``
(its tools included) and ``chip_smoke.py``, imported in a fresh
interpreter, load no module of ``jax``, ``flax``, ``optax``, ``orbax`` or the
JAX package ``diffusion_edf_tpu``."""
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "diffusion_edf_tpu")

SCRIPT = """
import importlib, importlib.util, json, pkgutil, sys
import diffusion_edf_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
spec = importlib.util.spec_from_file_location("chip_smoke", "chip_smoke.py")
spec.loader.exec_module(importlib.util.module_from_spec(spec))
print(json.dumps(dict(imported=names, loaded=sorted(sys.modules))))
"""


def test_port_and_chip_smoke_import_no_jax():
    out = subprocess.run([sys.executable, "-c", SCRIPT], cwd=ROOT, capture_output=True, text=True, timeout=300,
                         check=True)
    res = json.loads(out.stdout.strip().splitlines()[-1])
    tools = {n for n in res["imported"] if n.startswith("diffusion_edf_tpu_torch.tools.")}
    names = ("gen_cascade_samples", "train_critic_cascade", "sweep_schedule", "train_eval_loop", "k_truncation_report")
    assert {"diffusion_edf_tpu_torch.tools." + t for t in names} <= tools
    assert len(res["imported"]) > 40
    bad = [m for m in res["loaded"] if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"the port loaded JAX-side modules: {bad[:10]}"
