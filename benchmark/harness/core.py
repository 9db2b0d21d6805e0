"""The command line of one run: find the cell, its configuration, its traffic
mix and its metrics by the names in ``BENCHMARK.json``, run the mix's
driver, check the result against the plain reference, and print the one
result line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Nothing of a cell is named in the code: a cell is an entry of
``BENCHMARK.json``; its configuration is the file that the configuration's
entry names; its mix is ``traffic/<traffic>.json``; each metric is read by
``metrics/<metric>.py``.  A run with ``--trace 0`` reports the cell's
end-to-end metrics, one with ``--trace 1`` its per-layer metrics.
"""
from __future__ import annotations

import argparse
import dataclasses
import importlib.util
import json
import os
import sys
from typing import Any, Callable, Dict, List, Optional

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)
FORBIDDEN = ("jax", "jaxlib", "flax", "diffusion_edf_tpu")

__all__ = ["Spec", "load_spec", "metric_reader", "forbidden_modules", "main", "ROOT", "BENCH_DIR"]


@dataclasses.dataclass
class Spec:
    """One cell as ``BENCHMARK.json`` states it."""

    workload: Dict[str, Any]
    config: Dict[str, Any]  # the configuration's file
    traffic: str
    end_to_end: List[Dict[str, Any]]  # the metrics this cell reports
    per_layer: List[Dict[str, Any]]


def _applies(metric: Dict[str, Any], cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_spec(cell: str, root: str = ROOT) -> Spec:
    """The cell ``cell`` of ``<root>/BENCHMARK.json``, its configuration and
    the metrics it reports; raises ``KeyError`` for a name not there."""
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    (w,) = [w for w in bench["workloads"] if w["name"] == cell] or [None]
    if w is None:
        raise KeyError(f"no workload {cell!r} in BENCHMARK.json")
    (c,) = [c for c in bench["configs"] if c["name"] == w["config"]]
    with open(os.path.join(root, c["file"])) as f:
        config = json.load(f)
    e2e = [m for m in bench["end_to_end"] if _applies(m, cell)]
    e2e_names = {m["name"] for m in e2e}
    per = [m for m in bench["per_layer"] if _applies(m, cell) and m["moves"] in e2e_names]
    return Spec(workload=w, config=config, traffic=w["traffic"], end_to_end=e2e, per_layer=per)


def metric_reader(name: str, bench_dir: str = BENCH_DIR) -> Callable[[Dict[str, Any]], Optional[float]]:
    """``read`` of ``metrics/<name>.py`` of the benchmark's directory: the
    metric from a run's record, or None where the record holds nothing to
    read it from."""
    path = os.path.join(bench_dir, "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(f"benchmark_metric_{name.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's,
    compared whole (the port's name begins with the JAX package's)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def _parse(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def _fail(msg: str, code: int = 2) -> int:
    print(f"benchmark: {msg}", file=sys.stderr, flush=True)
    return code


def main(argv=None, t_start: Optional[float] = None, device: str = "cuda", root: str = ROOT) -> int:
    """One run; returns the exit code.  ``device`` other than ``"cuda"``
    skips the look for a card (the tests run the harness on the CPU)."""
    import time

    t_start = time.perf_counter() if t_start is None else t_start
    args = _parse(argv)
    try:
        spec = load_spec(args.workload, root)
    except (KeyError, ValueError) as e:
        return _fail(str(e))
    import torch

    chips = int(spec.workload.get("chips", 1))
    if device == "cuda":
        if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
            return _fail(f"the cell asks for {chips} CUDA device(s); torch.cuda.is_available()="
                         f"{torch.cuda.is_available()}, device_count={torch.cuda.device_count()}")
    from . import drivers, traffic

    bench_dir = os.path.join(root, "benchmark")
    mix = traffic.load_mix(spec.traffic, bench_dir)
    run = drivers.Run(spec=spec, mix=mix, seed=args.seed, seconds=args.seconds, trace=bool(args.trace),
                      device=device, root=root, t_start=t_start)
    record = drivers.DRIVERS[mix.kind](run)
    leaked = forbidden_modules()
    if leaked:
        return _fail(f"modules of JAX or the JAX package are loaded: {leaked}", 3)
    metrics = {}
    for m in (spec.per_layer if args.trace else spec.end_to_end):
        value = metric_reader(m["name"], bench_dir)(record)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    checks = record["checks"]
    for name, v in record.get("readings", {}).items():
        print(f"reading {name}: {v!r}", file=sys.stderr)
    correct = bool(checks) and record["failed"] == 0 and record["attempted"] > 0 and all(
        c["value"] <= c["limit"] for c in checks.values())
    for name, c in checks.items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    print(f"check failed requests: {record['failed']} of {record['attempted']} (limit 0)", file=sys.stderr,
          flush=True)
    out = {"correct": correct, "attempted": record["attempted"], "failed": record["failed"], "metrics": metrics,
           "device": record["device"]}
    if args.trace and record.get("breakdown"):
        out["breakdown"] = record["breakdown"]
    out["compared"] = {name: {"value": c["value"], "limit": c["limit"]} for name, c in checks.items()}
    print(json.dumps(out), flush=True)
    return 0
