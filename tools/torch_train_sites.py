"""Where a benchmark train cell's gathers spend their backward: the device
time of every ``aten::index_add_`` (autograd's backward of
``index_select``), by its shapes and its call site, and of the gather
transpose's kernel (``nn/gather.py``), by call site, in one eager epoch.

    python3 tools/torch_train_sites.py [--workload pick_train] [--seed 0] [--out f.json]

Builds the cell's trainer as ``benchmark/harness/train.py`` does (its
configuration, the mix's demos from the seed, the checkpoint), runs one
epoch through the captured step, then one epoch eagerly
(``use_runtime=False``: the same kernels, each linked to the op that
launched it) under ``torch.profiler`` with the ops' input shapes.  An
``index_add_`` is put to its site by its shapes: a 1-D destination is
``IrrepsLinear``'s weight assembly (``nn/layers.py``; in a tree whose
``tp.apply_dtp_cm`` still differentiates ``index_select``, also that
function's shared weights, a fraction of a millisecond an epoch on
``pick_train``), one whose source keeps the destination's last width
gathered rows (the neighbour gather of ``nn/blocks.py``), any other
gathered lanes (``tp.apply_dtp_cm``).  A launch of the gather transpose
is put to its site by its gradient and table: a 1-D gradient over a
``partial`` table is ``IrrepsLinear``'s weight assembly, any other
``tp.apply_dtp_cm``'s (its shared weights' 1-D gradients have full
tables); the tool opens a profiler range named by the site around each
launch (``gather_last_t.<site>``), whose device time is that launch's
kernel.  Prints one JSON line: device seconds by site, by (site,
shapes) and by kernel name.  ``--device cpu
--root <tiny root>`` rehearses it on the CPU, where the times are the
host's and are named so.
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile
from typing import Any, Dict

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def site(shapes) -> str:
    """The call site of an ``index_add_(dim, index, source)`` by its input
    shapes ``[self, dim, index, source, ...]``."""
    dest, source = shapes[0], shapes[3]
    if len(dest) == 1:
        return "irreps_linear"
    if dest[-1] == source[-1]:
        return "neighbour_gather"
    return "apply_dtp_cm"


def gather_site(g, table) -> str:
    """The call site of a gather transpose of ``g`` over ``table``."""
    return "irreps_linear" if g.dim() == 1 and table.partial else "apply_dtp_cm"


def main() -> int:
    import torch
    from torch.profiler import ProfilerActivity, profile

    from benchmark.harness import port, traffic
    from benchmark.harness.core import load_spec
    from diffusion_edf_tpu_torch.nn import gather

    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", default="pick_train")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--root", default=ROOT, help="the checkout whose BENCHMARK.json names the cell")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    cuda = args.device == "cuda"
    if cuda and not torch.cuda.is_available():
        print("torch_train_sites: no CUDA device (--device cpu rehearses it)", file=sys.stderr)
        return 1
    spec = load_spec(args.workload, args.root)
    params = traffic.load_mix(spec.traffic, os.path.join(args.root, "benchmark")).params
    tmp = tempfile.mkdtemp(prefix="train_sites_")
    try:
        tr = port.build_trainer(spec.config, tmp, args.root, args.device, args.seed % 2**63,
                                traffic.demos(params, args.seed))
        tr.train_epoch()  # captures every step, as the benchmark's set-up does
        tr.use_runtime = False
        tr.train_epoch()  # eager warm-up
        sync = torch.cuda.synchronize if cuda else (lambda: None)
        sync()
        name = "_launch" if cuda else "gather_last_t_plain"  # what _GatherT.forward calls on this device
        transpose = getattr(gather, name)

        def named(g, table):
            with torch.profiler.record_function(f"gather_last_t.{gather_site(g, table)}"):
                return transpose(g, table)

        setattr(gather, name, named)
        try:
            with profile(activities=[ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else []),
                         record_shapes=True) as prof:
                tr.train_epoch()
                sync()
        finally:
            setattr(gather, name, transpose)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    unit = "device_s" if cuda else "host_s (CPU rehearsal)"

    def seconds(evt) -> float:
        return (evt.device_time_total if cuda else evt.cpu_time_total) / 1e6

    by_site: Dict[str, float] = {}
    by_shape: Dict[str, Dict[str, Any]] = {}
    gather_by_site: Dict[str, Dict[str, Any]] = {}
    for evt in prof.key_averages(group_by_input_shape=True):
        if evt.key.startswith("gather_last_t."):
            where = evt.key.split(".", 1)[1]
            rec = gather_by_site.setdefault(where, dict(calls=0, s=0.0))
            rec["calls"] += evt.count
            rec["s"] += seconds(evt)
        if evt.key != "aten::index_add_":
            continue
        where = site(evt.input_shapes)
        by_site[where] = by_site.get(where, 0.0) + seconds(evt)
        by_shape[f"{where} {evt.input_shapes[0]} <- {evt.input_shapes[3]}"] = dict(calls=evt.count, s=seconds(evt))
    kernels = {}
    if cuda:
        for evt in prof.key_averages():
            if evt.device_type == torch.autograd.DeviceType.CUDA and any(
                    k in evt.key for k in ("indexFunc", "gather_last_t", "index_put", "indexing_backward")):
                kernels[evt.key[:120]] = dict(launches=evt.count, s=evt.device_time_total / 1e6)
    total = sum(by_site.values())
    out = dict(workload=args.workload, seed=args.seed, unit=unit, steps=len(tr.batches),
               index_add_s=total, index_add_share_by_site={k: v / total for k, v in by_site.items()} if total else {},
               index_add_by_site=by_site, index_add_by_shape=dict(sorted(by_shape.items(), key=lambda kv: -kv[1]["s"])),
               gather_last_t_by_site=gather_by_site, kernels=kernels)
    line = json.dumps(out)
    print(line)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
