"""One run of a benchmark cell with the port's span recorder on, and what
its spans say: the readings of ``benchmark/metrics/spans.py`` (queue wait,
wire time, host-gap share, the set-up's builds), the padding share from
``batch_stats``, and cross-checks against the harness's own times.

    python3 tools/torch_span_report.py --workload <cell> --seed <n> --seconds <s> [--trace 0|1] [--out f.json]

Runs ``benchmark/run.py``'s ``main`` in this process with
``profiling.record(True)`` from the start (the benchmark's own runs leave
the recorder off), keeps the traffic driver's record, adds the drained
spans to it as ``setup_spans`` and ``spans``, prints the cell's result line
as ``run.py`` does, then one ``spans`` JSON line (written to ``--out`` too).
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import statistics  # noqa: E402
import sys  # noqa: E402
from typing import Any, Dict, List  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
os.environ.setdefault("TORCH_EXTENSIONS_DIR", os.path.join(ROOT, "build", "torch_extensions"))
os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(ROOT, "build", "triton_cache"))


def _by_name(spans) -> Dict[str, Dict[str, float]]:
    out: Dict[str, Dict[str, float]] = {}
    for s in spans:
        d = out.setdefault(s.name, {"count": 0, "s": 0.0})
        d["count"] += 1
        d["s"] += s.seconds
    return out


def cross_checks(record: Dict[str, Any]) -> Dict[str, Any]:
    """Queue + own dispatch over latency per request; the harness's own
    share of a request outside its agent call (one client only); the
    window's dispatches as (real, padded)."""
    from benchmark.metrics import spans as sp

    reqs = [r for r in record.get("requests") or () if r["ok"]]
    window = sp.window_spans(record)
    per = sp.per_request(record)
    dispatches = sorted((s for s in window if s.name == "serve.dispatch"), key=lambda s: s.t0)
    own = {rid: d for d in dispatches for rid in d.request}
    ratios = []
    for s in window:
        if s.name != "serve.request" or s.request not in own:
            continue
        holders = [r for r in reqs if r["t_send"] <= s.t0 / 1e9 and s.t1 / 1e9 <= r["t_reply"]]
        if holders:
            r = max(holders, key=lambda r: r["t_send"])
            ratios.append((per[s.request].get("serve.queue", 0.0) + own[s.request].seconds)
                          / (r["t_reply"] - r["t_send"]))
    out: Dict[str, Any] = {
        "request_spans": len(per), "dispatches": [[d.attrs["real"], d.attrs["padded"]] for d in dispatches],
        "queue_plus_dispatch_over_latency": {"median": statistics.median(ratios) if ratios else None,
                                             "min": min(ratios, default=None), "max": max(ratios, default=None)},
        "window_by_name": _by_name(window),
    }
    calls = [c for c in record.get("calls", []) if not c.get("profile")]
    if reqs and len(calls) == len(reqs):  # one client, no batching: calls and requests pair one to one
        out["harness_gap_share"] = 100.0 * statistics.median((r["t_reply"] - r["t_send"] - c["wall_s"])
                                                             / (r["t_reply"] - r["t_send"]) for r, c in zip(reqs, calls))
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--device", default="cuda", help="cpu: a rehearsal on tiny cells (see benchmark/tests)")
    p.add_argument("--root", default=ROOT, help="the checkout whose BENCHMARK.json names the cell")
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    from diffusion_edf_tpu_torch.utils import profiling

    profiling.record(True)
    from benchmark.harness import core, drivers
    from benchmark.metrics import spans as sp
    from benchmark.metrics.readers import request_ms_p50, serve_ms

    records: List[Dict[str, Any]] = []

    def keep(fn):
        def run(r):
            records.append(fn(r))
            return records[-1]
        return run

    plain = dict(drivers.DRIVERS)
    drivers.DRIVERS.update({kind: keep(fn) for kind, fn in plain.items()})
    try:
        code = core.main(["--workload", args.workload, "--seed", str(args.seed), "--seconds", str(args.seconds),
                          "--trace", str(args.trace)], t_start=T_START, device=args.device, root=args.root)
    finally:
        drivers.DRIVERS.update(plain)
        spans = profiling.drain()
        profiling.record(False)
    if code != 0 or not records:
        return code or 1
    record = records[0]
    setup_end = T_START + record["setup_s"]
    record["setup_spans"] = [s for s in spans if s.t1 / 1e9 <= setup_end]
    record["spans"] = [s for s in spans if s.t1 / 1e9 > setup_end]
    builds: Dict[str, Dict[str, float]] = {}
    for b in record["setup_spans"]:
        if b.name == "graphs.build":
            d = builds.setdefault(b.attrs["entry"], {"count": 0, "build_s": 0.0, "capture_s": 0.0})
            d["count"] += 1
            d["build_s"] += b.seconds
            d["capture_s"] += b.attrs["capture_s"]
    out: Dict[str, Any] = {
        "workload": args.workload, "seed": args.seed, "spans": len(spans), "setup_s": record["setup_s"],
        "capture_s": sp.capture_s(record), "builds": builds, "setup_by_name": _by_name(record["setup_spans"]),
        "queue_wait_ms": sp.queue_wait_ms(record), "wire_ms": sp.wire_ms(record),
        "host_gap_share": sp.host_gap_share(record), "pad_share": core.metric_reader("pad_share.place")(record),
    }
    if "requests" in record:
        out.update(cross_checks(record), request_ms_p50=request_ms_p50(record), serve_ms=serve_ms(record))
    line = json.dumps(out)
    print("spans " + line, flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
