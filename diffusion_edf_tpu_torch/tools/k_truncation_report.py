"""How often a radius search's static cap clips a neighbourhood (counterpart
of the JAX repository's ``tools/k_truncation_report.py``; the same rows).

The reference caps every radius search at 1000 unordered neighbours; this
model keeps the nearest ``k`` within the radius, a small static cap per call
site.  Over realistic preprocessed synthetic scenes and poses spread across
the diffusion range, the whole model (extractor, query model, one score on
the model's ``edge_impl``) runs inside ``ops/neighbors.py::
record_degree_tape``, and per call site ``tag`` the rows report the radius,
the cap, the largest in-radius degree, the share of valid destinations whose
degree exceeds the cap, and how many destinations were seen::

    python -m diffusion_edf_tpu_torch.tools.k_truncation_report \\
        --configs-root-dir diffusion_edf_tpu_torch/configs/panda_mug/pick_lowres \\
        --n-demos 5 --n-poses 8 --json-out build/k_truncation.json [--device cpu]

The model has the trainer's seeded random weights (the extractor's rows
depend on the clouds alone); the poses of demo after demo come from one
``torch.Generator`` on the device seeded 0.  Every demo is recorded: the
port runs eagerly, so each call's degrees are concrete tensors."""
from __future__ import annotations

import argparse
import json
from typing import Dict, List

import torch

__all__ = ["collect", "main"]


@torch.no_grad()
def collect(model, scene, grasp, Ts: torch.Tensor, t: torch.Tensor) -> List[Dict]:
    """The degree-tape summaries of one extraction of ``scene`` and
    ``grasp`` and one score of the poses ``Ts`` (n, 7) at times ``t`` (n,)."""
    from ..data import stack_points
    from ..ops.neighbors import record_degree_tape, summarize_degree_tape

    with record_degree_tape() as tape:
        key_ms = [stack_points([p]) for p in model.get_key_pcd_multiscale(scene)]
        query = stack_points([model.get_query_pcd(grasp)])
        model.score(Ts[None], key_ms, query, t[None])
    return summarize_degree_tape(tape)


def main(argv=None) -> List[Dict]:
    p = argparse.ArgumentParser(description="Measure the K-truncation of every radius search of a model")
    p.add_argument("--configs-root-dir", default="diffusion_edf_tpu_torch/configs/panda_mug/pick_lowres")
    p.add_argument("--task-type", default="pick")
    p.add_argument("--n-demos", type=int, default=5)
    p.add_argument("--n-scene-pad", type=int, default=2048)
    p.add_argument("--n-grasp-pad", type=int, default=512)
    p.add_argument("--n-poses", type=int, default=8, help="diffused poses per scene")
    p.add_argument("--json-out", default=None)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)

    from ..train.synthetic import make_synthetic_dataset
    from ..train.trainer import DiffusionEdfTrainer

    tr = DiffusionEdfTrainer(args.configs_root_dir, n_scene_pad=args.n_scene_pad, n_grasp_pad=args.n_grasp_pad,
                             device=args.device)
    tr.init(make_synthetic_dataset(n_demos=args.n_demos, seed=0))
    model = tr.model.eval()
    g = torch.Generator(device=tr.device).manual_seed(0)

    # per tag, the worst degree and the truncated share over demos x poses spanning the diffusion range
    agg: Dict[str, Dict] = {}
    for b in tr.batches:
        scene = b.scene
        q = torch.randn(args.n_poses, 4, generator=g, device=tr.device)
        q = q / torch.linalg.norm(q, dim=-1, keepdim=True)
        center = torch.where(scene.mask[:, None], scene.x, 0.0).sum(0) / scene.mask.sum().clamp(min=1)
        x = center + torch.randn(args.n_poses, 3, generator=g, device=tr.device) * 10.0  # cm
        t = torch.rand(args.n_poses, generator=g, device=tr.device) * (1.0 - 0.001) + 0.001
        for s in collect(model, scene, b.grasp, torch.cat([q, x], dim=-1), t):
            a = agg.setdefault(s["tag"], dict(tag=s["tag"], r=s["r"], k=s["k"], max_degree=0, frac_truncated=0.0,
                                              n_eval=0))
            a["max_degree"] = max(a["max_degree"], s["max_degree"])
            a["frac_truncated"] = ((a["frac_truncated"] * a["n_eval"] + s["frac_truncated"] * s["n_dst"])
                                   / max(a["n_eval"] + s["n_dst"], 1))
            a["n_eval"] += s["n_dst"]

    rows = sorted(agg.values(), key=lambda r: -r["frac_truncated"])
    print(f"{'tag':32s} {'r':>7s} {'k':>4s} {'maxdeg':>6s} {'frac>k':>8s}")
    for r in rows:
        print(f"{r['tag']:32s} {r['r']:7.2f} {r['k']:4d} {r['max_degree']:6d} {r['frac_truncated']:8.4f}")
    print(f"worst frac_truncated = {max((r['frac_truncated'] for r in rows), default=0.0):.4f}")
    if args.json_out:
        with open(args.json_out, "w") as f:
            json.dump(rows, f, indent=1)
        print("wrote", args.json_out)
    return rows


if __name__ == "__main__":
    main()
