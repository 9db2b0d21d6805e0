"""Where one Langevin step of the PyTorch port spends its time on the GPU.

    python3 tools/torch_step_profile.py [--steps 10] [--seeds 32]

Loads the pick_lowres checkpoint, extracts the scene once, then profiles
``--steps`` score evaluations with ``torch.profiler`` and prints: wall time
per step, device busy time per step (sum of kernel times), the device's idle
share, kernel launches per step, and the kernels that take the most device
time.  Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main() -> int:
    import torch
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke as cs
    from diffusion_edf_tpu_torch.agent import DiffusionEdfAgent, load_model_bundle
    from diffusion_edf_tpu_torch.train.data import pad_pointcloud
    from diffusion_edf_tpu_torch.train.trainer import load_configs

    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--seeds", type=int, default=32)
    ap.add_argument("--edge-impl", default=None, choices=[None, "kernel", "plain"])
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_step_profile: needs a CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    print(f"card: {cs.card_line()}")
    bundle = load_model_bundle(cs.CONFIG, cs.CHECKPOINT, device=dev, edge_impl=args.edge_impl)
    model = bundle.model
    train_cfg, _, _ = load_configs(cs.CONFIG)
    scene, grasp = cs.scene_clouds()
    agent = DiffusionEdfAgent([bundle], train_cfg["preprocess_config"], cs.UNPROCESS, preprocess_seed=0)
    scene_p, grasp_p = agent._prep(scene, grasp)
    T = torch.as_tensor(cs.seed_poses(args.seeds), device=dev)
    T = torch.cat([T[:, :4], T[:, 4:] * 100.0], dim=-1)
    time_vec = torch.full((args.seeds,), 0.3, device=dev)
    with torch.no_grad():
        key_ms = model.get_key_pcd_multiscale(pad_pointcloud(scene_p, bundle.n_scene_pad, dev))
        query = model.get_query_pcd(pad_pointcloud(grasp_p, bundle.n_grasp_pad, dev))
        for _ in range(3):
            model.score(T, key_ms, query, time_vec)
        torch.cuda.synchronize()
        # wall time without the profiler, whose host-side tracing slows the step
        t0 = time.perf_counter()
        for _ in range(args.steps):
            model.score(T, key_ms, query, time_vec)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / args.steps
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(args.steps):
                model.score(T, key_ms, query, time_vec)
            torch.cuda.synchronize()
    events = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.device_time for e in events) / args.steps
    print(f"steps {args.steps} seeds {args.seeds} edge_impl {args.edge_impl or 'default'}")
    print(f"wall per step {wall * 1e3:.3f} ms, device busy per step {busy_us / 1e3:.3f} ms, "
          f"device idle share {1 - busy_us / 1e3 / (wall * 1e3):.3f}, kernels per step {len(events) / args.steps:.0f}")
    by_name = {}
    for e in events:
        n, t = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (n + 1, t + e.device_time)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:15]
    print("top kernels by device time per step (us, launches per step):")
    for name, (n, t) in top:
        print(f"  {t / args.steps:9.1f}  {n / args.steps:6.1f}  {name[:110]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
