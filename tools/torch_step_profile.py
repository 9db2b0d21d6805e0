"""Where one Langevin step of the PyTorch port spends its time on the GPU.

    python3 tools/torch_step_profile.py [--steps 10] [--seeds 32] [--edge-impl fused] [--model place_lowres]

Loads the ``--model`` checkpoint (``pick_lowres``, or ``place_lowres`` on the
mug-in-gripper cloud of ``chip_smoke.place_clouds``, whose query is the
keypoint extractor's 52 points), extracts scene and grasp once, then profiles
``--steps`` score evaluations (``chip_smoke.step_profile``, the one profiler
of the port) under the chosen ``edge_impl`` and prints: wall time
per step, device busy time per step (sum of kernel times), the device's idle
share, kernel launches per step, and the kernels that take the most device
time.  Then one Langevin step (score and update) of the first stage of
``chip_smoke.SCHEDULE`` (``PICK_REQUEST``'s for the place model), eager
(``langevin_sample``) beside captured (the agent's sampling runtime,
replaying its graphs): wall ms, device busy, idle share and kernels a step
(``chip_smoke.langevin_step_rows``).  Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main() -> int:
    import torch

    import chip_smoke as cs
    from diffusion_edf_tpu_torch.agent import DiffusionEdfAgent, load_model_bundle
    from diffusion_edf_tpu_torch.train.data import pad_pointcloud
    from diffusion_edf_tpu_torch.train.trainer import load_configs

    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--seeds", type=int, default=32)
    ap.add_argument("--edge-impl", default=None, choices=[None, *cs.EDGE_IMPLS])
    ap.add_argument("--model", default="pick_lowres", choices=["pick_lowres", "place_lowres"])
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_step_profile: needs a CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    print(f"card: {cs.card_line()}")
    config = os.path.join(cs.CONFIGS, args.model)
    bundle = load_model_bundle(config, os.path.join(cs.CHECKPOINTS, args.model + ".npz"), device=dev,
                               edge_impl=args.edge_impl)
    model = bundle.model
    train_cfg, _, _ = load_configs(config)
    scene, grasp = cs.place_clouds() if args.model.startswith("place") else cs.scene_clouds()
    agent = DiffusionEdfAgent([bundle], train_cfg["preprocess_config"], cs.UNPROCESS, preprocess_seed=0)
    scene_p, grasp_p = agent._prep(scene, grasp)
    T = torch.as_tensor(cs.seed_poses(args.seeds), device=dev)
    T = torch.cat([T[:, :4], T[:, 4:] * 100.0], dim=-1)
    time_vec = torch.full((args.seeds,), 0.3, device=dev)
    with torch.no_grad():
        key_ms = model.get_key_pcd_multiscale(pad_pointcloud(scene_p, bundle.n_scene_pad, dev))
        query = model.get_query_pcd(pad_pointcloud(grasp_p, bundle.n_grasp_pad, dev))
        wall, busy, n_kernels, by_name = cs.step_profile(model, T, key_ms, query, time_vec, steps=args.steps,
                                                         wall_steps=args.steps)
    print(f"{args.model}: steps {args.steps} seeds {args.seeds} query points {query.n} "
          f"({int(query.mask.sum())} kept) edge_impl {args.edge_impl or 'default'}")
    print(f"wall per step {wall:.3f} ms, device busy per step {busy:.3f} ms, "
          f"device idle share {1 - busy / wall:.3f}, kernels per step {n_kernels:.0f}")
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:15]
    print("top kernels by device time per step (us, launches per step):")
    for name, (n, t) in top:
        print(f"  {t:9.1f}  {n:6.1f}  {name[:110]}")
    sched = cs.PICK_REQUEST if args.model.startswith("place") else cs.SCHEDULE
    Ts = cs.seed_poses(args.seeds)
    agent.sample(scene, grasp, Ts, generator=torch.Generator(device=dev).manual_seed(0), **sched)  # captures
    for name, row in cs.langevin_step_rows(agent, scene, grasp, Ts, sched,
                                           torch.Generator(device=dev).manual_seed(1)).items():
        print(f"Langevin step ({name}, {row['steps']}-step first stage): {cs.step_row_text(row)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
