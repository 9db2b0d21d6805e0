"""Drive the PyTorch port on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero and prints no result line:

1. the card, its power limit, torch / CUDA versions, and the build of the
   hand-written CUDA kernels from ``diffusion_edf_tpu_torch/csrc``;
2. every kernel against its plain PyTorch version on the card, at the shapes
   the main path gives it (max-abs gate 3e-4), with CUDA-event timings of
   the kernel, the plain version and a library yardstick;
3. the main path: one ``pick_lowres`` cascade stage of ``agent.sample`` from
   the shipped checkpoint on 32 seeds with the 100-step schedule, with the
   kernel launch counters set to 0 before and read after; the same rollout
   with ``edge_impl="plain"`` must land within 2e-2 in final pose; then the
   p50 latency of 20-seed requests;
4. one JSON line listing each kernel, then the card line, then the result
   line ``{"ok": true, "device": {...}}``.

There is no CPU fallback: without a CUDA device the script exits 1.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
CONFIG = os.path.join(ROOT, "diffusion_edf_tpu_torch", "configs", "panda_mug", "pick_lowres")
CHECKPOINT = os.path.join(ROOT, "checkpoints", "panda_mug", "pick_lowres.npz")
KERNEL_GATE = 3e-4  # reference-width tolerance of the JAX package's edge-kernel tests
POSE_GATE = 2e-2  # bench.py's f32 final-pose gate
N_SEEDS, N_STEPS = 32, 100
# H100 SXM published peaks (NVIDIA data sheet): f32 outside the tensor cores, HBM3
PEAK_F32_FLOPS, PEAK_BYTES = 67e12, 3.35e12
UNPROCESS = [dict(name="rescale", kwargs=dict(rescale_factor=0.01))]  # cm -> m
SCHEDULE = dict(
    N_steps_list=[[N_STEPS // 2, N_STEPS - N_STEPS // 2]],
    timesteps_list=[[0.07, 0.02]],
    temperatures_list=[[1.0, 1.0]],
    diffusion_schedules_list=[[[1.0, 0.15], [0.15, 0.01]]],
    time_exponent_temp=0.5,
    time_exponent_alpha=0.5,
)


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout.strip() else "nvidia-smi unavailable"


def cuda_ms(fn, reps: int = 20) -> float:
    """Median of ``reps`` CUDA-event timings of ``fn`` after a warm-up."""
    import torch

    fn()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def scene_clouds(seed: int = 0):
    """A 1024-point tabletop scene (metres): a table patch, a mug-sized
    cylinder and clutter; and a 256-point gripper cloud."""
    from diffusion_edf_tpu_torch.train.data import PointCloud

    rng = np.random.default_rng(seed)
    table = np.c_[rng.uniform(-0.25, 0.25, (600, 2)), rng.normal(0, 0.002, 600)]
    th, z = rng.uniform(0, 2 * np.pi, 300), rng.uniform(0, 0.1, 300)
    mug = np.c_[0.04 * np.cos(th) + 0.05, 0.04 * np.sin(th) - 0.03, z]
    clutter = rng.uniform([-0.2, -0.2, 0], [0.2, 0.2, 0.15], (124, 3))
    pts = np.concatenate([table, mug, clutter]).astype(np.float32)
    cols = rng.uniform(0, 1, (len(pts), 3)).astype(np.float32)
    grasp = rng.uniform([-0.02, -0.04, 0.0], [0.02, 0.04, 0.12], (256, 3)).astype(np.float32)
    return PointCloud(pts, cols), PointCloud(grasp, rng.uniform(0, 1, (256, 3)).astype(np.float32))


def seed_poses(n: int, seed: int = 1) -> np.ndarray:
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(n, 4))
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    x = rng.uniform([-0.15, -0.15, 0.05], [0.15, 0.15, 0.3], (n, 3))
    return np.concatenate([q, x], -1).astype(np.float32)


def edge_work(ga, rows: int, S: int):
    """(flops, bytes) of one edge-kernel call: the products this call does
    and each input read once, each output written once."""
    from diffusion_edf_tpu_torch.nn import edge_kernel as ek

    plan = ga.plan
    (W_av, _, Dmat, W2, _), (spec, arrays) = ga._kernel_weights()
    dims = ek._rad_dims(spec, arrays)
    per_row = 2 * sum(a * b for a, b in zip(dims[:-1], dims[1:]))  # radial MLP
    for dtp, W in ((plan.dtp1, W_av), (plan.dtp2, W2)):
        per_row += 2 * plan.dim_sh * dtp.C_all.shape[1]  # attr @ C
        per_row += sum(2 * len(iks) * mul for _, mul, iks, _, _ in dtp.pieces)  # DTP pieces
        per_row += 2 * W.shape[0] * W.shape[1]  # folded product
    per_row += 2 * Dmat.shape[0] * Dmat.shape[1]
    weight_bytes = 4 * (sum(a.numel() for a in arrays) + W_av.numel() + W2.numel() + Dmat.numel()
                        + plan.dtp1.C_all.size + plan.dtp2.C_all.size)
    row_bytes = 4 * (plan.dim_in + plan.dim_sh + S + plan.H + plan.attn_dim)
    return per_row * rows, row_bytes * rows + weight_bytes


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels run only on the GPU", file=sys.stderr)
        return 1
    from diffusion_edf_tpu_torch.agent import DiffusionEdfAgent, load_model_bundle
    from diffusion_edf_tpu_torch.geom.sh import spherical_harmonics
    from diffusion_edf_tpu_torch.nn import edge_kernel as ek
    from diffusion_edf_tpu_torch.train.data import pad_pointcloud
    from diffusion_edf_tpu_torch.train.trainer import load_configs

    dev = torch.device("cuda")
    card = card_line()
    log(f"card: {card}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    ek.build_library()
    log(f"kernel build: {time.perf_counter() - t0:.1f} s")
    for line in ek.build_log.splitlines():
        if "registers" in line or "spill" in line:
            log(f"  ptxas: {line.strip()}")

    # ---- phase 2: K1 against its plain version at the main path's shapes ----
    bundle = load_model_bundle(CONFIG, CHECKPOINT, device=dev)
    model = bundle.model
    train_cfg, _, model_cfg = load_configs(CONFIG)
    scene, grasp = scene_clouds()
    proc_agent = DiffusionEdfAgent([bundle], train_cfg["preprocess_config"], UNPROCESS, preprocess_seed=0)
    scene_p, _ = proc_agent._prep(scene, grasp)
    with torch.no_grad():
        key_ms = model.get_key_pcd_multiscale(pad_pointcloud(scene_p, bundle.n_scene_pad, dev))
    tf = model.score_head.key_tensor_field
    # dense (null-radius) scales attend every point; radius scales their cap
    K = sum(min(getattr(getattr(tf, f"parser_{n}"), "k", pts.n), pts.n) for n, pts in enumerate(key_ms))
    nQ = model.query_model.coords.shape[0]
    down = model.key_model.down
    n0 = int(np.ceil(down.pool_ratio[0] * bundle.n_scene_pad))
    K_cap = sum(model_cfg["model_kwargs"]["score_head_kwargs"]["key_tensor_field_kwargs"]["k_multiscale"])
    tga, pga = tf.gnn_block_init.ga, down.pool_layer_0.gnn.ga
    cases = [  # (label, GraphAttention, rows, edge-scalar width)
        ("tensor_field", tga, N_SEEDS * nQ * K, tga.sep_act_rad.ch_list[0]),
        ("extractor_pool_0", pga, n0 * min(down.k_pool[0], bundle.n_scene_pad), pga.sep_act_rad.ch_list[0]),
        # every scale at its neighbour cap (a denser scene than this one)
        ("tensor_field_k_cap", tga, N_SEEDS * nQ * K_cap, tga.sep_act_rad.ch_list[0]),
    ]
    g = torch.Generator(device=dev).manual_seed(0)
    k1 = {}
    max_err = 0.0
    with torch.no_grad():
        for label, ga, rows, S in cases:
            x1 = torch.randn(rows, ga.plan.dim_in, generator=g, device=dev)
            vec = torch.randn(rows, 3, generator=g, device=dev)
            attr = spherical_harmonics("1x0e+1x1e+1x2e", vec, eps=1e-4)
            es = torch.randn(rows, S, generator=g, device=dev)
            weights, rad = ga._kernel_weights()
            kl, kv = ek.edge_kernel(ga.plan, x1, attr, es, weights, rad)
            torch.cuda.synchronize()
            pl, pv = ek.edge_core_plain(ga.plan, x1, attr, es, weights, rad)
            err = max(float((kl - pl).abs().max()), float((kv - pv).abs().max()))
            ok = err <= KERNEL_GATE and bool(torch.isfinite(kv).all())
            log(f"K1 {label}: rows {rows} width {ga.plan.dim_in} max_abs_err {err:.3g} (gate {KERNEL_GATE}) "
                f"{'ok' if ok else 'FAIL'}")
            if not ok:
                return 1
            max_err = max(max_err, err)
            ms = cuda_ms(lambda: ek.edge_kernel(ga.plan, x1, attr, es, weights, rad))
            plain_ms = cuda_ms(lambda: ek.edge_core_plain(ga.plan, x1, attr, es, weights, rad))
            W_av, W2 = weights[0], weights[3]
            Y1 = torch.randn(rows, W_av.shape[0], generator=g, device=dev)
            Y2 = torch.randn(rows, W2.shape[0], generator=g, device=dev)
            library_ms = cuda_ms(lambda: (torch.matmul(Y1, W_av), torch.matmul(Y2, W2)))
            flops, nbytes = edge_work(ga, rows, S)
            bound_ms = 1e3 * max(flops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES)
            bound_by = "operations" if flops / PEAK_F32_FLOPS >= nbytes / PEAK_BYTES else "bytes"
            log(f"K1 {label}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, library (two matmuls) {library_ms:.4f} ms, "
                f"bound {bound_ms:.4f} ms by {bound_by} ({flops / 1e9:.2f} GFLOP, {nbytes / 1e6:.2f} MB), "
                f"{flops / ms / 1e9:.1f} TFLOP/s")
            k1[label] = dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms, bound_ms=bound_ms, bound_by=bound_by)
            del x1, attr, es, Y1, Y2, kl, kv, pl, pv

    # ---- phase 3: the main path ----
    Ts_init = seed_poses(N_SEEDS)
    agent = DiffusionEdfAgent([bundle], train_cfg["preprocess_config"], UNPROCESS, preprocess_seed=0)
    agent.sample(scene, grasp, Ts_init[:2], generator=torch.Generator(device=dev).manual_seed(9),
                 record_trajectory=False, **dict(SCHEDULE, N_steps_list=[[1, 1]]))  # warm-up
    agent = DiffusionEdfAgent([bundle], train_cfg["preprocess_config"], UNPROCESS, preprocess_seed=0)
    ek.launches = 0
    traj, _, _, info = agent.sample(scene, grasp, Ts_init, generator=torch.Generator(device=dev).manual_seed(1),
                                    **SCHEDULE)
    torch.cuda.synchronize()
    launches = ek.launches
    steps = info["steps"][0]
    log(f"main path: {N_SEEDS} seeds x {steps} steps, extract {info['extract_s'][0] * 1e3:.1f} ms, "
        f"rollout {info['rollout_s'][0] * 1e3:.1f} ms, K1 launches {launches}")
    if launches <= 0:
        log("FAIL: the main path launched no edge kernel")
        return 1
    final = traj[-1]
    if not (np.isfinite(traj).all() and traj.shape == (steps + 1, N_SEEDS, 7)
            and np.allclose(np.linalg.norm(final[:, :4], axis=-1), 1.0, atol=1e-4)):
        log("FAIL: trajectory not finite, of the wrong shape, or with non-unit quaternions")
        return 1
    pose_steps = N_SEEDS * steps / info["rollout_s"][0]
    ms_step = info["rollout_s"][0] * 1e3 / steps
    log(f"main path: {pose_steps:.1f} pose-steps/s, {ms_step:.3f} ms per Langevin step "
        f"({launches / steps:.2f} K1 launches per step incl. extraction)")

    model.set_edge_impl("plain")
    agent_plain = DiffusionEdfAgent([bundle], train_cfg["preprocess_config"], UNPROCESS, preprocess_seed=0)
    traj_p, _, _, info_p = agent_plain.sample(scene, grasp, Ts_init,
                                              generator=torch.Generator(device=dev).manual_seed(1), **SCHEDULE)
    model.set_edge_impl(None)
    drift = float(np.abs(final - traj_p[-1]).max())
    log(f"final-pose drift kernel vs plain: {drift:.3g} (gate {POSE_GATE}); plain rollout "
        f"{info_p['rollout_s'][0] * 1e3 / steps:.3f} ms per step")
    if not drift <= POSE_GATE:
        log("FAIL: kernel rollout drifts from the plain rollout")
        return 1

    lat = []
    for i in range(5):
        t = time.perf_counter()
        agent.sample(scene, grasp, seed_poses(20, seed=10 + i), record_trajectory=False,
                     generator=torch.Generator(device=dev).manual_seed(i), **SCHEDULE)
        lat.append(time.perf_counter() - t)
    log(f"20-seed requests: p50 latency {np.median(lat) * 1e3:.1f} ms over {len(lat)} "
        f"(min {min(lat) * 1e3:.1f}, max {max(lat) * 1e3:.1f})")

    tfk = k1["tensor_field"]
    kernels = [dict(
        name="edge_kernel", route="cuda", source="diffusion_edf_tpu_torch/csrc/edge_kernel.cu",
        replaces="diffusion_edf_tpu/nn/edge_kernel.py:477", launches=launches, max_abs_err=max_err,
        ms=tfk["ms"], plain_ms=tfk["plain_ms"], bound_ms=tfk["bound_ms"], bound_by=tfk["bound_by"],
        library_ms=tfk["library_ms"],
    )]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
