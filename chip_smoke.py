"""Drive the PyTorch port on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero and prints no result line:

1. the card, its power limit, torch / CUDA versions, and the build of the
   hand-written CUDA kernels from ``diffusion_edf_tpu_torch/csrc`` (one
   ``nvcc`` per source, started together);
2. every kernel against its plain PyTorch version on the card, at the shapes
   the paths below give it, with timings of the kernel and of a library
   yardstick (two matmuls on every row, and for the masked kernels also on
   as many rows as the mask keeps; the device time of their kernels,
   ``device_ms``), of the plain
   version (CUDA events) and the kernel's bound: the edge kernel in float32
   (max-abs gate 3e-4) on every row of random inputs and, given the mask,
   on the inputs the model really hands it, the rows the mask drops exactly
   0; in its mixed bfloat16 mode (gates below); the fused attention kernel
   (3e-4) on the model's inputs, with rows whose slots are all masked; both
   masked kernels also at masks that stress their compaction of the valid
   slots (all valid, all masked, one slot a row, a count that fills its
   tiles exactly, rows that straddle tiles); each kernel's own function in
   the SASS must hold ``HGMMA``;
3. the first path: one ``pick_lowres`` cascade stage of ``agent.sample`` from
   the shipped checkpoint on 32 seeds with the 100-step schedule on the
   default ``edge_impl`` (the float32 edge kernel, given the edge mask), with the launch counters
   set to 0 before and read after; the same rollout with
   ``edge_impl="plain"`` must land within 2e-2 in final pose; then the p50
   latency of 20-seed requests;
4. the whole pick request on ``edge_impl="fused"``: ``pick_lowres`` (100
   steps), ``pick_highres`` (100 steps shaped as the server's second stage)
   and the ``pick_ebm`` critic, counters set to 0 before and read after;
   finite unit-quaternion poses of the expected shape, energies ascending
   and equal to the critic's energy of the returned poses; final poses and
   energies against the same request on ``edge_impl="plain"``;
5. the ``pick_lowres`` stage on ``edge_impl="kernel_bf16"`` against the plain
   rollout, counters as before.  On the shipped checkpoint the kernel's
   rollout is gated against the plain rollout that rounds at the same places
   (the kernel's plain mixed version in every ``GraphAttention``), and so is
   one score evaluation of the whole model, so a wrong kernel fails on the
   real weights; its drift against the float32 plain
   rollout is reported beside the drift that rounding nothing but the message
   gives and the drift at temperature 0.  The 5e-2 gate against the float32
   rollout is applied on seeded random weights, the setting in which the JAX
   package's benchmark defines and measures it;
6. one score step of ``pick_lowres`` under each ``edge_impl``: wall time,
   device time and kernel count (``step_profile``, which
   ``tools/torch_step_profile.py`` prints in more detail);
7. one pick request at the server's full schedule (400 + 500 steps, 20
   seeds) on the default ``edge_impl`` and on ``"fused"``, each timed once;
8. one JSON line listing each kernel, then the card line, then the result
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
CONFIGS = os.path.join(ROOT, "diffusion_edf_tpu_torch", "configs", "panda_mug")
CHECKPOINTS = os.path.join(ROOT, "checkpoints", "panda_mug")
CONFIG = os.path.join(CONFIGS, "pick_lowres")
CHECKPOINT = os.path.join(CHECKPOINTS, "pick_lowres.npz")
KERNEL_GATE = 3e-4  # reference-width tolerance of the JAX package's kernel tests
# mixed bfloat16 edge kernel against its plain version: both round at the same
# places, and a float32 sum taken in another order moves a bfloat16 rounding by
# at most one unit (2^-8 relative) before the products spread it
# (seen on an H100 at the three shapes: logits 1.2e-3, 1.2e-3 and 5.4e-3 absolute, the last at 13,312
# rows where max|logits| is largest; val 1.3e-3, 2.2e-3 and 2.7e-3 of max|val|; the gates started at 2e-2)
BF16_LOGIT_GATE = 1e-2  # absolute
BF16_VAL_GATE = 5e-3  # of max|val|
POSE_GATE = 2e-2  # bench.py's f32 final-pose gate
# bench.py's gate for a quantised rollout against the f32 module rollout; bench.py
# applies it to a model with freshly initialised weights, and so does phase 5
BF16_POSE_GATE = 5e-2
# shipped checkpoint, the kernel against the plain path that rounds at the same
# places: one score evaluation of the whole model, of max|score|; and the final
# poses of the 100-step rollout, at temperature 0 and with noise (seen on an
# H100: 0.047 and 0.098; a rollout amplifies per-call differences about 75-fold)
BF16_SCORE_GATE = 5e-3  # seen 3.4e-3; the f32 plain score sits 9.3e-3 off, so a kernel that rounds nowhere fails
BF16_SAME_ROUNDING_GATE = 0.2
ENERGY_GATE = 1e-3  # fused against plain, per seed, on energies of order 1 (seen: 2.3e-5)
N_SEEDS, N_STEPS = 32, 100
# H100 SXM published peaks (NVIDIA data sheet): f32 outside the tensor cores,
# dense bf16 and dense TF32 on them, HBM3.  A float32 product on the tensor
# cores is three TF32 products (hi/lo split), so it is held against a third of
# the TF32 peak: 165 TFLOP/s, above the CUDA cores' 67.
PEAK_F32_FLOPS, PEAK_BF16_FLOPS, PEAK_TF32_FLOPS, PEAK_BYTES = 67e12, 989e12, 495e12, 3.35e12
PEAK_F32_TENSOR_FLOPS = PEAK_TF32_FLOPS / 3
UNPROCESS = [dict(name="rescale", kwargs=dict(rescale_factor=0.01))]  # cm -> m
SCHEDULE = dict(
    N_steps_list=[[N_STEPS // 2, N_STEPS - N_STEPS // 2]],
    timesteps_list=[[0.07, 0.02]],
    temperatures_list=[[1.0, 1.0]],
    diffusion_schedules_list=[[[1.0, 0.15], [0.15, 0.01]]],
    time_exponent_temp=0.5,
    time_exponent_alpha=0.5,
)
# the second stage and the exponents of configs/panda_mug/server.yaml
STAGE2 = dict(N_steps=[40, 40, 20], timesteps=[0.02, 0.02, 0.01], temperatures=[1.0, 1.0, 0.0],
              schedules=[[0.09, 0.03], [0.03, 0.012], [0.012, 0.012]])
PICK_REQUEST = dict(
    N_steps_list=SCHEDULE["N_steps_list"] + [STAGE2["N_steps"]],
    timesteps_list=SCHEDULE["timesteps_list"] + [STAGE2["timesteps"]],
    temperatures_list=SCHEDULE["temperatures_list"] + [STAGE2["temperatures"]],
    diffusion_schedules_list=SCHEDULE["diffusion_schedules_list"] + [STAGE2["schedules"]],
    time_exponent_temp=0.5,
    time_exponent_alpha=0.5,
)
SERVER_REQUEST = dict(  # pick_diffusion_configs of configs/panda_mug/server.yaml
    N_steps_list=[[200, 200], [200, 200, 100]],
    timesteps_list=[[0.04, 0.04], [0.02, 0.02, 0.01]],
    temperatures_list=[[1.0, 1.0], [1.0, 1.0, 0.0]],
    diffusion_schedules_list=[[[1.0, 0.15], [0.15, 0.09]], STAGE2["schedules"]],
    time_exponent_temp=1.0,
    time_exponent_alpha=0.5,
    log_t_schedule=True,
)
EDGE_IMPLS = ("plain", "kernel", "kernel_bf16", "fused")


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


def device_ms(fn, reps: int = 10, by_name: bool = False):
    """Device time of one call of ``fn`` in ms: the sum of the durations of
    the CUDA kernels it launches, from ``torch.profiler`` over ``reps`` calls
    (``by_name``: a dict of it per kernel name instead).  Unlike
    :func:`cuda_ms` it leaves out the host's time between launches, which
    exceeds a short kernel's own."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):  # the profiler has come back once without the device's records (H100, torch 2.11)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        per = {}
        for e in prof.events():
            if e.device_type == torch.autograd.DeviceType.CUDA and not e.name.startswith(("Memcpy", "Memset")):
                per[e.name] = per.get(e.name, 0.0) + e.device_time / reps / 1e3
        if sum(per.values()) > 0:
            return per if by_name else sum(per.values())
        log("device_ms: the profiler recorded no kernel time; profiling again")
    raise RuntimeError("device_ms: the profiler recorded no kernel of the call")


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


def segment_work(ga, mixed: bool = False):
    """(flops per edge row, those of them in the ``Y1 @ W_av`` product, those
    in the ``Y2 @ W2`` product, weight bytes) of the edge segment of one
    ``GraphAttention``.  ``mixed``: ``W_av`` counts 2 bytes an element."""
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
    weight_bytes = 4 * (sum(a.numel() for a in arrays) + W2.numel() + Dmat.numel()
                        + plan.dtp1.C_all.size + plan.dtp2.C_all.size) + (2 if mixed else 4) * W_av.numel()
    return per_row, 2 * W_av.shape[0] * W_av.shape[1], 2 * W2.shape[0] * W2.shape[1], weight_bytes


def edge_work(ga, rows: int, S: int, mixed: bool = False, valid=None):
    """(flops, those of them in the first and in the second folded product,
    bytes) of one edge-kernel call: the products this call does and each
    input read once, each output written once.  ``mixed``: the message and
    ``val`` count 2 bytes an element.  ``valid``: the rows a mask keeps, the
    only ones computed and the only ones whose inputs are read; every row's
    outputs are written, and the mask adds a byte a row."""
    plan = ga.plan
    per_row, p1, p2, weight_bytes = segment_work(ga, mixed)
    wide = 2 if mixed else 4
    in_bytes = wide * plan.dim_in + 4 * (plan.dim_sh + S)
    out_bytes = wide * plan.attn_dim + 4 * plan.H
    n = rows if valid is None else valid
    return per_row * n, p1 * n, p2 * n, in_bytes * n + out_bytes * rows + weight_bytes + (0 if valid is None else rows)


def attention_work(ga, nd: int, k: int, S: int, n_valid: int, use_pre: bool, use_post: bool):
    """(flops, those of them in the two folded products, bytes) of one
    fused-attention call: the segment on ``n_valid`` slots plus their softmax
    and weighted sum; the valid slots' inputs and the whole mask read once,
    the (Nd, attn) output written once.  Neither logits nor val count: they
    never reach device memory."""
    plan = ga.plan
    per_row, p1, p2, weight_bytes = segment_work(ga)
    per_row += 4 * plan.H + 2 * plan.attn_dim  # exp / scale per head, weighted sum per lane
    slot_bytes = 4 * (plan.dim_in + plan.dim_sh + S + int(use_pre) + int(use_post))
    nbytes = slot_bytes * n_valid + nd * k + weight_bytes + 4 * nd * plan.attn_dim
    return per_row * n_valid, (p1 + p2) * n_valid, nbytes


def bound(flops: float, nbytes: float, flops_bf16: float = 0.0, flops_f32_tensor: float = 0.0):
    """(bound ms, what binds): ``flops_bf16`` of the ``flops`` take bfloat16
    operands and ``flops_f32_tensor`` are float32 products that run on the
    tensor cores as 3xTF32; each is held against its own peak, the rest
    against the CUDA cores' float32 peak."""
    t_ops = ((flops - flops_bf16 - flops_f32_tensor) / PEAK_F32_FLOPS + flops_bf16 / PEAK_BF16_FLOPS
             + flops_f32_tensor / PEAK_F32_TENSOR_FLOPS)
    t_bytes = nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def library_products_ms(weights, rows: int, g, dev, mixed: bool = False):
    """The two folded products of the segment as two ``torch.matmul`` calls
    on operands of the kernel's types: the library yardstick."""
    import torch

    W_av, W2 = weights[0], weights[3]
    Y1 = torch.randn(rows, W_av.shape[0], generator=g, device=dev).to(W_av.dtype)
    Y2 = torch.randn(rows, W2.shape[0], generator=g, device=dev)
    return device_ms(lambda: (torch.matmul(Y1, W_av), torch.matmul(Y2, W2)))


def stress_masks(mask):
    """Masks that stress the compaction of the valid slots into tiles of 64,
    from a (Nd, K) mask of the shape's own fill: all valid, all masked, one
    slot a row, the first valid slots as many as fill whole tiles, rows that
    straddle tiles (and one over several)."""
    import torch

    nd, k = mask.shape
    dev = mask.device
    flat = mask.reshape(-1)
    one = torch.zeros_like(mask)
    one[torch.arange(nd, device=dev), (7 * torch.arange(nd, device=dev)) % k] = True
    keep = (int(flat.sum()) // 64) * 64
    exact = (flat & (torch.cumsum(flat, 0) <= keep)).reshape(nd, k)
    straddle = torch.zeros_like(mask)
    straddle[:, : min(k, 40)] = True  # 40 a row: every second row lies across a tile boundary
    straddle[1] = True  # and one row over several tiles
    straddle[2] = False
    return (("all valid", torch.ones_like(mask)), ("all masked", torch.zeros_like(mask)),
            ("one valid slot a row", one), (f"{keep} valid: whole tiles exactly", exact),
            ("rows that straddle tiles", straddle))


def capture_attention_inputs(ga, run):
    """The arguments ``ga`` (a GraphAttention) receives while ``run()``
    executes: ``(message, attr, scalars, mask, pre, post)`` of its last call."""
    got = {}

    def hook(_mod, args, kwargs):
        got["args"] = tuple(args) + (kwargs.get("edge_pre_attn_logit"), kwargs.get("edge_post_attn"))

    handle = ga.register_forward_pre_hook(hook, with_kwargs=True)
    try:
        run()
    finally:
        handle.remove()
    return got["args"]


def step_profile(model, T, key_ms, query, time_vec, steps: int = 10, wall_steps: int = 30):
    """(wall ms, device-busy ms, kernels, {kernel name: (launches, device us)})
    per score step: the wall from an unprofiled loop (the profiler's host
    tracing slows the step), the device numbers from ``torch.profiler``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        model.score(T, key_ms, query, time_vec)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(wall_steps):
        model.score(T, key_ms, query, time_vec)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / wall_steps
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            model.score(T, key_ms, query, time_vec)
        torch.cuda.synchronize()
    events = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    by_name = {}
    for e in events:
        n, t = by_name.get(e.name, (0.0, 0.0))
        by_name[e.name] = (n + 1 / steps, t + e.device_time / steps)
    return wall * 1e3, sum(e.device_time for e in events) / steps / 1e3, len(events) / steps, by_name


def unsort(traj: np.ndarray, T0: np.ndarray) -> np.ndarray:
    """For every row of ``T0`` the column of ``traj`` that starts from it (the
    critic reorders the seed axis of the whole trajectory)."""
    d = np.abs(traj[0][None, :, :] - T0[:, None, :]).max(axis=-1)
    order = d.argmin(axis=1)
    assert len(set(order.tolist())) == len(T0) and d.min(axis=1).max() < 1e-4
    return order


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels run only on the GPU", file=sys.stderr)
        return 1
    from diffusion_edf_tpu_torch.agent import DiffusionEdfAgent, load_model_bundle
    from diffusion_edf_tpu_torch.geom.sh import spherical_harmonics
    from diffusion_edf_tpu_torch.nn import attention, cuda_build
    from diffusion_edf_tpu_torch.nn import edge_kernel as ek
    from diffusion_edf_tpu_torch.nn import fused_attention as fa
    from diffusion_edf_tpu_torch.nn.attention import _head_of_col
    from diffusion_edf_tpu_torch.train.data import pad_pointcloud
    from diffusion_edf_tpu_torch.train.trainer import load_configs

    def reset_counters():
        ek.launches = ek.launches_bf16 = fa.launches = 0

    def counters():
        return dict(edge_kernel=ek.launches, edge_kernel_bf16=ek.launches_bf16, fused_attention=fa.launches)

    t_start = time.perf_counter()
    dev = torch.device("cuda")
    card = card_line()
    log(f"card: {card}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}")
    log(f"kernel build: {cuda_build.build_all():.1f} s ({', '.join(cuda_build.SOURCES)} in parallel)")
    for name, out in cuda_build.build_logs.items():  # each kernel's name, then its registers and spills
        for line in out.splitlines():
            if any(w in line for w in ("entry function", "registers", "spill", "C7515")):
                log(f"  ptxas {name}: {line.strip()}")
    # every kernel really holds warpgroup products: HGMMA in its own function's SASS
    for name, fn in (("edge_kernel", "edge_kernel_f32"), ("edge_kernel", "edge_kernel_mixed"),
                     ("fused_attention", "attention_kernel")):
        n_gmma = cuda_build.sass_count(name, "HGMMA", fn)
        log(f"  SASS of {name}, {fn}: {n_gmma} HGMMA instructions (cuobjdump -sass)")
        if n_gmma == 0:
            log(f"FAIL: {fn} was built without warpgroup products")
            return 1

    # ---- the main path's model, and the inputs its attentions receive ----
    bundle = load_model_bundle(CONFIG, CHECKPOINT, device=dev)
    model = bundle.model
    train_cfg, _, model_cfg = load_configs(CONFIG)
    preprocess = train_cfg["preprocess_config"]
    scene, grasp = scene_clouds()
    proc_agent = DiffusionEdfAgent([bundle], preprocess, UNPROCESS, preprocess_seed=0)
    scene_p, grasp_p = proc_agent._prep(scene, grasp)
    with torch.no_grad():
        key_ms = model.get_key_pcd_multiscale(pad_pointcloud(scene_p, bundle.n_scene_pad, dev))
        query = model.get_query_pcd(pad_pointcloud(grasp_p, bundle.n_grasp_pad, dev))
    tf = model.score_head.key_tensor_field
    # dense (null-radius) scales attend every point; radius scales their cap
    K = sum(min(getattr(getattr(tf, f"parser_{n}"), "k", pts.n), pts.n) for n, pts in enumerate(key_ms))
    nQ = model.query_model.coords.shape[0]
    down = model.key_model.down
    n0 = int(np.ceil(down.pool_ratio[0] * bundle.n_scene_pad))
    K_cap = sum(model_cfg["model_kwargs"]["score_head_kwargs"]["key_tensor_field_kwargs"]["k_multiscale"])
    tga, pga = tf.gnn_block_init.ga, down.pool_layer_0.gnn.ga
    S_tf = tga.sep_act_rad.ch_list[0]
    cases = [  # (label, GraphAttention, rows, edge-scalar width)
        ("tensor_field", tga, N_SEEDS * nQ * K, S_tf),
        ("extractor_pool_0", pga, n0 * min(down.k_pool[0], bundle.n_scene_pad), pga.sep_act_rad.ch_list[0]),
        # every scale at its neighbour cap (a denser scene than this one)
        ("tensor_field_k_cap", tga, N_SEEDS * nQ * K_cap, S_tf),
    ]
    g = torch.Generator(device=dev).manual_seed(0)
    T32 = torch.as_tensor(seed_poses(N_SEEDS), device=dev)
    T32 = torch.cat([T32[:, :4], T32[:, 4:] * 100.0], dim=-1)  # metres -> cm
    time_vec = torch.full((N_SEEDS,), 0.3, device=dev)
    with torch.no_grad():
        real_tf = capture_attention_inputs(tga, lambda: model.score(T32, key_ms, query, time_vec))
        real_pool = capture_attention_inputs(
            pga, lambda: model.get_key_pcd_multiscale(pad_pointcloud(scene_p, bundle.n_scene_pad, dev)))
        nd_cap = N_SEEDS * nQ
        vec = torch.randn(nd_cap, K_cap, 3, generator=g, device=dev)
        cap = (torch.randn(nd_cap, K_cap, tga.plan.dim_in, generator=g, device=dev),
               spherical_harmonics("1x0e+1x1e+1x2e", vec, eps=1e-4),
               torch.randn(nd_cap, K_cap, S_tf, generator=g, device=dev),
               torch.rand(nd_cap, K_cap, generator=g, device=dev) < 0.9,
               -torch.rand(nd_cap, K_cap, generator=g, device=dev), None)
    real = dict(tensor_field=real_tf, extractor_pool_0=real_pool, tensor_field_k_cap=cap)

    # ---- phase 2a: K1 against its plain version, on every row and given the path's masks ----
    k1, k1_all, k2 = {}, {}, {}  # K1 given the path's mask, K1 on every row, K2
    max_err = k2_err = 0.0
    with torch.no_grad():
        for label, ga, rows, S in cases:
            weights, rad = ga._kernel_weights()
            library_ms = library_products_ms(weights, rows, g, dev)
            x1 = torch.randn(rows, ga.plan.dim_in, generator=g, device=dev)
            vec = torch.randn(rows, 3, generator=g, device=dev)
            attr = spherical_harmonics("1x0e+1x1e+1x2e", vec, eps=1e-4)
            es = torch.randn(rows, S, generator=g, device=dev)
            kl, kv = ek.edge_kernel(ga.plan, x1, attr, es, weights, rad)
            torch.cuda.synchronize()
            pl, pv = ek.edge_core_plain(ga.plan, x1, attr, es, weights, rad)
            err = max(float((kl - pl).abs().max()), float((kv - pv).abs().max()))
            ok = err <= KERNEL_GATE and bool(torch.isfinite(kv).all())
            log(f"K1 {label} (every row): rows {rows} width {ga.plan.dim_in} max_abs_err {err:.3g} "
                f"(gate {KERNEL_GATE}) {'ok' if ok else 'FAIL'}")
            if not ok:
                return 1
            max_err = max(max_err, err)
            ms = device_ms(lambda: ek.edge_kernel(ga.plan, x1, attr, es, weights, rad))
            plain_ms = cuda_ms(lambda: ek.edge_core_plain(ga.plan, x1, attr, es, weights, rad))
            # both folded products (3xTF32) against a third of the TF32 peak, the rest against the CUDA cores'
            flops, flops_p1, flops_p2, nbytes = edge_work(ga, rows, S)
            bound_ms, bound_by = bound(flops, nbytes, 0.0, flops_p1 + flops_p2)
            log(f"K1 {label} (every row): kernel {ms:.4f} ms of device time, plain {plain_ms:.4f} ms, library (two "
                f"matmuls) {library_ms:.4f} ms, bound {bound_ms:.4f} ms by {bound_by} ({flops / 1e9:.2f} GFLOP, "
                f"{nbytes / 1e6:.2f} MB; {bound(flops, nbytes)[0]:.4f} ms with the products at the CUDA cores' f32 "
                f"peak); {ms / library_ms:.2f} x the library call, {bound_ms / ms:.3f} of its bound")
            k1_all[label] = dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms, bound_ms=bound_ms, bound_by=bound_by)

            # given the mask, on the inputs the model hands the attention; the dropped rows exactly 0
            msg, m_attr, m_sc, mask = real[label][:4]
            if mask.numel() != rows:
                log(f"FAIL: the model hands {label} {mask.numel()} slots, not {rows}")
                return 1
            flat = [a.reshape(rows, -1) for a in (msg, m_attr, m_sc)]
            for variant, m in (("the path's mask", mask),) + stress_masks(mask):
                keep = m.reshape(-1)
                ml, mv = ek.edge_kernel(ga.plan, *flat, weights, rad, mask=keep)
                torch.cuda.synchronize()
                ql, qv = ek.edge_core_plain(ga.plan, *flat, weights, rad, mask=keep)
                err = max(float((ml - ql).abs().max()), float((mv - qv).abs().max()))
                zeros = float(ml[~keep].abs().sum()) == 0.0 and float(mv[~keep].abs().sum()) == 0.0
                valid, tiles, fill = fa.tile_stats(m)
                ok = err <= KERNEL_GATE and zeros and bool(torch.isfinite(mv).all() and torch.isfinite(ml).all())
                log(f"K1 {label} ({variant}): {valid} of {rows} rows valid, {tiles} tiles of 64 at fill {fill:.3f} "
                    f"(grid {-(-rows // 64)}), max_abs_err {err:.3g} (gate {KERNEL_GATE}), {rows - valid} dropped "
                    f"rows exactly 0 {'ok' if ok else 'FAIL'}")
                if not ok:
                    return 1
                max_err = max(max_err, err)
            keep = mask.reshape(-1)
            valid, tiles, fill = fa.tile_stats(mask)
            parts = device_ms(lambda: ek.edge_kernel(ga.plan, *flat, weights, rad, mask=keep), by_name=True)
            ms = sum(parts.values())
            compact_ms = sum(t for n, t in parts.items() if "compact_kernel" in n)
            # every row dropped: the compaction, then every block writes its range's zeros and leaves
            empty_ms = device_ms(lambda: ek.edge_kernel(ga.plan, *flat, weights, rad, mask=torch.zeros_like(keep)))
            plain_ms = cuda_ms(lambda: ek.edge_core_plain(ga.plan, *flat, weights, rad, mask=keep))
            # the same two matmuls on as many rows as the mask keeps: the library on the work K1 does
            library_valid_ms = library_products_ms(weights, valid, g, dev)
            flops, flops_p1, flops_p2, nbytes = edge_work(ga, rows, S, valid=valid)
            bound_ms, bound_by = bound(flops, nbytes, 0.0, flops_p1 + flops_p2)
            log(f"K1 {label} (the path's mask): kernel {ms:.4f} ms of device time (compaction included), "
                f"{valid} valid rows in {tiles} tiles, plain {plain_ms:.4f} ms, library (two matmuls) on every row "
                f"{library_ms:.4f} ms, on {valid} rows {library_valid_ms:.4f} ms, bound {bound_ms:.4f} ms by "
                f"{bound_by} ({flops / 1e9:.2f} GFLOP on the valid rows, {nbytes / 1e6:.2f} MB); {ms / library_ms:.2f} "
                f"x the library call on every row, {ms / library_valid_ms:.2f} x on the valid rows, "
                f"{bound_ms / ms:.3f} of its bound; the compaction {compact_ms:.4f} ms of it; with every row dropped "
                f"{empty_ms:.4f} ms")
            k1[label] = dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms, library_valid_rows_ms=library_valid_ms,
                             bound_ms=bound_ms, bound_by=bound_by, rows=rows, valid_rows=valid)
            del msg, m_attr, m_sc, flat, ml, mv, ql, qv

            # ---- phase 2b: the mixed bfloat16 mode at the same shapes, every row ----
            xb, wb = x1.to(torch.bfloat16), ek.weights_bf16(weights)
            bl, bv = ek.edge_kernel(ga.plan, xb, attr, es, wb, rad)
            torch.cuda.synchronize()
            ql, qv = ek.edge_core_plain(ga.plan, xb, attr, es, wb, rad)
            err_l = float((bl - ql).abs().max())
            err_v = float((bv.float() - qv.float()).abs().max()) / float(qv.float().abs().max())
            off_f32 = float((bv.float() - pv).abs().max()) / float(pv.abs().max())
            ok = (err_l <= BF16_LOGIT_GATE and err_v <= BF16_VAL_GATE and bl.dtype == torch.float32
                  and bv.dtype == torch.bfloat16 and bool(torch.isfinite(bv.float()).all()))
            log(f"K2-bf16 {label}: rows {rows} width {ga.plan.dim_in} logits max_abs_err {err_l:.3g} (gate "
                f"{BF16_LOGIT_GATE}; max|logits| {float(ql.abs().max()):.3g}), val {err_v:.3g} of max|val| (gate "
                f"{BF16_VAL_GATE}); val is {off_f32:.3g} of max|val| off the f32 kernel's {'ok' if ok else 'FAIL'}")
            if not ok:
                return 1
            k2_err = max(k2_err, err_l, err_v)
            ms = device_ms(lambda: ek.edge_kernel(ga.plan, xb, attr, es, wb, rad))
            event_ms = cuda_ms(lambda: ek.edge_kernel(ga.plan, xb, attr, es, wb, rad))
            plain_ms = cuda_ms(lambda: ek.edge_core_plain(ga.plan, xb, attr, es, wb, rad))
            library_ms = library_products_ms(wb, rows, g, dev, mixed=True)
            flops, flops_p1, flops_p2, nbytes = edge_work(ga, rows, S, mixed=True)
            # Y1 . W_av against the bf16 peak, Y2 . W2 (3xTF32) against a third of the TF32 peak, the rest
            # against the CUDA cores' f32 peak
            bound_ms, bound_by = bound(flops, nbytes, flops_p1, flops_p2)
            log(f"K2-bf16 {label}: kernel {ms:.4f} ms of device time ({event_ms:.4f} ms between events, host "
                f"included), plain {plain_ms:.4f} ms, library (two matmuls, the first in bf16) {library_ms:.4f} ms, "
                f"bound {bound_ms:.4f} ms by {bound_by} ({flops_p1 / 1e9:.2f} GFLOP at the bf16 peak, "
                f"{flops_p2 / 1e9:.2f} at a third of the TF32 peak, {(flops - flops_p1 - flops_p2) / 1e9:.2f} at "
                f"the f32 peak, {nbytes / 1e6:.2f} MB); {ms / library_ms:.2f} x the library call, "
                f"{bound_ms / ms:.3f} of its bound, {ms / k1_all[label]['ms']:.2f} x K1 on every row")
            k2[label] = dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms, bound_ms=bound_ms, bound_by=bound_by)
            del xb, bl, bv, ql, qv
            del x1, attr, es, kl, kv, pl, pv

    # ---- phase 2c: K3 against its plain version on the inputs the model hands it ----
    k3 = {}
    k3_err = 0.0
    with torch.no_grad():
        for label, ga, (msg, attr, sc, mask, pre, post) in (
                ("tensor_field", tga, real_tf), ("extractor_pool_0", pga, real_pool), ("tensor_field_k_cap", tga, cap)):
            nd, k = mask.shape
            mask = mask.clone()
            mask[0] = mask[nd // 2] = False  # rows with every slot masked
            synth_post = torch.rand(nd, k, generator=g, device=dev)
            weights, rad = ga._kernel_weights()
            hoc = _head_of_col(ga.irreps_head, ga.H, ga.irreps_attn.dim)
            variants = [(f"the path's mask, {v}", mask, p, q) for v, p, q in (
                ("as given", pre, post), ("no pre, no post", None, None),
                ("pre and post", pre if pre is not None else -synth_post, synth_post))]
            variants += [(v, m, pre, post) for v, m in stress_masks(mask)]
            for variant, m, p, q in variants:
                args = (ga.plan, hoc, msg, attr, sc, m, p, q, weights, rad)
                out = fa.fused_attention(*args)
                torch.cuda.synchronize()
                ref = fa.fused_attention_plain(*args)
                err = float((out - ref).abs().max())
                empty = ~m.any(dim=1)
                valid, tiles, fill = fa.tile_stats(m)
                ok = (err <= KERNEL_GATE and bool(torch.isfinite(out).all())
                      and (not bool(empty.any()) or float(out[empty].abs().max()) == 0.0))
                log(f"K3 {label} ({variant}): Nd {nd} K {k} width {ga.plan.dim_in}, {valid} of {nd * k} slots "
                    f"valid, {tiles} tiles of 64 at fill {fill:.3f} (grid {-(-nd * k // 64)}), max_abs_err {err:.3g} "
                    f"(gate {KERNEL_GATE}), {int(empty.sum())} all-masked rows exactly 0 {'ok' if ok else 'FAIL'}")
                if not ok:
                    return 1
                k3_err = max(k3_err, err)
            args = (ga.plan, hoc, msg, attr, sc, mask, pre, post, weights, rad)
            ms = device_ms(lambda: fa.fused_attention(*args))
            event_ms = cuda_ms(lambda: fa.fused_attention(*args))
            plain_ms = cuda_ms(lambda: fa.fused_attention_plain(*args))
            library_ms = library_products_ms(weights, nd * k, g, dev)
            library_valid_ms = library_products_ms(weights, int(mask.sum()), g, dev)
            kw = dict(edge_pre_attn_logit=pre, edge_post_attn=post)
            impl_ms = {}
            for impl in ("kernel", "fused"):
                ga.edge_impl = impl
                impl_ms[impl] = cuda_ms(lambda: ga(msg, attr, sc, mask, **kw))
            ga.edge_impl = None
            # bound_ms counts what this mask needs, which is what the kernel computes; its two folded
            # products (3xTF32) against a third of the TF32 peak, the rest against the CUDA cores' f32 peak
            valid, tiles, fill = fa.tile_stats(mask)
            flops, flops_tc, nbytes = attention_work(ga, nd, k, sc.shape[-1], valid, pre is not None, post is not None)
            bound_ms, bound_by = bound(flops, nbytes, 0.0, flops_tc)
            cuda_core_ms, _ = bound(flops, nbytes)
            log(f"K3 {label}: kernel {ms:.4f} ms of device time ({event_ms:.4f} ms between events, host included; "
                f"K1 given the path's mask {k1[label]['ms']:.4f}, on every slot {k1_all[label]['ms']:.4f}), {valid} "
                f"valid slots in {tiles} tiles at fill {fill:.3f}, "
                f"plain {plain_ms:.4f} ms, library (two matmuls) on every slot {library_ms:.4f} ms, on {valid} "
                f"slots {library_valid_ms:.4f} ms, "
                f"bound {bound_ms:.4f} ms by {bound_by} ({flops / 1e9:.2f} GFLOP on the valid slots, {nbytes / 1e6:.2f} "
                f"MB; {cuda_core_ms:.4f} ms with the products at the CUDA cores' f32 peak); whole GraphAttention: "
                f"K1 + PyTorch softmax tail {impl_ms['kernel']:.4f} ms, K3 {impl_ms['fused']:.4f} ms")
            log(f"K3 {label}: {ms / library_ms:.2f} x the library call on every slot, {ms / library_valid_ms:.2f} x "
                f"on the valid slots, {bound_ms / ms:.3f} of its bound, {ms / k1[label]['ms']:.2f} x K1 given the "
                f"path's mask")
            k3[label] = dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms, library_valid_rows_ms=library_valid_ms,
                             bound_ms=bound_ms, bound_by=bound_by)
    del real_tf, real_pool, cap

    # ---- phase 3: the first path, one pick_lowres stage on the default edge_impl ----
    Ts_init = seed_poses(N_SEEDS)

    def lowres_agent():
        return DiffusionEdfAgent([bundle], preprocess, UNPROCESS, preprocess_seed=0)

    def gen(seed):
        return torch.Generator(device=dev).manual_seed(seed)

    lowres_agent().sample(scene, grasp, Ts_init[:2], generator=gen(9), record_trajectory=False,
                          **dict(SCHEDULE, N_steps_list=[[1, 1]]))  # warm-up
    agent = lowres_agent()
    reset_counters()
    traj, _, _, info = agent.sample(scene, grasp, Ts_init, generator=gen(1), **SCHEDULE)
    torch.cuda.synchronize()
    count1 = counters()
    launches = count1["edge_kernel"]
    steps = info["steps"][0]
    log(f"main path: {N_SEEDS} seeds x {steps} steps, extract {info['extract_s'][0] * 1e3:.1f} ms, "
        f"rollout {info['rollout_s'][0] * 1e3:.1f} ms, launches {count1}")
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
    traj_p, _, _, info_p = lowres_agent().sample(scene, grasp, Ts_init, generator=gen(1), **SCHEDULE)
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
        agent.sample(scene, grasp, seed_poses(20, seed=10 + i), record_trajectory=False, generator=gen(i), **SCHEDULE)
        lat.append(time.perf_counter() - t)
    log(f"20-seed requests: p50 latency {np.median(lat) * 1e3:.1f} ms over {len(lat)} "
        f"(min {min(lat) * 1e3:.1f}, max {max(lat) * 1e3:.1f})")

    # ---- phase 4: the whole pick request on the fused attention kernel ----
    highres = load_model_bundle(os.path.join(CONFIGS, "pick_highres"), os.path.join(CHECKPOINTS, "pick_highres.npz"),
                                device=dev)
    critic = load_model_bundle(os.path.join(CONFIGS, "pick_ebm"), os.path.join(CHECKPOINTS, "pick_ebm.npz"),
                               device=dev)
    bundles = (bundle, highres, critic)

    def set_impl(impl):
        for b in bundles:
            b.model.set_edge_impl(impl)

    def pick_agent():
        return DiffusionEdfAgent([bundle, highres], preprocess, UNPROCESS, preprocess_seed=0, critic=critic)

    n_attn = [sum(1 for m in b.model.key_model.modules() if type(m).__name__ == "GraphAttention") for b in bundles]
    n_total = sum(PICK_REQUEST["N_steps_list"][0]) + sum(PICK_REQUEST["N_steps_list"][1])
    expected = n_total + sum(n_attn) + 1  # a field a step, every extractor attention, the critic's field
    set_impl("fused")
    short = dict(PICK_REQUEST, N_steps_list=[[1, 1], [1, 1, 1]])
    pick_agent().sample(scene, grasp, Ts_init[:2], generator=gen(9), record_trajectory=False, **short)  # warm-up
    reset_counters()
    traj_f, _, _, info_f = pick_agent().sample(scene, grasp, Ts_init, generator=gen(1), **PICK_REQUEST)
    torch.cuda.synchronize()
    count4 = counters()
    log(f"pick request (fused): {N_SEEDS} seeds, steps {info_f['steps']}, extract "
        f"{[round(s * 1e3, 1) for s in info_f['extract_s']]} ms, rollout "
        f"{[round(s * 1e3, 1) for s in info_f['rollout_s']]} ms, critic {info_f['critic_s'] * 1e3:.1f} ms, "
        f"launches {count4} (expected fused_attention {expected}: {n_total} steps + {n_attn} extractor attentions + 1)")
    if count4["fused_attention"] != expected or count4["edge_kernel"] != 0 or count4["edge_kernel_bf16"] != 0:
        log("FAIL: the pick request did not run through the fused attention kernel alone")
        return 1
    e_f = info_f["energy"]
    final_f = traj_f[-1]
    if not (np.isfinite(traj_f).all() and np.isfinite(e_f).all() and traj_f.shape == (n_total + 2, N_SEEDS, 7)
            and e_f.shape == (N_SEEDS,) and np.all(np.diff(e_f) >= 0)
            and np.allclose(np.linalg.norm(final_f[:, :4], axis=-1), 1.0, atol=1e-4)):
        log("FAIL: poses or energies not finite, of the wrong shape, unsorted, or with non-unit quaternions")
        return 1
    with torch.no_grad():  # the energies are the critic's energies of the returned final poses
        cm = critic.model
        ckey = cm.get_key_pcd_multiscale(pad_pointcloud(scene_p, critic.n_scene_pad, dev))
        cq = cm.get_query_pcd(pad_pointcloud(grasp_p, critic.n_grasp_pad, dev))
        again = cm.energy(torch.as_tensor(final_f, device=dev), ckey, cq, torch.ones(N_SEEDS, device=dev)).cpu().numpy()
    e_err = float(np.abs(again - e_f).max())
    log(f"pick request (fused): energies {e_f[0]:.5f} .. {e_f[-1]:.5f} ascending; recomputed on the returned poses "
        f"within {e_err:.3g}")
    if not e_err <= 1e-4 * max(1.0, float(np.abs(e_f).max())):
        log("FAIL: info['energy'] is not the critic's energy of the returned poses")
        return 1

    set_impl("plain")
    traj_q, _, _, info_q = pick_agent().sample(scene, grasp, Ts_init, generator=gen(1), **PICK_REQUEST)
    set_impl(None)
    T0 = np.concatenate([Ts_init[:, :4], Ts_init[:, 4:] * np.float32(100.0)], axis=-1)
    of, oq = unsort(traj_f, T0), unsort(traj_q, T0)
    pose_drift = float(np.abs(traj_f[-1][of] - traj_q[-1][oq]).max())
    ef_seed, eq_seed = info_f["energy"][of], info_q["energy"][oq]  # energies in the order of the seeds
    e_drift = float(np.abs(ef_seed - eq_seed).max())
    # the seeds the two requests rank first; a swap counts only where plain's energies differ by more than the gate
    top_f, top_q = ([int(np.flatnonzero(o == c)[0]) for c in range(5)] for o in (of, oq))
    same_top = all(a == b or abs(eq_seed[a] - eq_seed[b]) <= ENERGY_GATE for a, b in zip(top_f, top_q))
    log(f"pick request fused vs plain: final-pose drift {pose_drift:.3g} (gate {POSE_GATE}), energy drift per seed "
        f"{e_drift:.3g} (gate {ENERGY_GATE}), top-5 seeds {top_f} vs {top_q}; plain rollout "
        f"{[round(s * 1e3, 1) for s in info_q['rollout_s']]} ms, critic {info_q['critic_s'] * 1e3:.1f} ms")
    if not (pose_drift <= POSE_GATE and e_drift <= ENERGY_GATE and same_top):
        log("FAIL: the fused pick request drifts from the plain request")
        return 1

    # ---- phase 5: the lowres stage on the mixed bfloat16 edge kernel ----
    def lowres_rollout(b, impl, hooks=(), schedule=SCHEDULE, plain_mixed=False):
        """``plain_mixed``: every edge-kernel call runs the kernel's plain version instead, so
        ``"kernel_bf16"`` becomes the plain path that rounds where the kernel rounds."""
        b.model.set_edge_impl(impl)
        attention.edge_kernel = ek.edge_core_plain if plain_mixed else ek.edge_kernel
        handles = [m.register_forward_pre_hook(h) for h in hooks for m in b.model.modules()
                   if type(m).__name__ == "GraphAttention"]
        try:
            a = DiffusionEdfAgent([b], preprocess, UNPROCESS, preprocess_seed=0)
            out = a.sample(scene, grasp, Ts_init, generator=gen(1), **schedule)
            torch.cuda.synchronize()
        finally:
            for h in handles:
                h.remove()
            attention.edge_kernel = ek.edge_kernel
            b.model.set_edge_impl(None)
        return out[0], out[3]

    def whole_score(impl, plain_mixed=False):
        """One score evaluation of the whole lowres model, extraction included."""
        model.set_edge_impl(impl)
        attention.edge_kernel = ek.edge_core_plain if plain_mixed else ek.edge_kernel
        try:
            with torch.no_grad():
                out = model(T32, pad_pointcloud(scene_p, bundle.n_scene_pad, dev),
                            pad_pointcloud(grasp_p, bundle.n_grasp_pad, dev), time_vec)
        finally:
            attention.edge_kernel = ek.edge_kernel
            model.set_edge_impl(None)
        return torch.cat(list(out), dim=-1)

    def drift_stats(a, ref):
        per_seed = np.abs(a[-1] - ref[-1]).max(axis=1)
        return float(per_seed.max()), float(np.median(per_seed))

    def round_message(_mod, args):  # the least any bf16 mode does: round the message, nothing else
        return (args[0].to(torch.bfloat16).to(args[0].dtype),) + tuple(args[1:])

    lowres_rollout(bundle, "kernel_bf16")  # warm-up
    reset_counters()
    traj_b, info_b = lowres_rollout(bundle, "kernel_bf16")
    count5 = counters()
    drift_b, median_b = drift_stats(traj_b, traj_p)
    drift_m, median_m = drift_stats(lowres_rollout(bundle, "plain", hooks=(round_message,))[0], traj_p)
    log(f"lowres stage (kernel_bf16), shipped checkpoint: rollout {info_b['rollout_s'][0] * 1e3 / steps:.3f} ms per "
        f"step, launches {count5}, final-pose drift vs the f32 plain rollout max {drift_b:.3g} median per seed "
        f"{median_b:.3g}; the plain path with only its message rounded to bf16 drifts max {drift_m:.3g} median "
        f"{median_m:.3g}")
    if not (np.isfinite(traj_b).all() and count5["edge_kernel_bf16"] > 0 and count5["edge_kernel"] == 0):
        log("FAIL: the bf16 rollout is not finite or did not run its kernel")
        return 1
    cold = dict(SCHEDULE, temperatures_list=[[0.0, 0.0]])  # no noise: what drifts is the score field alone
    traj_bc = lowres_rollout(bundle, "kernel_bf16", schedule=cold)[0]
    drift_c, median_c = drift_stats(traj_bc, lowres_rollout(bundle, "plain", schedule=cold)[0])
    log(f"lowres stage (kernel_bf16), shipped checkpoint at temperature 0: final-pose drift vs the f32 plain rollout "
        f"max {drift_c:.3g} median per seed {median_c:.3g}")
    # the gates on the real weights, against the kernel's plain version in every GraphAttention: one score
    # evaluation of the whole model, and the same rollouts (which amplify a difference between two score
    # fields: the float32 kernel's 4.8e-6 per call becomes 1.5e-4 of drift, so their gate is wide)
    reset_counters()
    sc_b, sc_q, sc_p = whole_score("kernel_bf16"), whole_score("kernel_bf16", plain_mixed=True), whole_score("plain")
    if counters()["edge_kernel_bf16"] != 18 or counters()["edge_kernel"] != 0:
        log(f"FAIL: one score evaluation should launch the bf16 kernel 18 times: {counters()}")
        return 1
    sc_err = float((sc_b - sc_q).abs().max() / sc_q.abs().max())
    log(f"score (kernel_bf16), shipped checkpoint, extraction included, {N_SEEDS} poses: {sc_err:.3g} of max|score| "
        f"off the plain version that rounds at the same places (gate {BF16_SCORE_GATE}), "
        f"{float((sc_b - sc_p).abs().max() / sc_p.abs().max()):.3g} off the f32 plain version")
    if not (sc_err <= BF16_SCORE_GATE and bool(torch.isfinite(sc_b).all())):
        log("FAIL: the bf16 kernel's score differs from the plain version that rounds at the same places")
        return 1
    reset_counters()
    same = [drift_stats(t, lowres_rollout(bundle, "kernel_bf16", schedule=sch, plain_mixed=True)[0])
            for t, sch in ((traj_b, SCHEDULE), (traj_bc, cold))]
    log(f"lowres stage (kernel_bf16), shipped checkpoint vs the plain rollout that rounds at the same places: "
        f"final-pose drift max {same[0][0]:.3g} median per seed {same[0][1]:.3g}, at temperature 0 max "
        f"{same[1][0]:.3g} median {same[1][1]:.3g} (gate {BF16_SAME_ROUNDING_GATE} on both); launches {counters()}")
    if not (max(d for d, _ in same) <= BF16_SAME_ROUNDING_GATE and sum(counters().values()) == 0):
        log("FAIL: the bf16 kernel's rollout drifts from the plain rollout that rounds at the same places")
        return 1
    fresh = load_model_bundle(CONFIG, None, device=dev, init_seed=0)  # seeded random weights, as bench.py's model
    traj_r, _ = lowres_rollout(fresh, "plain")
    drift_r, median_r = drift_stats(lowres_rollout(fresh, "kernel_bf16")[0], traj_r)
    log(f"lowres stage (kernel_bf16), seeded random weights: final-pose drift vs plain max {drift_r:.3g} median per "
        f"seed {median_r:.3g} (gate {BF16_POSE_GATE}); poses moved {float(np.abs(traj_r[-1] - traj_r[0]).max()):.3g}")
    if not drift_r <= BF16_POSE_GATE:
        log("FAIL: the bf16 rollout drifts from the plain rollout")
        return 1
    del fresh

    # ---- phase 6: one score step under each edge_impl ----
    with torch.no_grad():
        for impl in EDGE_IMPLS + EDGE_IMPLS[::-1]:  # in turns, there and back
            model.set_edge_impl(impl)
            wall, busy, n_kernels, _ = step_profile(model, T32, key_ms, query, time_vec)
            log(f"score step ({impl}): wall {wall:.3f} ms, device busy {busy:.3f} ms, idle share "
                f"{1 - busy / wall:.3f}, kernels {n_kernels:.0f}")
    model.set_edge_impl(None)

    # ---- phase 7: one request at the server's full schedule ----
    n_server = sum(map(sum, SERVER_REQUEST["N_steps_list"]))
    for impl in (None, "fused"):
        set_impl(impl)
        t = time.perf_counter()
        traj_s, _, _, info_s = pick_agent().sample(scene, grasp, seed_poses(20, seed=30), generator=gen(3),
                                                   record_trajectory=False, **SERVER_REQUEST)
        torch.cuda.synchronize()
        total = time.perf_counter() - t
        log(f"server request ({impl or 'default: kernel'}): 20 seeds, steps {info_s['steps']}, {total * 1e3:.1f} ms "
            f"(rollouts {[round(s * 1e3, 1) for s in info_s['rollout_s']]} ms, "
            f"{sum(info_s['rollout_s']) * 1e3 / n_server:.3f} ms per step, extract "
            f"{[round(s * 1e3, 1) for s in info_s['extract_s']]} ms, critic {info_s['critic_s'] * 1e3:.1f} ms)")
        if not (np.isfinite(traj_s).all() and np.all(np.diff(info_s["energy"]) >= 0)):
            log("FAIL: the server request returned non-finite poses or unsorted energies")
            return 1
    set_impl(None)
    log(f"chip_smoke: {time.perf_counter() - t_start:.1f} s in all")

    src = "diffusion_edf_tpu_torch/csrc/"
    tfk, tf3 = k1["tensor_field"], k3["tensor_field"]  # K1 given the tensor field's own mask, as the path runs it
    kernels = [
        dict(name="edge_kernel", route="cuda", source=src + "edge_kernel.cu",
             replaces="diffusion_edf_tpu/nn/edge_kernel.py:477", launches=launches, max_abs_err=max_err, **tfk),
        dict(name="edge_kernel_bf16", route="cuda", source=src + "edge_kernel.cu",
             replaces="diffusion_edf_tpu/nn/edge_kernel.py:568", launches=count5["edge_kernel_bf16"],
             max_abs_err=k2_err, **k2["tensor_field"]),
        dict(name="fused_attention", route="cuda", source=src + "fused_attention.cu",
             replaces="diffusion_edf_tpu/nn/fused_attention.py:331", launches=count4["fused_attention"],
             max_abs_err=k3_err, **tf3),
    ]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
