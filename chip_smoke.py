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
2d. the place models' shapes (run after 2c): the float32 edge kernel given
   the mask and the fused attention kernel against their plain versions
   (3e-4, dropped rows and slots exactly 0) on the inputs that the
   ``place_lowres`` key tensor field (32 seeds x 52 keypoints x K slots) and
   the keypoint extractor's ``tensor_field`` (52 query points) hand them,
   with the clouds prepared by the server's ``preprocess.yaml``, and at the
   stress masks; rows, kept rows, tiles, device time, library yardsticks,
   bound and the plain version's peak memory;
2e. the sapien key field (run after 2d): the float32 edge kernel given the
   mask and the fused attention kernel against their plain versions (3e-4,
   and 3e-4 of each output's max|plain|; dropped rows and slots exactly 0,
   and at the stress masks) on the inputs that the ``sapien/pick_lowres``
   model's key field (32 seeds x 2 query points x its 103 keypoints) hands
   its attention, with the keypoints' own weights as post-attention
   weights: on the shipped checkpoint (whose weights are 0.5 at every
   keypoint) and on seeded weights, whose spread must move the plain
   attention by ``POST_WITNESS_GATE`` of its max when each slot's weight is
   replaced by their mean;
2f. the transpose of ``tp.apply_dtp_cm``'s and ``IrrepsLinear``'s
   constant-table gathers (``csrc/gather.cu``, ``gather_cases``) at the
   pick train step's shapes against its plain version and against
   index_select's own backward (zeros + index_add_, the yardstick, on the
   gradient as the caller hands it), each within float32 rounding of a
   float64 sum; device time of the kernel and of the yardstick, and the
   bytes bound (of the kept positions, the only ones the kernel reads);
7. one pick request at the server's full schedule (400 + 500 steps, 20
   seeds) on the default ``edge_impl`` and on ``"fused"``, each timed once;
8. the whole place request: ``place_lowres`` (100 steps), ``place_highres``
   (100 steps shaped as the server's second stage) and the ``place_ebm``
   critic from the shipped checkpoints, 32 seeds, on the default
   ``edge_impl`` and on ``"fused"``, each against ``"plain"`` with the pick
   request's gates, with the served preprocessing; the keypoints each stage
   keeps after the bbox crop (none fails), launch counters, the drift per
   stage and per seed with a witness (a fourth run, plain from seeds moved
   by 1e-6, and kernel against fused) that shows which side departs, and
   the place score step's profile;
9. serving: ``AgentService`` with the pick and place cascades and their
   critics, warmed up with the served schedules (``warmup_service``),
   behind ``run_server`` on a free local port: every
   endpoint for pick and place, four concurrent place ``/denoise`` requests
   through one batched dispatch with the edge-kernel launches of one
   request's Langevin steps, ``sample_batch`` of two requests against two
   ``sample`` calls, the p50 latency of a served place request and the wall
   time of four batched requests against four sequential ones;
10. training on the card (``DiffusionEdfTrainer``, ``device="cuda"``) on 8
   synthetic mug demos, from the shipped checkpoints, through the trainer's
   compiled step (one CUDA graph a demo shape, replayed) unless said: (a)
   one ``pick_lowres`` step at full width on the card and on the CPU on the
   same draws and weights, dropout off, loss and every gradient within
   ``TRAIN_GATES`` (and the CPU step in float64 beside them, as a witness of
   float32's spread);
   (b) 40 ``pick_lowres`` steps with dropout on: every loss and gradient
   norm finite, the loss of 8 fixed evaluation batches at most
   ``EVAL_RISE_GATE`` times its start, ms a step, device busy and idle share
   and kernels a step from ``torch.profiler`` over 10 more steps, peak
   memory, and no launch of K1, K2 or K3 while training (autograd routes
   every attention to the plain path) but some of the gather transpose
   (``nn/gather.py``, in every backward of ``tp.apply_dtp_cm``); (c) the
   ``pick_ebm`` critic, one step card against CPU, then 20 steps (second
   order through ``ebm_score``, rank loss): finite, pair accuracy, ms a
   step, peak memory, launches as in (b); (d) the
   trained ``pick_lowres`` weights exported, loaded by ``load_model_bundle``
   and sampled on the default ``edge_impl`` (K1, once a step) and on
   ``"plain"`` with the same seeds and noise, within ``POSE_GATE``, and the
   trainer's own model (its derived weights cached before training) on K1
   within ``RUNTIME_POSE_GATE`` of the export on K1; (e) the training
   command line for one epoch on two demos, as a subprocess, whose
   checkpoint ``restore`` reads; (f) for each of ``TRAIN_RUNTIME_CASES``
   (``pick_lowres`` 8 steps, ``pick_ebm`` 3, ``place_lowres`` 2), one epoch
   from the shipped checkpoint with one generator seed and demo order,
   ``TRAIN_EAGER_RUNS`` times eagerly (``use_runtime=False``) and once
   through the runtime: the captured epoch's losses, parameters, EMA and
   optimizer state (their norms), each no farther from the nearest eager
   run than twice the largest difference between two eager runs or
   ``TRAIN_GATES`` (``spread_gate``), the step counts exact, one
   entry and none new in a second epoch, no launch of K1, K2 or K3, the
   gather transpose launched by an eager and by the capturing epoch (its
   launches in each epoch counted; a replay counts none); eager against
   captured ms a step, device busy, idle share, kernels a step, capture
   seconds, graph pool;
11. evaluation: ``diffusion_edf_tpu_torch.eval.evaluate_agent`` on the
   default ``edge_impl`` with the shipped pick cascade (``pick_lowres`` ->
   ``pick_highres``, critic ``pick_ebm_cascade.npz``) and place cascade
   (``place_lowres`` -> ``place_highres``, ``place_ebm_cascade.npz``), each
   with its schedule sweep's winner (``reports/schedule_sweep_pick_r2.json``,
   ``reports/schedule_sweep_place.json``: 400 + 650 steps), on the first
   ``EVAL_DEMOS`` demos of the default split with 10 seeds, as the committed
   JAX reports ``reports/eval_{pick,place}_cascade.json`` were made: the
   report's keys equal the JAX report's, every error finite, K1 launched once
   a step plus once per extractor attention and critic field, and each
   demo's median translation and rotation errors within 1 cm and 5 deg of
   the report's (the success thresholds); per demo the medians, the best
   sample and the seconds;
12. the sapien family: (a) the shipped ``sapien/pick_lowres`` checkpoint
   (``PointAttentiveScoreModel``, config ``configs/sapien/pick_lowres``,
   with which that checkpoint was trained) on one 32-seed, 100-step stage on
   ``"kernel"``, ``"fused"`` and ``"plain"`` with the same seeds and noise,
   each kernel path within 2e-2 of plain in final pose and launched as
   counted (its kernels are held at its key field in 2e); (b) a
   ``sapien/pick_highres`` model
   (``ForwardOnlyFeatureExtractor``, seeded weights: no checkpoint ships),
   one score evaluation on ``"kernel"`` against ``"plain"`` within 1e-3 of
   max|score|;
13. multi-device: two ranks (``multi_device_rank``, spawned) share the one
   card in a gloo process group (nccl refuses two ranks on one GPU; gloo
   stages CUDA tensors through the host), the kernels built by phase 1,
   every path eager (``use_runtime=False``: a CUDA graph cannot hold a gloo
   collective, and the runtime given the gloo mesh must raise, which the
   phase checks for the agent, the scene-sharded score and the
   data-parallel step):
   (a) the ``pick_lowres`` stage of phase 3 with ``DiffusionEdfAgent(mesh=)``,
   its 32 seeds sharded over the ranks, on ``kernel``: final poses within
   ``POSE_GATE`` of phase 3's one-process stage (the same seeds and noise),
   each rank's K1 launches; (b) one score of the shipped ``pick_lowres`` on a
   (data, model) = (1, 2) mesh, its query rows sharded and then its scene
   sharded, on ``kernel``, ``fused`` (query rows only: the scene-sharded path
   must refuse K3) and ``plain``: against this process's replicated score
   within ``KERNEL_GATE`` (the scene-sharded score only where no query row
   is cap-bound; the count is reported), the scene-sharded score on
   ``kernel`` against it on ``plain`` within ``KERNEL_GATE``, kernel launches
   on every rank; (c) three data-parallel ``pick_lowres`` train steps and one
   ``pick_ebm`` step, dropout off, against this process running the same
   steps on the same inputs: each step's loss and the gradients it hands
   its update (``DiffusionEdfTrainer.apply_grads``) within ``TRAIN_GATES``,
   rank 0's parameters and EMA after each step equal to this process's
   update of those gradients (within the gradient gate of each key's
   largest change), the parameters equal on both ranks after the steps;
   (d) one spawned process in a one-rank NCCL group
   (``nccl_capture_rank``): ``reduce_from_shards``, ``all_reduce_max``,
   ``gather_blocks``, the backward of ``copy_to_shards`` and the
   data-parallel step's flat-gradient all-reduce on ``dist.group.WORLD``,
   captured in one ``graphs.Program`` and replayed twice on new inputs,
   exactly equal to the same calls eager (PyTorch's NCCL-under-capture
   path on this card: streams, events, watchdog); the multi-rank captured
   paths run on four cards (``tools/torch_multichip.py``);
14. the model-building tools (``diffusion_edf_tpu_torch/tools/``, each
   through the function a user calls), on the default ``edge_impl``, in
   ``build/smoke_tools``: (a) ``gen_cascade_samples.main`` on the shipped
   pick cascade with the ``reports/schedule_sweep_pick_r2.json`` winner,
   one training demo (demo seed 0) and one held-out demo (500), 16 seeds
   each: the dump's keys, dtypes and shapes those of the JAX tool, its
   errors finite and equal to ``eval.pose_errors`` recomputed, K1 launched
   once a step and once per extractor attention; (b) the ``pick_ebm`` critic
   from ``pick_ebm_cascade.npz`` on those dumps: the held-out energies on
   ``kernel`` and ``fused`` against ``plain`` within ``ENERGY_GATE`` of
   max|E|, the executed sample the same wherever the two lowest plain
   energies differ by more than that, launches counted; three fine-tune
   steps (``make_train_step``, dropout on), twice eagerly and once through
   the tool's compiled step, finite with no launch of K1, K2 or K3, the
   captured steps' losses, parameters and optimizer state held to the
   eager runs as in 10f, eager against captured ms a step, device busy, idle share,
   kernels a step, capture seconds and graph pool; the tool's ``main`` for
   one epoch (its step and held-out energies compiled): the committed
   report's keys, K1 launched by its three evaluations alone, the float16
   export with exactly the shipped key set; (c) ``sweep_schedule.sweep`` with the ``reference``
   and ``low_floor`` candidates on one demo of the default split, 4 seeds:
   the committed report's keys, success in [0, 1], K1's launches per
   candidate; (d) ``train_eval_loop.main`` on ``panda_bowl/pick_lowres``
   warm-started from its checkpoint, one epoch on two synthetic bowl demos,
   an evaluation of one demo x 4 seeds before and after: two curve lines
   with the JAX curve's keys, ``best.json``, the float16 export reloaded,
   K1 launched by the evaluations alone; (e) ``k_truncation_report.main`` at
   full ``pick_lowres`` width, 5 demos x 8 poses: every call site within the
   JAX package's 1 % budget, the committed report's call sites, radii and
   caps, the same destinations a demo; (f) one score of the shipped
   ``panda_bottle/pick_lowres`` and ``panda_bowl/place_lowres``, extraction
   included, ``kernel`` against ``plain`` within ``HIGHRES_SCORE_GATE`` of
   max|score|;
15. the agent's sampling runtime (run after phase 9, before phase 10's
   profiling), with the served preprocessing: (a) one ``pick_lowres`` stage
   (32 seeds x 100 steps) on ``kernel``, ``fused`` and ``plain`` and the
   whole place request on ``kernel``, each through the runtime (its first
   request captures every entry, its second only replays) against the eager
   agent (``use_runtime=False``) with the same generator seed: final poses
   within ``RUNTIME_POSE_GATE`` (or twice the spread of two eager runs, if
   they differ), the critic's energies, and launch counts equal to the
   eager run's; (b) after ``warmup`` with the shapes of the later requests,
   two requests add no entry (``cache_sizes``), with the capture seconds and
   the graph pool's memory of every runtime; (c) one Langevin step of the
   pick and place first stages, eager and captured: wall ms, device busy,
   idle share and kernels a step;
16. one JSON line listing each kernel, then the card line, then the result
   line ``{"ok": true, "device": {...}}``.  A kernel's own keys hold the pick
   tensor field and the launches of the pick path it was first measured on;
   ``by_shape`` holds K1's and K3's records at the pick, place and sapien key
   fields and the keypoint field, ``launches_by_path`` the counts of the
   other paths (per rank on the sharded paths; phase 14's tools by name;
   ``captured_*`` the runtime's replayed requests of phase 15).  The gather
   transpose's ``launches`` are those of 10f's capturing ``pick_lowres``
   epoch, its ``launches_by_path`` those of each training run of phases 10
   and 14, and ``by_shape`` holds phase 2f.

There is no CPU fallback: without a CUDA device the script exits 1.
"""
from __future__ import annotations

import json
import os
import shutil
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
# 40 steps (5 epochs) and not 200 since phases 11-12 came: the script keeps to half its time limit
TRAIN_DEMOS, TRAIN_STEPS, CRITIC_STEPS = 8, 40, 20
# one train step of the same draws on the card and on the CPU, dropout off: (loss, relative; each gradient, of its
# flax key's max |grad|).  Float32 in another summation order (cuBLAS and the card's atomic scatter-adds against
# the CPU's BLAS) through the whole model and its backward.  Seen on an H100: pick_lowres 3.2e-6 and 1.0e-3 / 2.9e-3
# (two runs; at the coarsest scale's LayerNorm bias, a sum over 4 points that cancels; there the card's float32
# gradient sits 1.3e-3 from a float64 CPU run, the CPU's 3.4e-4); pick_ebm 6.0e-8 and 2.2e-5
TRAIN_GATES = (1e-4, 1e-2)
# phase 10f: one epoch a model, eager and through the runtime (model, demos = steps)
TRAIN_RUNTIME_CASES = (("pick_lowres", 8), ("pick_ebm", 3), ("place_lowres", 2))
# eager runs of 10f: their largest pairwise difference is the spread; the captured run's difference to the nearest
# of them is held to twice that or to TRAIN_GATES (train_floor).  Seen on an H100: a 2-step place_lowres run's
# loss 6.91e-6 from the nearest of 4 eager runs, whose spread was 3.34e-6, on losses ~3; its parameters' largest
# element 3.23e-4 from the nearest of 3, spread 1.64e-4 (2 lr is 6e-4: one flipped update of a near-zero gradient)
TRAIN_EAGER_RUNS = 3
EVAL_RISE_GATE = 1.2  # the evaluation loss after TRAIN_STEPS steps from the shipped checkpoint, of the loss before
PLACE_MODELS = ("place_lowres", "place_highres", "place_ebm")
# phase 11: the first demos of the default split with the committed reports' seeds; a demo's median errors against
# the report's, at the success thresholds
EVAL_DEMOS, EVAL_SEEDS = 2, 10
EVAL_TRANS_GATE, EVAL_ROT_GATE = 1.0, 5.0  # cm, deg
SAPIEN_LOWRES = os.path.join(ROOT, "diffusion_edf_tpu_torch", "configs", "sapien", "pick_lowres")
SAPIEN_HIGHRES = os.path.join(ROOT, "diffusion_edf_tpu_torch", "configs", "sapien", "pick_highres")
# phase 2e: K1's and K3's error also of each output's max|plain| (seen on an H100 at the shipped sapien checkpoint:
# 7e-7 to 2e-6; the absolute KERNEL_GATE holds nothing there, where max|plain| is 1.5e-5 to 1.9e-4); and the least
# that replacing every slot's post-attention weight by their mean must move the plain attention, of its max, for
# the seeded weights to fail a K3 that misreads them: ten times the relative gate
REL_KERNEL_GATE = 3e-4
POST_WITNESS_GATE = 10 * REL_KERNEL_GATE
HIGHRES_SCORE_GATE = 1e-3  # one score evaluation of the forward-only model, kernel against plain, of max|score|
MD_WORLD = 2  # phase 13: two ranks on the one card, over gloo (nccl refuses two ranks on one GPU)
# phase 15: the runtime's captured rollout against the eager one, max-abs final pose (the same kernels in the same
# order, so equal unless an op of the path is not deterministic; then twice the spread of two eager runs)
RUNTIME_POSE_GATE = 1e-5


class SmokeFailure(Exception):
    """A check failed; ``main`` prints it and exits 1."""


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


def one_request(T, key_ms, query, time_vec):
    """The ``score`` / ``energy`` arguments of one request, as R = 1: poses
    (nT, 7), the clouds as ``get_key_pcd_multiscale`` / ``get_query_pcd``
    return them, times (nT,)."""
    from diffusion_edf_tpu_torch.data import stack_points

    return T[None], [stack_points([p]) for p in key_ms], stack_points([query]), time_vec[None]


def step_profile(model, T, key_ms, query, time_vec, steps: int = 10, wall_steps: int = 30):
    """(wall ms, device-busy ms, kernels, {kernel name: (launches, device us)})
    per score step of one request (:func:`one_request`'s arguments): the wall
    from an unprofiled loop (the profiler's host tracing slows the step), the
    device numbers from ``torch.profiler``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    args = one_request(T, key_ms, query, time_vec)
    for _ in range(3):
        model.score(*args)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(wall_steps):
        model.score(*args)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / wall_steps
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            model.score(*args)
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


def place_clouds(seed: int = 0):
    """The place task's clouds (metres): the tabletop scene of
    :func:`scene_clouds` and, as the grasp, a mug held by the gripper (a
    4 cm-radius, 10 cm-tall shell 8-18 cm along the gripper's z, inside the
    place models' keypoint bbox of z 8-100 cm)."""
    from diffusion_edf_tpu_torch.train.data import PointCloud

    scene, _ = scene_clouds(seed)
    rng = np.random.default_rng(seed + 100)
    th, z = rng.uniform(0, 2 * np.pi, 256), rng.uniform(0.085, 0.18, 256)
    mug = np.c_[0.04 * np.cos(th), 0.04 * np.sin(th), z].astype(np.float32)
    return scene, PointCloud(mug, rng.uniform(0, 1, (256, 3)).astype(np.float32))


def peak_gb(fn):
    """(result of ``fn()``, the peak device memory it allocated, in GB)."""
    import torch

    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = fn()
    torch.cuda.synchronize()
    return out, (torch.cuda.max_memory_allocated() - base) / 1e9


def capture_seconds(fn):
    """(result of ``fn()``, the seconds that the programs it built spent
    capturing: the ``capture_s`` of its ``graphs.build`` spans)."""
    from diffusion_edf_tpu_torch.utils import profiling

    profiling.drain()
    profiling.record(True)
    try:
        out = fn()
    finally:
        profiling.record(False)
    return out, sum(s.attrs["capture_s"] for s in profiling.drain() if s.name == "graphs.build")


def k1_masked_case(label, ga, captured, g, dev, rel_gate=None):
    """K1 given the mask of ``captured`` (the arguments a GraphAttention
    received) against its plain version, at the path's mask and the stress
    masks (dropped rows exactly 0; with ``rel_gate``, each output's error
    also within ``rel_gate`` of its max|plain|); then, at the path's mask,
    its device time (the compaction apart, and with every row dropped), the
    plain time and peak memory, the library yardsticks and the bound.
    Returns (record, max error)."""
    import torch
    from diffusion_edf_tpu_torch.nn import edge_kernel as ek
    from diffusion_edf_tpu_torch.nn import fused_attention as fa

    msg, attr, sc, mask = captured[:4]
    rows, S = mask.numel(), sc.shape[-1]
    weights, rad = ga._kernel_weights()
    flat = [a.reshape(rows, -1) for a in (msg, attr, sc)]
    max_err, plain_gb = 0.0, 0.0
    for variant, m in (("the path's mask", mask),) + stress_masks(mask):
        keep = m.reshape(-1)
        kl, kv = ek.edge_kernel(ga.plan, *flat, weights, rad, mask=keep)
        torch.cuda.synchronize()
        (ql, qv), gb = peak_gb(lambda: ek.edge_core_plain(ga.plan, *flat, weights, rad, mask=keep))
        plain_gb = max(plain_gb, gb)
        errs = (float((kl - ql).abs().max()), float((kv - qv).abs().max()))
        err, scale = max(errs), (float(ql.abs().max()), float(qv.abs().max()))
        zeros = float(kl[~keep].abs().sum()) == 0.0 and float(kv[~keep].abs().sum()) == 0.0
        valid, tiles, fill = fa.tile_stats(m)
        ok = err <= KERNEL_GATE and zeros and bool(torch.isfinite(kv).all() and torch.isfinite(kl).all())
        if rel_gate is not None:
            ok = ok and all(e <= rel_gate * a for e, a in zip(errs, scale))
        if variant == "the path's mask":
            max_plain = scale
        log(f"K1 {label} ({variant}): {valid} of {rows} rows valid, {tiles} tiles of 64 at fill {fill:.3f} (grid "
            f"{-(-rows // 64)}), max_abs_err {err:.3g} (gate {KERNEL_GATE}), max|plain| logits {scale[0]:.3g} val "
            f"{scale[1]:.3g}" + (f", err of max|plain| logits {errs[0] / max(scale[0], 1e-30):.3g} val "
                                 f"{errs[1] / max(scale[1], 1e-30):.3g} (gate {rel_gate})" if rel_gate else "")
            + f", {rows - valid} dropped rows exactly 0 {'ok' if ok else 'FAIL'}")
        if not ok:
            raise SmokeFailure(f"K1 at {label} ({variant}) disagrees with its plain version")
        max_err = max(max_err, err)
        del kl, kv, ql, qv
    keep = mask.reshape(-1)
    valid, tiles, fill = fa.tile_stats(mask)
    parts = device_ms(lambda: ek.edge_kernel(ga.plan, *flat, weights, rad, mask=keep), by_name=True)
    ms = sum(parts.values())
    compact_ms = sum(t for n, t in parts.items() if "compact_kernel" in n)
    # every row dropped: the compaction, then every block writes its range's zeros and leaves
    empty_ms = device_ms(lambda: ek.edge_kernel(ga.plan, *flat, weights, rad, mask=torch.zeros_like(keep)))
    plain_ms = cuda_ms(lambda: ek.edge_core_plain(ga.plan, *flat, weights, rad, mask=keep), reps=5)
    # the two matmuls on every row, and on as many rows as the mask keeps: the library on the work K1 does
    library_ms = library_products_ms(weights, rows, g, dev)
    library_valid_ms = library_products_ms(weights, valid, g, dev)
    flops, flops_p1, flops_p2, nbytes = edge_work(ga, rows, S, valid=valid)
    bound_ms, bound_by = bound(flops, nbytes, 0.0, flops_p1 + flops_p2)
    log(f"K1 {label} (the path's mask): kernel {ms:.4f} ms of device time (compaction included), {valid} of {rows} "
        f"rows valid in {tiles} tiles ({tiles / 132:.2f} waves of 132 SMs), plain {plain_ms:.4f} ms (peak "
        f"{plain_gb:.2f} GB), library (two matmuls) on every row {library_ms:.4f} ms, on {valid} rows "
        f"{library_valid_ms:.4f} ms, bound {bound_ms:.4f} ms by {bound_by} ({flops / 1e9:.2f} GFLOP on the valid "
        f"rows, {nbytes / 1e6:.2f} MB); {ms / library_ms:.2f} x the library call on every row, "
        f"{ms / library_valid_ms:.2f} x on the valid rows, {bound_ms / ms:.3f} of its bound; the compaction "
        f"{compact_ms:.4f} ms of it; with every row dropped {empty_ms:.4f} ms")
    return dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms, library_valid_rows_ms=library_valid_ms,
                bound_ms=bound_ms, bound_by=bound_by, rows=rows, valid_rows=valid, tiles=tiles,
                plain_peak_gb=plain_gb, max_abs_plain=max_plain), max_err


def k3_case(label, ga, captured, g, dev, k1_ms=None, rel_gate=None):
    """K3 on ``captured`` against its plain version (rows without a valid
    slot exactly 0; with ``rel_gate``, the error also within ``rel_gate`` of
    max|plain|) at the path's mask with its pre-attention logits and
    post-attention weights as given, with neither and with both, and at the
    stress masks; then its device time, the plain time and peak memory, the
    library yardsticks, the bound and the whole GraphAttention on K1 and on
    K3 (``k1_ms``: K1's time at this mask, for the ratio).  Returns (record,
    max error)."""
    import torch
    from diffusion_edf_tpu_torch.nn import fused_attention as fa
    from diffusion_edf_tpu_torch.nn.attention import _head_of_col

    msg, attr, sc, mask, pre, post = captured
    nd, k = mask.shape
    weights, rad = ga._kernel_weights()
    hoc = _head_of_col(ga.irreps_head, ga.H, ga.irreps_attn.dim)
    synth_post = torch.rand(nd, k, generator=g, device=dev)
    variants = [(f"the path's mask, {v}", mask, p, q) for v, p, q in (
        ("as given", pre, post), ("no pre, no post", None, None),
        ("pre and post", pre if pre is not None else -synth_post, synth_post))]
    variants += [(v, m, pre, post) for v, m in stress_masks(mask)]
    max_err, plain_gb = 0.0, 0.0
    for variant, m, p, q in variants:
        args = (ga.plan, hoc, msg, attr, sc, m, p, q, weights, rad)
        out = fa.fused_attention(*args)
        torch.cuda.synchronize()
        ref, gb = peak_gb(lambda: fa.fused_attention_plain(*args))
        plain_gb = max(plain_gb, gb)
        err, scale = float((out - ref).abs().max()), float(ref.abs().max())
        empty = ~m.any(dim=1)
        valid, tiles, fill = fa.tile_stats(m)
        ok = (err <= KERNEL_GATE and bool(torch.isfinite(out).all())
              and (not bool(empty.any()) or float(out[empty].abs().max()) == 0.0))
        if rel_gate is not None:
            ok = ok and err <= rel_gate * scale
        if variant == "the path's mask, as given":
            max_plain = scale
        log(f"K3 {label} ({variant}): Nd {nd} K {k} width {ga.plan.dim_in}, {valid} of {nd * k} slots valid, {tiles} "
            f"tiles of 64 at fill {fill:.3f} (grid {-(-nd * k // 64)}), max_abs_err {err:.3g} (gate {KERNEL_GATE}), "
            f"max|plain| {scale:.3g}" + (f", err of max|plain| {err / max(scale, 1e-30):.3g} (gate {rel_gate})"
                                         if rel_gate else "")
            + f", {int(empty.sum())} all-masked rows exactly 0 {'ok' if ok else 'FAIL'}")
        if not ok:
            raise SmokeFailure(f"K3 at {label} ({variant}) disagrees with its plain version")
        max_err = max(max_err, err)
        del out, ref
    args = (ga.plan, hoc, msg, attr, sc, mask, pre, post, weights, rad)
    valid, tiles, fill = fa.tile_stats(mask)
    ms = device_ms(lambda: fa.fused_attention(*args))
    plain_ms = cuda_ms(lambda: fa.fused_attention_plain(*args), reps=5)
    library_ms = library_products_ms(weights, nd * k, g, dev)
    library_valid_ms = library_products_ms(weights, valid, g, dev)
    kw = dict(edge_pre_attn_logit=pre, edge_post_attn=post)
    impl_ms = {}
    for impl in ("kernel", "fused"):
        ga.edge_impl = impl
        impl_ms[impl] = cuda_ms(lambda: ga(msg, attr, sc, mask, **kw))
    ga.edge_impl = None
    # the work this mask needs, which is what the kernel computes; its two folded products (3xTF32) against a
    # third of the TF32 peak, the rest against the CUDA cores' f32 peak
    flops, flops_tc, nbytes = attention_work(ga, nd, k, sc.shape[-1], valid, pre is not None, post is not None)
    bound_ms, bound_by = bound(flops, nbytes, 0.0, flops_tc)
    log(f"K3 {label}: kernel {ms:.4f} ms of device time, {valid} valid slots in {tiles} tiles ({tiles / 132:.2f} "
        f"waves), plain {plain_ms:.4f} ms (peak {plain_gb:.2f} GB), library (two matmuls) on every slot "
        f"{library_ms:.4f} ms, on {valid} slots {library_valid_ms:.4f} ms, bound {bound_ms:.4f} ms by {bound_by} "
        f"({flops / 1e9:.2f} GFLOP on the valid slots, {nbytes / 1e6:.2f} MB); {ms / library_ms:.2f} x the library "
        f"on every slot, {ms / library_valid_ms:.2f} x on the valid slots, {bound_ms / ms:.3f} of its bound"
        + (f", {ms / k1_ms:.2f} x K1 given the mask" if k1_ms else "")
        + f"; whole GraphAttention: K1 + PyTorch softmax tail {impl_ms['kernel']:.4f} ms, K3 {impl_ms['fused']:.4f} ms "
        "(CUDA events, host included)")
    return dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms, library_valid_rows_ms=library_valid_ms,
                bound_ms=bound_ms, bound_by=bound_by, rows=nd * k, valid_rows=valid, tiles=tiles,
                plain_peak_gb=plain_gb, max_abs_plain=max_plain), max_err


def check_request(label, traj, info, n_total, n_seeds):
    """Finite unit-quaternion poses of the expected shape, energies ascending."""
    e, final = info["energy"], traj[-1]
    if not (np.isfinite(traj).all() and np.isfinite(e).all() and traj.shape == (n_total + 2, n_seeds, 7)
            and e.shape == (n_seeds,) and np.all(np.diff(e) >= 0)
            and np.allclose(np.linalg.norm(final[:, :4], axis=-1), 1.0, atol=1e-4)):
        raise SmokeFailure(f"{label}: poses or energies not finite, of the wrong shape, unsorted, or with non-unit "
                           "quaternions")


def request_drift(label, traj_a, info_a, traj_b, info_b, T0):
    """The pick request's gates between two runs of one request (same seeds,
    same noise): final-pose drift, energy drift per seed, top-5 order."""
    oa, ob = unsort(traj_a, T0), unsort(traj_b, T0)
    per_seed = np.abs(traj_a[-1][oa] - traj_b[-1][ob]).max(axis=-1)
    pose_drift = float(per_seed.max())
    ea, eb = info_a["energy"][oa], info_b["energy"][ob]  # energies in the order of the seeds
    e_drift = float(np.abs(ea - eb).max())
    top_a, top_b = ([int(np.flatnonzero(o == c)[0]) for c in range(5)] for o in (oa, ob))
    same_top = all(a == b or abs(eb[a] - eb[b]) <= ENERGY_GATE for a, b in zip(top_a, top_b))
    log(f"{label}: final-pose drift {pose_drift:.3g} (gate {POSE_GATE}; median per seed {np.median(per_seed):.3g}, "
        f"seeds over 1e-3: {int((per_seed > 1e-3).sum())}), energy drift per seed {e_drift:.3g} (gate "
        f"{ENERGY_GATE}), top-5 seeds {top_a} vs {top_b}")
    if not (pose_drift <= POSE_GATE and e_drift <= ENERGY_GATE and same_top):
        raise SmokeFailure(f"{label}: the requests drift apart")
    return pose_drift, e_drift


def place_drift_witness(runs, T0, ends):
    """Where the place request's drift arises: the per-seed final-pose drift
    after each stage (``ends``: the trajectory index of each stage's last
    pose) for kernel, fused and plain against each other and for two plain
    runs whose seed translations differ by 1e-6 of themselves, then the seeds
    that drift over 1e-3 in any pair.  If a seed drifts as far between the two plain
    runs as between a kernel and plain, the rollout amplifies any float32
    rounding on it and neither side departs; a kernel fault shows as drift
    that the plain pair lacks."""
    pairs = (("kernel vs plain", None, "plain"), ("fused vs plain", "fused", "plain"),
             ("kernel vs fused", None, "fused"),
             ("plain vs plain, seeds moved 1e-6", "plain", "plain, seeds moved 1e-6"))
    per = {}
    for name, a, b in pairs:
        ta, tb = runs[a][0], runs[b][0]
        oa, ob = unsort(ta, T0), unsort(tb, T0)
        per[name] = np.stack([np.abs(ta[e][oa] - tb[e][ob]).max(-1) for e in ends], 1)  # (seeds, stages)
        log(f"place drift witness, {name}: per stage (lowres, highres) max "
            f"{[float(f'{x:.3g}') for x in per[name].max(0)]}, median "
            f"{[float(f'{x:.3g}') for x in np.median(per[name], 0)]}, seeds over 1e-3 "
            f"{[int(x) for x in (per[name] > 1e-3).sum(0)]}")
    drifting = np.flatnonzero(np.any([p[:, -1] > 1e-3 for p in per.values()], axis=0))
    for s in drifting:
        log(f"place drift witness, seed {s} (lowres, highres): "
            + "; ".join(f"{name} {[float(f'{x:.3g}') for x in per[name][s]]}" for name, _, _ in pairs))
    return per


def http(url, payload=None, timeout=600):
    """GET (no payload) or POST JSON to ``url``; (status, decoded JSON)."""
    import urllib.error
    import urllib.request

    data = None if payload is None else json.dumps(payload).encode()
    req = urllib.request.Request(url, data=data, headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def wire_request(task, scene, grasp, Ts):
    """A ``/denoise`` payload: clouds and seed poses in metres."""
    return {"task_type": task, "Ts_init": np.asarray(Ts).tolist(),
            "scene": {"points": scene.points.tolist(), "colors": scene.colors.tolist()},
            "grasp": {"points": grasp.points.tolist(), "colors": grasp.colors.tolist()}}


def check_wire_trajectory(label, traj, n_steps, n_seeds):
    traj = np.asarray(traj)
    if not (traj.shape == (n_steps, n_seeds, 7) and np.isfinite(traj).all()
            and np.allclose(np.linalg.norm(traj[-1, :, :4], axis=-1), 1.0, atol=1e-4)
            and np.abs(traj[-1, :, 4:]).max() < 2.0):
        raise SmokeFailure(f"{label}: trajectories of shape {traj.shape}, not finite, not unit quaternions or not "
                           "in metres")


def train_profile(step, steps: int = 10):
    """(device-busy ms, kernels) per train step from ``torch.profiler`` over
    ``steps`` calls ``step(i)`` (``step_profile``'s method); the steps train."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for i in range(steps):
            step(i)
        torch.cuda.synchronize()
    events = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    by_name = {}
    for e in events:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.device_time / steps / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    log("  device ms a step by kernel: " + "; ".join(f"{t:.2f} {n[:70]}" for n, t in top))
    return sum(e.device_time for e in events) / steps / 1e3, len(events) / steps


def trainer_step(tr):
    """``step(i)``: one step of ``tr`` on its demo ``i`` (cyclically)."""
    return lambda i: tr.step(tr.batches[i % len(tr.batches)])


def spread_gate(label, eager: list, captured: dict, floor: dict) -> dict:
    """Captured against eager training (the same weights, generator seed and
    demo order; ``state_diff``'s quantities): for each, the captured run's
    difference to the nearest eager run at most twice the largest difference
    between two eager runs (the spread) or ``floor``, as phase 15's gate;
    exactly 0 where both are 0.  The card's backward sums with atomics in no
    fixed order, so eager runs differ among themselves."""
    pairs = [state_diff(a, b) for j, a in enumerate(eager) for b in eager[j + 1:]]
    to_eager = [state_diff(captured, e) for e in eager]
    spread = {k: max(p[k] for p in pairs) for k in captured}
    got = {k: min(d[k] for d in to_eager) for k in captured}
    failed = [k for k in captured if got[k] > max(2 * spread[k], floor[k])]
    log(f"{label}: captured against the nearest of {len(eager)} eager runs " + ", ".join(
        f"{k} {got[k]:.3g} (eager spread {spread[k]:.3g}, floor {floor[k]:.3g})" for k in captured))
    if failed:
        raise SmokeFailure(f"{label}: captured training departs from eager beyond twice their spread: {failed}")
    return dict(captured=got, spread=spread, floor=floor)


def state_diff(a: dict, b: dict) -> dict:
    """Two runs' difference: the largest of the step losses' (``loss``);
    of each list of tensors, the L2 norm of the difference over all their
    elements.  AMSGrad's normalised update turns a rounding difference in a
    near-zero gradient into a flipped update of that element (2 lr), so the
    largest element of a difference says nothing; its norm does."""
    return {k: max(abs(x - y) for x, y in zip(a[k], b[k])) if k == "loss" else l2(a[k], b[k]) for k in a}


def l2(a: list, b: list = None) -> float:
    """The L2 norm over every element of the tensors ``a`` (of ``a - b``)."""
    import torch

    diffs = a if b is None else [x.double() - y.double() for x, y in zip(a, b)]
    return float(torch.stack([d.double().square().sum() for d in diffs]).sum()) ** 0.5


def train_floor(state: dict, start: dict) -> dict:
    """``spread_gate``'s floor for a run from ``start``: ``TRAIN_GATES`` as
    phase 10a applies them to one step, the loss's relative to the largest
    loss, the tensors' of the norm of what the run changed in them."""
    loss_gate, norm_gate = TRAIN_GATES
    return {k: loss_gate * max(abs(x) for x in v) if k == "loss" else norm_gate * l2(v, start.get(k))
            for k, v in state.items()}


def card_against_cpu(label, tr, cpu_tr, inputs, witness: bool):
    """One step of the same drawn inputs and weights on the card and on the
    CPU, in float32, dropout off: the loss and every gradient within
    ``TRAIN_GATES``.  ``witness``: also the CPU step in float64, to show how
    far each float32 gradient sits from it.  Returns the numbers."""
    import torch

    from diffusion_edf_tpu_torch.weights import flat_arrays

    def run(t_, inp):
        t_.model.eval()
        loss, _, grads = t_.loss_and_grads(inp)
        return float(loss.detach()), flat_arrays(t_.model, grads)

    l_card, g_card = run(tr, inputs)
    l_cpu, g_cpu = run(cpu_tr, inputs.to("cpu"))
    pairs = [("card-CPU", g_card, g_cpu)]
    if witness:
        cpu_tr.model.double()
        l_64, g_64 = run(cpu_tr, inputs.to("cpu", torch.float64))
        cpu_tr.model.float()
        pairs += [("card-float64", g_card, g_64), ("CPU-float64", g_cpu, g_64)]
    loss_err = abs(l_card - l_cpu) / abs(l_cpu)
    worst = {}
    for name, a, b in pairs:
        for k, g in b.items():
            if not (np.isfinite(a[k]).all() and np.isfinite(g).all()):
                raise SmokeFailure(f"{label}: the gradient of {k} is not finite")
            r = float(np.abs(a[k] - g).max()) / (float(np.abs(g).max()) or 1.0)
            if r >= worst.get(name, (0.0, None))[0]:
                worst[name] = (r, k)
    rec = dict(loss_card=l_card, loss_cpu=l_cpu, loss_rel=loss_err, keys=len(g_cpu),
               **{f"grad_{n}": w for n, (w, _) in worst.items()}, grad_card_cpu_key=worst["card-CPU"][1])
    if witness:
        rec["loss_f64"] = l_64
    loss_gate, grad_gate = TRAIN_GATES
    log(f"{label}: one step card against CPU (same draws, dropout off): loss {l_card:.7g} against {l_cpu:.7g} "
        f"({loss_err:.3g} relative, gate {loss_gate}{f'; float64 {l_64:.7g}' if witness else ''}); worst gradient "
        f"of its key's max |grad|: " + ", ".join(f"{n} {w:.3g} at {k}" for n, (w, k) in worst.items())
        + f" (gate {grad_gate} on card-CPU); {len(g_cpu)} keys")
    if not (loss_err <= loss_gate and worst["card-CPU"][0] <= grad_gate):
        raise SmokeFailure(f"{label}: the card's train step differs from the CPU's")
    return rec


def train_phase(dev, scene, grasp) -> dict:
    """Phase 10, training on the card (see the module docstring); returns
    its numbers."""
    import torch

    from diffusion_edf_tpu_torch.agent import DiffusionEdfAgent, ModelBundle, load_model_bundle
    from diffusion_edf_tpu_torch.train.synthetic import make_synthetic_dataset
    from diffusion_edf_tpu_torch.train.trainer import DiffusionEdfTrainer, load_configs

    if torch.backends.cuda.matmul.allow_tf32:
        raise SmokeFailure("TF32 matmuls are on: the card's float32 train step cannot be held to the CPU's")
    out_dir = os.path.join(ROOT, "build", "train_smoke")
    shutil.rmtree(out_dir, ignore_errors=True)
    demos = make_synthetic_dataset(n_demos=TRAIN_DEMOS, seed=0)
    summary = {}

    def trainers(name):
        kw = dict(n_scene_pad=2048, n_grasp_pad=512, seed=0)
        tr = DiffusionEdfTrainer(os.path.join(CONFIGS, name), log_dir=os.path.join(out_dir, name), device=dev, **kw)
        tr.init(demos, checkpoint=os.path.join(CHECKPOINTS, f"{name}.npz"))
        cpu = DiffusionEdfTrainer(os.path.join(CONFIGS, name), log_dir=os.path.join(out_dir, name + "_cpu"),
                                  device="cpu", **kw)
        cpu.init(demos[:1], checkpoint=os.path.join(CHECKPOINTS, f"{name}.npz"))
        return tr, cpu

    # ---- 10a: pick_lowres, one step card against CPU ----
    t0 = time.perf_counter()
    tr, cpu = trainers("pick_lowres")
    eval_inputs = [tr.draw_step(b) for b in tr.batches]  # fixed draws, one per demo
    summary["pick_lowres_card_vs_cpu"] = card_against_cpu("pick_lowres", tr, cpu, eval_inputs[0], witness=True)
    del cpu
    log(f"10a: {time.perf_counter() - t0:.1f} s")

    # ---- 10b: TRAIN_STEPS steps with dropout on ----
    def eval_loss():
        return float(np.mean([tr.evaluate(x)["loss/train"] for x in eval_inputs]))

    before = eval_loss()
    reset_counters()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    epoch_s, stats = [], []
    t0 = time.perf_counter()
    while tr.steps < TRAIN_STEPS:
        t = time.perf_counter()
        stats.append(tr.train_epoch())
        epoch_s.append(time.perf_counter() - t)
    wall = time.perf_counter() - t0
    busy, n_kernels = train_profile(trainer_step(tr))
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    during = counters()
    with open(os.path.join(tr.log_dir, "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f][-TRAIN_STEPS:]
    finite = all(np.isfinite(r["loss/train"]) and np.isfinite(r["grad_norm"]) for r in rows)
    after = eval_loss()
    per_step = np.asarray(epoch_s) / len(tr.batches) * 1e3
    ms = float(np.median(per_step))
    summary["pick_lowres_train"] = dict(
        steps=tr.steps, ms_per_step=ms, ms_per_step_mean=wall * 1e3 / TRAIN_STEPS, busy_ms=busy,
        idle_share=1 - busy / ms, kernels_per_step=n_kernels, peak_gb=peak / 1e9, peak_over_base_gb=(peak - base) / 1e9,
        eval_loss_before=before, eval_loss_after=after, launches=during,
        loss_first_epoch=float(np.mean([r["loss/train"] for r in rows[:8]])),
        loss_last_epoch=float(np.mean([r["loss/train"] for r in rows[-8:]])))
    log(f"10b: pick_lowres {tr.steps} train steps (dropout on) in {wall:.1f} s: {ms:.1f} ms a step (median epoch; mean "
        f"{wall * 1e3 / TRAIN_STEPS:.1f}); device busy {busy:.2f} ms a step, idle share {1 - busy / ms:.3f}, "
        f"{n_kernels:.0f} kernels a step; peak memory {peak / 1e9:.2f} GB ({(peak - base) / 1e9:.2f} above the "
        f"{base / 1e9:.2f} GB before); eval loss (8 fixed batches, dropout off) {before:.4f} -> {after:.4f} "
        f"(gate x{EVAL_RISE_GATE}); train loss first epoch {summary['pick_lowres_train']['loss_first_epoch']:.4f}, "
        f"last {summary['pick_lowres_train']['loss_last_epoch']:.4f}; launches during training {during}")
    if not finite:
        raise SmokeFailure("10b: a train loss or gradient norm is not finite")
    if attention_launches(during) != 0 or during["gather_last_t"] == 0:
        raise SmokeFailure("10b: an attention kernel launched during training, or the gather transpose did not")
    if not after <= EVAL_RISE_GATE * before:
        raise SmokeFailure("10b: the evaluation loss rose during training")

    # ---- 10c: the pick_ebm critic, second order, with the rank loss ----
    t0 = time.perf_counter()
    ctr, cpu = trainers("pick_ebm")
    summary["pick_ebm_card_vs_cpu"] = card_against_cpu("pick_ebm", ctr, cpu, ctr.draw_step(ctr.batches[0]),
                                                       witness=False)
    del cpu
    reset_counters()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    cstats, step_s = [], []
    for i in range(CRITIC_STEPS):
        t = time.perf_counter()
        cstats.append(ctr.step(ctr.batches[i % len(ctr.batches)]))
        step_s.append(time.perf_counter() - t)
    busy_c, n_kernels_c = train_profile(trainer_step(ctr), steps=5)
    peak = torch.cuda.max_memory_allocated()
    during = counters()
    ms_c = float(np.median(step_s)) * 1e3
    finite = all(np.isfinite(v) for st in cstats for v in st.values())
    acc = [st["rank/pair_acc"] for st in cstats]
    summary["pick_ebm_train"] = dict(
        steps=CRITIC_STEPS, ms_per_step=ms_c, busy_ms=busy_c, idle_share=1 - busy_c / ms_c, kernels_per_step=n_kernels_c,
        peak_gb=peak / 1e9, peak_over_base_gb=(peak - base) / 1e9, pair_acc_mean=float(np.mean(acc)),
        pair_acc_last5=float(np.mean(acc[-5:])), launches=during)
    log(f"10c: pick_ebm {CRITIC_STEPS} train steps (dropout on, second order): {ms_c:.1f} ms a step (median); device busy "
        f"{busy_c:.2f} ms, idle share {1 - busy_c / ms_c:.3f}, {n_kernels_c:.0f} kernels a step; peak memory "
        f"{peak / 1e9:.2f} GB ({(peak - base) / 1e9:.2f} above the {base / 1e9:.2f} GB before); rank/pair_acc mean "
        f"{np.mean(acc):.3f} (last 5 {np.mean(acc[-5:]):.3f}); loss first {cstats[0]['loss/train']:.4f} last "
        f"{cstats[-1]['loss/train']:.4f}; launches {during}; {time.perf_counter() - t0:.1f} s")
    if not finite:
        raise SmokeFailure("10c: a critic loss or gradient is not finite")
    if attention_launches(during) != 0 or during["gather_last_t"] == 0:
        raise SmokeFailure("10c: an attention kernel launched during the critic's training, or the gather transpose "
                           "did not")
    del ctr

    # ---- 10d: the trained weights served on K1 ----
    t0 = time.perf_counter()
    exported = tr.export(os.path.join(out_dir, "pick_lowres_trained.npz"))
    preprocess = load_configs(CONFIG)[0]["preprocess_config"]
    bundle = load_model_bundle(CONFIG, exported, device=dev)
    n_extract = n_attentions([bundle])
    Ts_init = seed_poses(N_SEEDS)

    def rollout():
        agent = DiffusionEdfAgent([bundle], preprocess, UNPROCESS, preprocess_seed=0)
        return agent.sample(scene, grasp, Ts_init, generator=torch.Generator(device=dev).manual_seed(1), **SCHEDULE)

    reset_counters()
    traj_k, _, _, info_k = rollout()
    launched = counters()
    bundle.model.set_edge_impl("plain")
    traj_p, _, _, _ = rollout()
    steps = info_k["steps"][0]
    drift = float(np.abs(traj_k[-1] - traj_p[-1]).max())
    # the trainer's own model on K1: its derived weights were cached by 10b's first evaluation, before the
    # replays wrote the parameters; it must serve the trained weights as the freshly loaded export does
    tr.model.eval()
    own = ModelBundle(tr.model, bundle.ang_mult, bundle.lin_mult)
    agent = DiffusionEdfAgent([own], preprocess, UNPROCESS, preprocess_seed=0)
    traj_own = agent.sample(scene, grasp, Ts_init, generator=torch.Generator(device=dev).manual_seed(1),
                            **SCHEDULE)[0]
    own_drift = float(np.abs(traj_own[-1] - traj_k[-1]).max())
    summary["trained_rollout"] = dict(drift=drift, launches=launched, steps=steps, extractor_attentions=n_extract,
                                      own_model_drift=own_drift)
    log(f"10d: trained pick_lowres exported ({os.path.getsize(exported) / 1e6:.1f} MB), {N_SEEDS} seeds x {steps} steps "
        f"on kernel against plain: final-pose drift {drift:.3g} (gate {POSE_GATE}); launches {launched} "
        f"({n_extract} extractor attentions + one a step); the trainer's own model on kernel against the export "
        f"on kernel {own_drift:.3g} (gate {RUNTIME_POSE_GATE}); {time.perf_counter() - t0:.1f} s")
    if not (np.isfinite(traj_k).all() and drift <= POSE_GATE):
        raise SmokeFailure("10d: the trained weights' kernel rollout drifts from the plain rollout")
    if launched["edge_kernel"] != steps + n_extract:
        raise SmokeFailure("10d: K1 did not launch once a step")
    if not own_drift <= RUNTIME_POSE_GATE:
        raise SmokeFailure("10d: the trainer's model serves other weights than it trained (stale derived weights)")
    del tr, bundle, own, agent
    torch.cuda.empty_cache()

    # ---- 10e: the training command line ----
    t0 = time.perf_counter()
    cli_dir = os.path.join(out_dir, "cli")
    os.makedirs(cli_dir, exist_ok=True)
    cmd = [sys.executable, "-m", "diffusion_edf_tpu_torch.train.cli", "--configs-root-dir", CONFIG,
           "--synthetic-demos", "2", "--max-epochs", "1", "--log-name", "smoke"]
    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.run(cmd, cwd=cli_dir, env=env, capture_output=True, text=True, timeout=600)
    for line in proc.stdout.strip().splitlines()[-3:]:
        log(f"  cli: {line}")
    ckpt = os.path.join(cli_dir, "runs", "smoke", "checkpoint", "1.npz")
    if proc.returncode != 0 or not os.path.exists(ckpt):
        log(proc.stderr[-3000:])
        raise SmokeFailure(f"10e: the training CLI exited {proc.returncode} or wrote no checkpoint")
    check = DiffusionEdfTrainer(CONFIG, log_dir=os.path.join(out_dir, "cli_restore"), device=dev)
    check.init(make_synthetic_dataset(n_demos=2, seed=0))
    check.restore(ckpt)
    summary["cli"] = dict(seconds=time.perf_counter() - t0, epoch=check.epoch, steps=check.steps)
    log(f"10e: the training CLI exited 0 in {time.perf_counter() - t0:.1f} s; restore read its checkpoint at epoch "
        f"{check.epoch}, step {check.steps}")
    if (check.epoch, check.steps) != (1, 2):
        raise SmokeFailure("10e: the CLI's checkpoint restored the wrong epoch or step count")
    del check

    # ---- 10f: the compiled train step against eager steps ----
    reset_counters()
    for name, n_demos in TRAIN_RUNTIME_CASES:
        summary[f"{name}_captured"] = runtime_train_case(dev, name, n_demos, os.path.join(out_dir, "runtime"))
    during = counters()
    summary["captured_training_launches"] = during
    log(f"10f: launches while training eagerly and captured {during}")
    if attention_launches(during) != 0:
        raise SmokeFailure("10f: an attention kernel launched during training")
    return summary


def runtime_train_case(dev, name: str, n_demos: int, out_dir: str) -> dict:
    """10f on one model: ``TRAIN_EAGER_RUNS`` eager epochs and one through
    the runtime (``use_runtime``), each from the shipped checkpoint with
    generator seed 0 and the same demo order; the captured epoch's losses,
    parameters, EMA and optimizer state held to the eager runs
    (``spread_gate``), every step count the steps taken, a second captured
    epoch with no new entry; ms a step, device busy, idle share, kernels a
    step, capture seconds and the graph pool; the gather transpose's
    launches in each epoch (a capture counts its launches, a replay none)."""
    import torch

    from diffusion_edf_tpu_torch.train.synthetic import make_synthetic_dataset
    from diffusion_edf_tpu_torch.train.trainer import DiffusionEdfTrainer

    t_case = time.perf_counter()
    demos = make_synthetic_dataset(n_demos=n_demos, seed=0)
    runs, start = [], None
    for i in range(TRAIN_EAGER_RUNS + 1):
        captured = i == TRAIN_EAGER_RUNS
        tr = DiffusionEdfTrainer(os.path.join(CONFIGS, name), log_dir=os.path.join(out_dir, f"{name}_{i}"),
                                 device=dev, seed=0, use_runtime=captured)
        tr.init(demos, checkpoint=os.path.join(CHECKPOINTS, f"{name}.npz"))
        if start is None:
            start = dict(params=[p.detach().clone() for p in tr.params], ema=[e.clone() for e in tr.ema])
        torch.cuda.synchronize()
        g0 = counters()["gather_last_t"]
        t0 = time.perf_counter()
        _, capture_s = capture_seconds(tr.train_epoch)  # its statistics are read at its end: synchronised
        rec = dict(epoch_s=time.perf_counter() - t0, capture_s=capture_s,
                   gather_launches=counters()["gather_last_t"] - g0)
        with open(os.path.join(tr.log_dir, "metrics.jsonl")) as f:
            rec["state"] = dict(loss=[json.loads(line)["loss/train"] for line in f],
                                params=[p.detach().clone() for p in tr.params],
                                ema=[e.clone() for e in tr.ema],
                                opt=[t.clone() for t in tr.optimizer.state_tensors()[1:]])
        rec["count"] = int(tr.optimizer.count)
        if captured:
            entries = tr.cache_size()
            g0 = counters()["gather_last_t"]
            t0 = time.perf_counter()
            tr.train_epoch()
            rec.update(replay_epoch_s=time.perf_counter() - t0, entries=entries, entries_after=tr.cache_size(),
                       pool_gb=tr.pool_bytes() / 1e9, replay_gather_launches=counters()["gather_last_t"] - g0)
        if captured or i == TRAIN_EAGER_RUNS - 1:
            rec["busy_ms"], rec["kernels"] = train_profile(trainer_step(tr), steps=2)
        runs.append(rec)
        del tr
        torch.cuda.empty_cache()
    eager, cap = runs[:-1], runs[-1]
    gate = spread_gate(f"10f: {name}, {n_demos} steps", [r["state"] for r in eager], cap["state"],
                       train_floor(eager[0]["state"], start))
    ms_eager = float(np.median([r["epoch_s"] for r in eager])) / n_demos * 1e3
    ms_cap = cap["replay_epoch_s"] / n_demos * 1e3
    busy_e = eager[-1]["busy_ms"]
    out = dict(steps=n_demos, eager_ms=ms_eager, captured_ms=ms_cap, capturing_epoch_ms=cap["epoch_s"] / n_demos * 1e3,
               eager_busy_ms=busy_e, captured_busy_ms=cap["busy_ms"], eager_idle=1 - busy_e / ms_eager,
               captured_idle=1 - cap["busy_ms"] / ms_cap, eager_kernels=eager[-1]["kernels"],
               captured_kernels=cap["kernels"], capture_s=cap["capture_s"], pool_gb=cap["pool_gb"],
               entries=cap["entries"], gather_launches=dict(eager_epoch=eager[-1]["gather_launches"],
                                                            capturing_epoch=cap["gather_launches"],
                                                            replayed_epoch=cap["replay_gather_launches"]), **gate)
    log(f"10f: {name} ({n_demos} demos, one epoch): eager {ms_eager:.1f} ms a step (median of {TRAIN_EAGER_RUNS} "
        f"epochs), busy {busy_e:.2f}, idle {out['eager_idle']:.3f}, {eager[-1]['kernels']:.0f} kernels; captured "
        f"{ms_cap:.1f} ms (the replayed epoch; capturing epoch {out['capturing_epoch_ms']:.1f}), busy "
        f"{cap['busy_ms']:.2f}, idle {out['captured_idle']:.3f}, {cap['kernels']:.0f} kernels; capture "
        f"{cap['capture_s']:.2f} s, graph pool {cap['pool_gb']:.2f} GB; entries {cap['entries']}, after a second "
        f"epoch {cap['entries_after']}; gather_last_t launches {out['gather_launches']} "
        f"({out['gather_launches']['eager_epoch'] / n_demos:.1f} a step eagerly); "
        f"{time.perf_counter() - t_case:.1f} s")
    if cap["entries_after"] != cap["entries"] or cap["entries"] != 1:
        raise SmokeFailure(f"10f: {name}: the second epoch made a new entry, or the demos made more than one")
    if [r["count"] for r in runs] != [n_demos] * len(runs):
        raise SmokeFailure(f"10f: {name}: the optimizer's step counts are not the steps taken")
    if not (out["gather_launches"]["eager_epoch"] and out["gather_launches"]["capturing_epoch"]):
        raise SmokeFailure(f"10f: {name}: an eager or the capturing epoch did not launch the gather transpose")
    return out


def model_attentions(model) -> int:
    """The GraphAttentions that one extraction of ``model``'s key and query
    models runs (each once)."""
    return sum(1 for part in (model.key_model, model.query_model)
               for m in part.modules() if type(m).__name__ == "GraphAttention")


def n_attentions(bundles) -> int:
    """``model_attentions`` summed over the bundles' models."""
    return sum(model_attentions(b.model) for b in bundles)


EVAL_CASCADES = dict(pick=("schedule_sweep_pick_r2.json", "eval_pick_cascade.json"),
                     place=("schedule_sweep_place.json", "eval_place_cascade.json"))


def eval_cascade(dev, task: str, n_demos: int = EVAL_DEMOS):
    """The shipped ``task`` cascade as its committed JAX report was made:
    (agent with the critic, its bundles, the first ``n_demos`` demos of the
    default split, the sweep winner's diffusion configs and name, the
    report's default split)."""
    from diffusion_edf_tpu_torch.agent import DiffusionEdfAgent, load_model_bundle
    from diffusion_edf_tpu_torch.eval import PREPROCESS as eval_pre
    from diffusion_edf_tpu_torch.eval import to_diffusion_configs
    from diffusion_edf_tpu_torch.train.synthetic import make_split_dataset

    sweep_file, report_file = EVAL_CASCADES[task]
    with open(os.path.join(ROOT, "reports", report_file)) as f:
        ref = json.load(f)["default"]
    with open(os.path.join(ROOT, "reports", sweep_file)) as f:
        sweep = json.load(f)
    win = next(c for c in sweep["candidates"] if c["name"] == sweep["winner"])
    cfg = to_diffusion_configs({**win["schedule"], "name": win["name"]}, n_stages=2)
    names = (f"{task}_lowres", f"{task}_highres", f"{task}_ebm")
    bundles = [load_model_bundle(os.path.join(CONFIGS, n), os.path.join(CHECKPOINTS, ckpt + ".npz"), device=dev)
               for n, ckpt in zip(names, names[:2] + (f"{task}_ebm_cascade",))]
    agent = DiffusionEdfAgent(bundles[:2], eval_pre, UNPROCESS, critic=bundles[2])
    demos = make_split_dataset("default", n_demos=n_demos, seed=1000, family="mug")
    return agent, bundles, demos, cfg, win["name"], ref


def eval_phase(dev) -> dict:
    """Phase 11, the shipped pick and place cascades through
    ``diffusion_edf_tpu_torch.eval.evaluate_agent`` on the default
    ``edge_impl`` (see the module docstring); returns its numbers."""
    import torch

    from diffusion_edf_tpu_torch.eval import evaluate_agent

    summary = {}
    for task in EVAL_CASCADES:
        agent, bundles, demos, cfg, win_name, ref = eval_cascade(dev, task)
        n_steps = sum(map(sum, cfg["N_steps_list"]))
        expected = EVAL_DEMOS * (n_steps + n_attentions(bundles) + 1)  # + the critic's field, each demo
        reset_counters()
        t0 = time.perf_counter()
        report = evaluate_agent(agent, demos, task_type=task, n_seeds=EVAL_SEEDS, diffusion_configs=cfg, seed=0)
        torch.cuda.synchronize()
        s_demo = (time.perf_counter() - t0) / EVAL_DEMOS
        launched = counters()
        label = f"{task} cascade ({win_name}: {n_steps} steps a demo)"
        errs = [v for d in report["per_demo"] for k, v in d.items() if k != "demo"]
        errs += [report[k][s] for k in ("trans_err_cm", "rot_err_deg") for s in ("mean", "median")]
        rows = []
        for d, r in zip(report["per_demo"], ref["per_demo"]):
            dt, dr = d["trans_err_cm_median"] - r["trans_err_cm_median"], d["rot_err_deg_median"] - r["rot_err_deg_median"]
            rows.append(dict(demo=d["demo"], trans_cm=d["trans_err_cm_median"], rot_deg=d["rot_err_deg_median"],
                             best_trans_cm=d["best_trans_err_cm"], best_rot_deg=d["best_rot_err_deg"],
                             report_trans_cm=r["trans_err_cm_median"], report_rot_deg=r["rot_err_deg_median"],
                             d_trans_cm=dt, d_rot_deg=dr, same_demo=d["demo"] == r["demo"]))
            log(f"11: {label} {d['demo']}: median {d['trans_err_cm_median']:.4f} cm {d['rot_err_deg_median']:.4f} deg "
                f"(report {r['trans_err_cm_median']:.4f} cm {r['rot_err_deg_median']:.4f} deg; gates "
                f"{EVAL_TRANS_GATE} cm, {EVAL_ROT_GATE} deg), best {d['best_trans_err_cm']:.4f} cm "
                f"{d['best_rot_err_deg']:.4f} deg")
        summary[task] = dict(rows=rows, seconds_per_demo=s_demo, launches=launched, expected_edge_kernel=expected,
                             success=report["success_rate"], executed_success=report.get("executed_success_rate"),
                             best_sample_success=report["best_sample_success_rate"])
        log(f"11: {label}, {EVAL_DEMOS} demos x {EVAL_SEEDS} seeds: {s_demo:.1f} s a demo; success "
            f"{report['success_rate']:.3f}, executed {report.get('executed_success_rate')}, best sample "
            f"{report['best_sample_success_rate']:.3f}; launches {launched} (expected edge_kernel {expected}: "
            f"{EVAL_DEMOS} x ({n_steps} steps + {n_attentions(bundles)} extractor attentions + 1))")
        if set(report) != set(ref):
            raise SmokeFailure(f"11: the {task} report's keys differ from the committed JAX report's: "
                               f"{sorted(set(report) ^ set(ref))}")
        if not (report["n_samples"] == EVAL_DEMOS * EVAL_SEEDS and np.isfinite(errs).all()):
            raise SmokeFailure(f"11: the {task} report has {report['n_samples']} samples or non-finite errors")
        if launched["edge_kernel"] != expected or launched["fused_attention"] or launched["edge_kernel_bf16"]:
            raise SmokeFailure(f"11: the {task} evaluation did not run through K1 as counted")
        if not all(r["same_demo"] and abs(r["d_trans_cm"]) <= EVAL_TRANS_GATE and abs(r["d_rot_deg"]) <= EVAL_ROT_GATE
                   for r in rows):
            raise SmokeFailure(f"11: a {task} demo's median errors are off the committed report's")
        del agent, bundles
        torch.cuda.empty_cache()
    return summary


# phase 2f: (in1 irreps, table, rows) of the gathers whose transpose the pick train step takes most time in, and
# the coefficient table, whose zero column's segment is empty (the card tests' cases)
GATHER_CASES = (("32x0e+16x1e+8x2e", "X", 26240), ("64x0e+32x1e+16x2e", "X", 4680), ("32x0e+16x1e+8x2e", "W", 16400),
                ("32x0e+16x1e+8x2e", "C", 2048))
# and (irreps in, irreps out) of pick_lowres's linear layers, whose weight assemblies are single rows: the
# largest (the attention's sep_alpha_value, 10 a step), a middle one (a block's proj, 10) and the smallest of
# several (32 a step)
LINEAR_GATHER_CASES = (
    ("64x0e+32x0e+16x0e+64x1e+32x1e+32x1e+32x1e+16x1e+16x1e+64x2e+32x2e+32x2e+16x2e+16x2e+16x2e",
     "64x0e+112x0e+32x1e+16x2e"),
    ("64x0e+32x1e+16x2e", "64x0e+32x1e+16x2e"), ("32x0e+16x1e+8x2e", "32x0e+16x1e+8x2e"))


def gather_cases(dev) -> dict:
    """Phase 2f: the gather transpose (``nn/gather.py``) at ``GATHER_CASES``
    and ``LINEAR_GATHER_CASES`` (one row each) on random gradients as their
    callers hand them (``tp.apply_dtp_cm``'s 0 at the positions the table
    leaves out, ``IrrepsLinear``'s dense): the kernel
    and its plain version each within (terms + 1) units of 2^-24 of the
    float64 sum of |terms| of the exact sum of the kept positions, as is
    index_select's own backward (zeros + index_add_, on every column but
    the linear layer's zero element, whose sum it also takes); the
    kernel's and that backward's device time, the plain version's (CUDA
    events) and the bound: each byte of the gradient that the sum uses
    read once (the kept positions: the left-out ones come in runs of at
    least a multiplicity's lanes, so a kernel need not read them), of the
    output written once, and of the table read once.  Returns {shape label:
    record}."""
    import torch

    from diffusion_edf_tpu_torch.geom.irreps import Irreps
    from diffusion_edf_tpu_torch.nn import gather, tp
    from diffusion_edf_tpu_torch.nn.layers import IrrepsLinear

    like = torch.zeros(0, device=dev)
    cases = []
    for irreps, which, rows in GATHER_CASES:
        prog = tp.dtp_instructions(Irreps(irreps), Irreps("1x0e+1x1e+1x2e"), Irreps(irreps))
        cases.append((f"{irreps} {which}", dict(zip("XCW", tp.cm_tables(prog, False, like)))[which], rows, False))
    for irreps_in, irreps_out in LINEAR_GATHER_CASES:
        cases.append((f"IrrepsLinear {irreps_out} W", IrrepsLinear(irreps_in, irreps_out).gather_tables(False, like)[0],
                      1, True))
    g_gen = torch.Generator(device=dev).manual_seed(0)
    out = {}
    for name, table, rows, dense in cases:
        P = table.idx.shape[0]
        kept = torch.zeros(P, dtype=torch.bool, device=dev)
        kept[table.lanes.long()] = True
        g = torch.randn(rows, P, generator=g_gen, device=dev)
        if not dense:
            g = g * kept  # as apply_dtp_cm hands it: 0 where left out
        zeros = torch.zeros(rows, table.width, dtype=torch.float64, device=dev)
        exact = zeros.clone().index_add_(-1, table.idx, (g * kept).double())
        tol = ((table.ptr[1:] - table.ptr[:-1] + 1).double() * 2.0**-24
               * zeros.clone().index_add_(-1, table.idx, (g * kept).double().abs()))
        cols = slice(0, table.width - 1 if dense else table.width)  # the library also sums the zero element
        with torch.no_grad():
            results = dict(kernel=gather.gather_last_t(g, table), plain=gather.gather_last_t_plain(g, table),
                           library=torch.zeros(rows, table.width, device=dev).index_add_(-1, table.idx, g))
        excess = {k: float(((v.double() - exact).abs() - tol)[:, cols].max()) for k, v in results.items()}
        err = float((results["kernel"].double() - exact).abs().max())
        label = f"{rows}x{P}->{table.width}"
        if max(excess.values()) > 0:
            raise SmokeFailure(f"2f: {label}: beyond float32 rounding of the exact sum by {excess}")
        n_kept = table.lanes.numel()
        nbytes = 4 * rows * (n_kept + table.width) + 4 * (table.ptr.numel() + n_kept)
        rec = dict(rows=rows, positions=P, kept=n_kept, width=table.width,
                   ms=device_ms(lambda: gather.gather_last_t(g, table)),
                   bound_ms=bound(0.0, nbytes)[0], plain_ms=cuda_ms(lambda: gather.gather_last_t_plain(g, table)),
                   library_ms=device_ms(lambda: torch.zeros(rows, table.width, device=dev).index_add_(
                       -1, table.idx, g)), max_abs_err=err)
        rec["roofline_pct"] = 100 * rec["bound_ms"] / rec["ms"]
        log(f"2f: gather_last_t {label} ({name}, {n_kept} positions kept): kernel {rec['ms']:.4f} ms, "
            f"bound {rec['bound_ms']:.4f} "
            f"({rec['roofline_pct']:.1f} %), zeros + index_add_ {rec['library_ms']:.4f}, plain {rec['plain_ms']:.4f}; "
            f"max-abs err {err:.3g}")
        out[label] = rec
        del g, zeros, exact, tol, results
    torch.cuda.empty_cache()
    return out


def sapien_inputs(dev, seeded: bool = False):
    """The ``sapien/pick_lowres`` bundle on ``dev`` (the shipped checkpoint,
    or ``seeded`` weights of seed 0), and its request: the pick step of the
    default split's first demo, prepared as the evaluation prepares it, and
    32 seed poses drawn as the evaluation draws them (metres).  Returns
    (bundle, scene, grasp, prepared scene, prepared grasp, seed poses)."""
    from diffusion_edf_tpu_torch.agent import DiffusionEdfAgent, load_model_bundle
    from diffusion_edf_tpu_torch.eval import PREPROCESS as eval_pre
    from diffusion_edf_tpu_torch.train.synthetic import make_synthetic_demo

    ckpt = None if seeded else os.path.join(ROOT, "checkpoints", "sapien", "pick_lowres.npz")
    bundle = load_model_bundle(SAPIEN_LOWRES, ckpt, device=dev, init_seed=0)
    demo = make_synthetic_demo(1000)[0]
    scene, grasp = demo.scene_pcd, demo.grasp_pcd
    rng = np.random.default_rng(0)
    q = rng.normal(size=(N_SEEDS, 4))
    Ts_init = np.concatenate([q / np.linalg.norm(q, axis=-1, keepdims=True), scene.points.mean(0) + rng.normal(
        scale=scene.points.std(0).mean() + 0.05, size=(N_SEEDS, 3))], -1).astype(np.float32)
    return (bundle, scene, grasp) + DiffusionEdfAgent([], eval_pre, UNPROCESS)._prep(scene, grasp) + (Ts_init,)


def sapien_kernel_cases(dev, g):
    """Phase 2e: K1 and K3 on the inputs the sapien key field hands its
    attention, with the keypoints' own weights as post-attention weights,
    on the shipped checkpoint and on seeded weights; each error also within
    ``REL_KERNEL_GATE`` of max|plain|.  The shipped checkpoint's weights are
    0.5 at every keypoint, so the seeded model must give weights that a
    kernel ignoring them cannot pass (``POST_WITNESS_GATE``).  Returns ({label:
    (K1 record, K3 record)}, K1 error, K3 error)."""
    import torch

    from diffusion_edf_tpu_torch.nn import fused_attention as fa
    from diffusion_edf_tpu_torch.nn.attention import _head_of_col
    from diffusion_edf_tpu_torch.train.data import pad_pointcloud

    out, k1_err, k3_err = {}, 0.0, 0.0
    for label, seeded in (("sapien_key_field", False), ("sapien_key_field_seeded", True)):
        bundle, _, _, scene_p, grasp_p, Ts_init = sapien_inputs(dev, seeded)
        model = bundle.model
        ga = model.score_head.key_tensor_field.gnn_block_init.ga
        T = torch.as_tensor(np.concatenate([Ts_init[:, :4], Ts_init[:, 4:] * 100.0], -1), device=dev)
        with torch.no_grad():
            key_ms = model.get_key_pcd_multiscale(pad_pointcloud(scene_p, bundle.n_scene_pad, dev))
            query = model.get_query_pcd(pad_pointcloud(grasp_p, bundle.n_grasp_pad, dev))
            captured = capture_attention_inputs(ga, lambda: model.score(*one_request(
                T, key_ms, query, torch.full((N_SEEDS,), 0.3, device=dev))))
            msg, attr, sc, mask, pre, post = captured
            if post is None:
                raise SmokeFailure(f"2e: the {label} hands its attention no point weights")
            # the plain attention with each slot's weight replaced by the mean over the kept slots: where a kernel
            # that misreads or ignores the per-slot weight would land, of max|plain|
            weights, rad = ga._kernel_weights()
            hoc = _head_of_col(ga.irreps_head, ga.H, ga.irreps_attn.dim)
            plain = fa.fused_attention_plain(ga.plan, hoc, msg, attr, sc, mask, pre, post, weights, rad)
            flat = torch.where(mask, post[mask].mean(), post)
            witness = float((fa.fused_attention_plain(ga.plan, hoc, msg, attr, sc, mask, pre, flat, weights, rad)
                             - plain).abs().max() / plain.abs().max())
            kept = post[mask]
            log(f"2e: {label} ({'seeded weights' if seeded else 'shipped checkpoint'}): {int(key_ms[0].mask.sum())} "
                f"of {key_ms[0].n} keypoints kept; its attention's {mask.numel()} edge slots ({N_SEEDS} seeds x "
                f"{query.n} query points x K {mask.shape[1]}), post weights (the keypoints' w) in "
                f"[{float(kept.min()):.4f}, {float(kept.max()):.4f}], std {float(kept.std()):.4f}; the plain "
                f"attention with the weights' mean in every slot sits {witness:.3g} of max|plain| off")
            if seeded and witness < POST_WITNESS_GATE:
                raise SmokeFailure(f"2e: the seeded sapien model's point weights ({witness:.3g}) cannot hold K3's "
                                   "post-attention weight")
            k1_rec, err = k1_masked_case(label, ga, captured, g, dev, rel_gate=REL_KERNEL_GATE)
            k1_err = max(k1_err, err)
            k3_rec, err = k3_case(label, ga, captured, g, dev, k1_rec["ms"], rel_gate=REL_KERNEL_GATE)
            k3_err = max(k3_err, err)
        k3_rec["post_witness"] = witness
        out[label] = (k1_rec, k3_rec)
        del bundle, model, captured, key_ms, query, plain
        torch.cuda.empty_cache()
    return out, k1_err, k3_err


def sapien_phase(dev) -> dict:
    """Phase 12, the sapien family (see the module docstring); returns its
    numbers."""
    import torch

    from diffusion_edf_tpu_torch.agent import DiffusionEdfAgent, load_model_bundle
    from diffusion_edf_tpu_torch.eval import PREPROCESS as eval_pre
    from diffusion_edf_tpu_torch.train.data import pad_pointcloud

    summary = {}
    # ---- 12a: the shipped sapien/pick_lowres checkpoint, one stage on kernel, fused and plain ----
    t0 = time.perf_counter()
    bundle, scene, grasp, scene_p, grasp_p, Ts_init = sapien_inputs(dev)
    model = bundle.model
    n_extract = n_attentions([bundle])
    runs = {}
    for impl in ("kernel", "fused", "plain"):
        model.set_edge_impl(impl)
        reset_counters()
        traj, _, _, info = DiffusionEdfAgent([bundle], eval_pre, UNPROCESS).sample(
            scene, grasp, Ts_init, generator=torch.Generator(device=dev).manual_seed(1), **SCHEDULE)
        torch.cuda.synchronize()
        runs[impl] = (traj, info, counters())
    model.set_edge_impl(None)
    steps = runs["plain"][1]["steps"][0]
    expected = steps + n_extract
    drift = {impl: float(np.abs(runs[impl][0][-1] - runs["plain"][0][-1]).max()) for impl in ("kernel", "fused")}
    summary["stage"] = dict(drift=drift, launches={k: v[2] for k, v in runs.items()}, expected=expected,
                            rollout_ms_per_step={k: v[1]["rollout_s"][0] * 1e3 / steps for k, v in runs.items()},
                            poses_moved=float(np.abs(runs["plain"][0][-1] - runs["plain"][0][0]).max()))
    log(f"12a: sapien/pick_lowres (PointAttentiveScoreModel, shipped checkpoint), {N_SEEDS} seeds x {steps} steps: "
        f"final-pose drift vs plain kernel {drift['kernel']:.3g}, fused {drift['fused']:.3g} (gate {POSE_GATE}); "
        f"ms a step {', '.join(f'{k} {v:.2f}' for k, v in summary['stage']['rollout_ms_per_step'].items())}; "
        f"launches {summary['stage']['launches']} (expected {expected}: {steps} steps + {n_extract} extractor "
        f"attentions); poses moved {summary['stage']['poses_moved']:.3g}; {time.perf_counter() - t0:.1f} s")
    if not all(np.isfinite(r[0]).all() for r in runs.values()) or max(drift.values()) > POSE_GATE:
        raise SmokeFailure("12a: a sapien kernel rollout drifts from the plain rollout")
    k, f, p = (runs[i][2] for i in ("kernel", "fused", "plain"))
    if (k["edge_kernel"], k["fused_attention"], f["fused_attention"], f["edge_kernel"], attention_launches(p)) != (
            expected, 0, expected, 0, 0):
        raise SmokeFailure("12a: the sapien stage did not run through the expected kernels")
    del runs, bundle, model

    # ---- 12b: a sapien/pick_highres model (ForwardOnlyFeatureExtractor) of seeded weights, one score ----
    hb = load_model_bundle(SAPIEN_HIGHRES, None, device=dev, init_seed=0)
    hm = hb.model
    T = torch.as_tensor(np.concatenate([Ts_init[:, :4], Ts_init[:, 4:] * 100.0], -1), device=dev)

    def whole_score(impl):
        hm.set_edge_impl(impl)
        try:
            with torch.no_grad():
                out = hm.score(*one_request(
                    T, hm.get_key_pcd_multiscale(pad_pointcloud(scene_p, hb.n_scene_pad, dev)),
                    hm.get_query_pcd(pad_pointcloud(grasp_p, hb.n_grasp_pad, dev)),
                    torch.full((N_SEEDS,), 0.1, device=dev)))
        finally:
            hm.set_edge_impl(None)
        return torch.cat(list(out), dim=-1)

    reset_counters()
    sk = whole_score("kernel")
    launched = counters()
    sp = whole_score("plain")
    err = float((sk - sp).abs().max() / sp.abs().max())
    n_h = n_attentions([hb])
    summary["highres_score"] = dict(rel_err=err, launches=launched, extractor_attentions=n_h)
    log(f"12b: sapien/pick_highres (ForwardOnlyFeatureExtractor, seeded weights): one score evaluation, extraction "
        f"included, kernel against plain {err:.3g} of max|score| (gate {HIGHRES_SCORE_GATE}); launches {launched} "
        f"({n_h} extractor attentions + 1)")
    if not (err <= HIGHRES_SCORE_GATE and bool(torch.isfinite(sk).all())) or launched["edge_kernel"] != n_h + 1:
        raise SmokeFailure("12b: the forward-only model's kernel score differs from the plain one")
    return summary


def dropout_off(model) -> None:
    """Every dropout rate of ``model`` set to 0, so that ``train()`` mode
    (which ``DiffusionEdfTrainer.step`` sets) draws no mask."""
    from diffusion_edf_tpu_torch.nn.attention import GraphAttention
    from diffusion_edf_tpu_torch.nn.layers import EquivariantDropout

    for m in model.modules():
        if isinstance(m, GraphAttention):
            m.alpha_drop = 0.0
        elif isinstance(m, EquivariantDropout):
            m.rate = 0.0


def sharded_model(model_cfg, dev, edge_impl, **axes):
    """``pick_lowres`` from the shipped checkpoint, built with the mesh axis
    names ``axes`` (``query_shard_axes`` or ``scene_axis_name``)."""
    from diffusion_edf_tpu_torch.train.factory import build_score_model
    from diffusion_edf_tpu_torch.weights import load_params_npz

    model = build_score_model(model_cfg["model_name"], model_cfg["model_kwargs"], edge_impl=edge_impl, **axes)
    return load_params_npz(model, CHECKPOINT).to(dev).eval()


def score_inputs(bundle, dev):
    """Phase 13b's score inputs, as ``run`` makes them for phase 2: the
    preprocessed scene's key scales and the query, stacked as one request,
    32 poses (cm) and their time."""
    import torch

    from diffusion_edf_tpu_torch.agent import DiffusionEdfAgent
    from diffusion_edf_tpu_torch.train.data import pad_pointcloud
    from diffusion_edf_tpu_torch.train.trainer import load_configs

    scene, grasp = scene_clouds()
    scene_p, grasp_p = DiffusionEdfAgent([bundle], load_configs(CONFIG)[0]["preprocess_config"], UNPROCESS,
                                         preprocess_seed=0)._prep(scene, grasp)
    with torch.no_grad():
        key_ms = bundle.model.get_key_pcd_multiscale(pad_pointcloud(scene_p, bundle.n_scene_pad, dev))
        query = bundle.model.get_query_pcd(pad_pointcloud(grasp_p, bundle.n_grasp_pad, dev))
    T = torch.as_tensor(seed_poses(N_SEEDS), device=dev)
    T = torch.cat([T[:, :4], T[:, 4:] * 100.0], dim=-1)  # metres -> cm
    return one_request(T, key_ms, query, torch.full((N_SEEDS,), 0.3, device=dev))


def multi_device_rank(rank: int, world: int, run_dir: str, device_type: str = "cuda") -> None:
    """One rank of phase 13 (see the module docstring): ``world`` ranks
    share the one card in a gloo group; each saves its numbers to
    ``run_dir``.  (``device_type="cpu"`` rehearses it on the host.)"""
    import hashlib

    import torch
    import torch.distributed as dist

    from diffusion_edf_tpu_torch.agent import DiffusionEdfAgent, load_model_bundle
    from diffusion_edf_tpu_torch.parallel.distributed import initialize_distributed
    from diffusion_edf_tpu_torch.parallel.mesh import make_mesh, use_mesh
    from diffusion_edf_tpu_torch.parallel.sharded import make_sharded_train_step, scene_sharded_score_fn
    from diffusion_edf_tpu_torch.train.synthetic import make_synthetic_dataset
    from diffusion_edf_tpu_torch.train.trainer import DiffusionEdfTrainer, load_configs
    from diffusion_edf_tpu_torch.weights import flat_arrays

    torch.set_num_threads(2)
    initialize_distributed(f"file://{run_dir}/rendezvous", world, rank, device=device_type, backend="gloo")
    dev = torch.device(device_type)
    out = {"backend": dist.get_backend(), "device": str(torch.empty(0, device=dev).device)}
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    train_cfg, _, model_cfg = load_configs(CONFIG)

    def gen(seed):
        return torch.Generator(device=dev).manual_seed(seed)

    def timed(fn):
        sync()
        t = time.perf_counter()
        r = fn()
        sync()
        return r, time.perf_counter() - t

    # ---- 13a: the pick_lowres stage, seeds sharded over data ----
    mesh = make_mesh()
    bundle = load_model_bundle(CONFIG, CHECKPOINT, device=dev)
    scene, grasp = scene_clouds()

    def agent(use_runtime=False):  # gloo groups run eagerly: the reference path
        return DiffusionEdfAgent([bundle], train_cfg["preprocess_config"], UNPROCESS, preprocess_seed=0, mesh=mesh,
                                 use_runtime=use_runtime)

    def refusal(fn):
        """The message with which ``fn`` refuses the gloo mesh on CUDA (None if it ran)."""
        try:
            fn()
        except RuntimeError as e:
            return str(e)
        return None

    agent().sample(scene, grasp, seed_poses(N_SEEDS)[:4], generator=gen(9), record_trajectory=False,
                   **dict(SCHEDULE, N_steps_list=[[1, 1]]))  # warm-up
    reset_counters()
    (traj, _, _, info), wall = timed(lambda: agent().sample(scene, grasp, seed_poses(N_SEEDS), generator=gen(1),
                                                            **SCHEDULE))
    out["13a"] = dict(final=traj[-1], launches=counters(), steps=info["steps"][0], rollout_s=info["rollout_s"][0],
                      wall_s=wall)
    out["refused"] = dict(agent=refusal(lambda: agent(use_runtime=True)))

    # ---- 13b: one score step, query rows and then the scene sharded, on kernel and plain ----
    mesh2 = make_mesh(axis_names=("data", "model"), shape=(1, world))
    T, key_ms, query, time_vec = score_inputs(bundle, dev)
    out["13b"] = {}
    for impl in ("kernel", "fused", "plain"):
        mq = sharded_model(model_cfg, dev, impl, query_shard_axes=["data", "model"])
        ms = sharded_model(model_cfg, dev, impl, scene_axis_name="model")
        scene_fn = scene_sharded_score_fn(mesh2, ms, key_ms, query, use_runtime=False)
        if impl == "kernel":
            out["refused"]["scene_score"] = refusal(
                lambda: scene_sharded_score_fn(mesh2, ms, key_ms, query)(T, time_vec))
        rec = {}
        with torch.no_grad():
            paths = [("query", lambda: mq.score(T, key_ms, query, time_vec))]
            if impl == "fused":  # K3 holds the whole softmax: the scene-sharded path must refuse it
                try:
                    scene_fn(T, time_vec)
                    rec["scene_refused"] = False
                except RuntimeError:
                    rec["scene_refused"] = True
            else:
                paths.append(("scene", lambda: scene_fn(T, time_vec)))
            for name, fn in paths:
                with use_mesh(mesh2):
                    fn()
                    reset_counters()
                    score, s = timed(fn)
                    launched = counters()
                    _, s2 = timed(fn)
                rec[name] = dict(ang=score[0].cpu(), lin=score[1].cpu(), launches=launched, ms=[s * 1e3, s2 * 1e3])
        out["13b"][impl] = rec
        del mq, ms

    # ---- 13c: data-parallel train steps, dropout off ----
    demos = make_synthetic_dataset(n_demos=2, seed=0)
    for name, n_steps in (("pick_lowres", 3), ("pick_ebm", 1)):
        tr = DiffusionEdfTrainer(os.path.join(CONFIGS, name), log_dir=os.path.join(run_dir, f"{name}_{rank}"),
                                 n_scene_pad=2048, n_grasp_pad=512, device=dev, seed=0, use_runtime=False)
        tr.init(demos, checkpoint=os.path.join(CHECKPOINTS, f"{name}.npz"))
        dropout_off(tr.model)
        step = make_sharded_train_step(mesh, tr)
        if name == "pick_lowres":  # the runtime's step refuses before it draws or runs anything
            tr.use_runtime = True
            out["refused"]["train_step"] = refusal(lambda: step(tr.batches[0]))
            tr.use_runtime = False
        applied = []  # the gradients each step hands its update
        apply_grads = tr.apply_grads
        tr.apply_grads = lambda grads: (applied.append([g.detach().clone() for g in grads]), apply_grads(grads))
        records = []
        for i in range(n_steps):
            batch = tr.batches[i % len(tr.batches)]
            state = tr.generator.get_state()
            inputs = tr.draw_step(batch)
            tr.generator.set_state(state)  # the step draws the same inputs again
            stats, s = timed(lambda: step(batch))
            records.append(dict(inputs=inputs.to("cpu"), step_loss=stats["loss/train"],
                                grads=[g.cpu() for g in applied.pop()], params=flat_arrays(tr.model),
                                ema=flat_arrays(tr.model, tr.ema), step_ms=s * 1e3))
        digest = hashlib.sha256(b"".join(v.tobytes() for _, v in sorted(flat_arrays(tr.model).items()))).hexdigest()
        out[name] = dict(records=records if rank == 0 else [dict(step_ms=r["step_ms"]) for r in records],
                         params_sha256=digest)
        del tr
    torch.save(out, os.path.join(run_dir, f"rank{rank}.pt"))
    dist.destroy_process_group()


def multi_device_phase(dev, lowres_final: np.ndarray) -> dict:
    """Phase 13: two ranks on the card (``multi_device_rank``) against this
    process's single-process runs; returns the numbers."""
    import torch
    import torch.multiprocessing as mp

    from diffusion_edf_tpu_torch.agent import load_model_bundle
    from diffusion_edf_tpu_torch.parallel.sharded import cap_bound_rows, valid_points_by_block
    from diffusion_edf_tpu_torch.train.synthetic import make_synthetic_dataset
    from diffusion_edf_tpu_torch.train.trainer import DiffusionEdfTrainer, load_configs
    from diffusion_edf_tpu_torch.weights import flat_arrays

    mode = subprocess.run(["nvidia-smi", "--query-gpu=compute_mode", "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip() if dev.type == "cuda" else "none (host)"
    log(f"phase 13: {MD_WORLD} ranks on {dev} over gloo (nccl refuses two ranks on one card); compute mode {mode}")
    if "Exclusive" in mode:
        raise SmokeFailure(f"phase 13: the card's compute mode ({mode}) refuses a second process")
    run_dir = os.path.join(ROOT, "build", "multi_device")
    shutil.rmtree(run_dir, ignore_errors=True)
    os.makedirs(run_dir)
    t0 = time.perf_counter()
    mp.spawn(multi_device_rank, args=(MD_WORLD, run_dir, dev.type), nprocs=MD_WORLD, join=True)
    ranks = [torch.load(os.path.join(run_dir, f"rank{r}.pt"), weights_only=False) for r in range(MD_WORLD)]
    log(f"  ranks done in {time.perf_counter() - t0:.1f} s; backend {[r['backend'] for r in ranks]}, "
        f"device {[r['device'] for r in ranks]}")
    summary = {}

    # ---- 13a ----
    a = [r["13a"] for r in ranks]
    drift = max(float(np.abs(x["final"] - lowres_final).max()) for x in a)
    steps = a[0]["steps"]
    summary["seed_sharded_stage"] = dict(drift=drift, launches=[x["launches"]["edge_kernel"] for x in a],
                                         rollout_s=[x["rollout_s"] for x in a], steps=steps)
    log(f"13a: pick_lowres stage, {N_SEEDS} seeds sharded over {MD_WORLD} ranks x {steps} steps on kernel: final-pose "
        f"drift against the one-process stage (phase 3, same seeds and noise) {drift:.3g} (gate {POSE_GATE}); "
        f"K1 launches by rank {[x['launches']['edge_kernel'] for x in a]}; rollout "
        f"{[round(x['rollout_s'], 2) for x in a]} s ({[round(N_SEEDS * steps / x['rollout_s'], 1) for x in a]} "
        f"pose-steps/s by the whole batch)")
    if not drift <= POSE_GATE or any(not np.isfinite(x["final"]).all() for x in a):
        raise SmokeFailure("13a: the seed-sharded stage drifts from the one-process stage")
    if any(x["launches"]["edge_kernel"] <= 0 for x in a):
        raise SmokeFailure("13a: a rank launched no K1")

    # ---- 13b ----
    _, _, model_cfg = load_configs(CONFIG)
    bundle = load_model_bundle(CONFIG, CHECKPOINT, device=dev)
    T, key_ms, query, time_vec = score_inputs(bundle, dev)
    cap = cap_bound_rows(bundle.model, T, key_ms, query)
    n_rows = int(query.mask.sum()) * N_SEEDS
    summary["sharded_score"] = {"cap_bound_rows": cap, "rows": n_rows}
    counter = dict(kernel="edge_kernel", fused="fused_attention", plain="edge_kernel")
    for impl in ("kernel", "fused", "plain"):
        bundle.model.set_edge_impl(impl)
        with torch.no_grad():
            ref = [s.cpu() for s in bundle.model.score(T, key_ms, query, time_vec)]
        for name in ("query", "scene") if impl != "fused" else ("query",):
            res = [r["13b"][impl][name] for r in ranks]
            err = max(float((x[k] - ref[i]).abs().max()) for x in res for i, k in enumerate(("ang", "lin")))
            scale = max(float(s.abs().max()) for s in ref)
            n_launch = [x["launches"][counter[impl]] for x in res]
            summary["sharded_score"][f"{name}_{impl}"] = dict(err=err, max_abs=scale, ms=[x["ms"] for x in res],
                                                              launches=n_launch)
            log(f"13b: {name}-sharded score on {impl} ({MD_WORLD} ranks) against the replicated score on {impl}: "
                f"max-abs {err:.3g} (max|score| {scale:.3g}; gate {KERNEL_GATE}); ms by rank {[x['ms'] for x in res]}; "
                f"{counter[impl]} launches by rank {n_launch}")
            if impl != "plain" and min(n_launch) <= 0:
                raise SmokeFailure(f"13b: the {name}-sharded score on {impl} launched no kernel on a rank")
            if (name == "query" or cap == 0) and not err <= KERNEL_GATE:
                raise SmokeFailure(f"13b: the {name}-sharded score differs from the replicated score")
    if not all(r["13b"]["fused"]["scene_refused"] for r in ranks):
        raise SmokeFailure("13b: the scene-sharded path ran on fused, whose kernel holds the whole softmax")
    k = [r["13b"]["kernel"]["scene"] for r in ranks]
    p = [r["13b"]["plain"]["scene"] for r in ranks]
    err_kp = max(float((x[n] - y[n]).abs().max()) for x, y in zip(k, p) for n in ("ang", "lin"))
    summary["sharded_score"]["scene_kernel_vs_plain"] = err_kp
    blocks = valid_points_by_block(bundle.model, key_ms, MD_WORLD)
    summary["sharded_score"]["valid_points_by_block"] = blocks
    log(f"13b: {cap} of {n_rows} query rows are cap-bound at some scale; valid key points of each scale by scene "
        f"block {blocks}; the scene-sharded score on kernel against the scene-sharded score on plain: {err_kp:.3g} "
        f"(gate {KERNEL_GATE})")
    if not err_kp <= KERNEL_GATE:
        raise SmokeFailure("13b: K1 differs from plain on the scene-sharded path")
    del bundle

    # ---- 13c ----
    loss_gate, grad_gate = TRAIN_GATES
    demos = make_synthetic_dataset(n_demos=2, seed=0)
    for name in ("pick_lowres", "pick_ebm"):
        tr = DiffusionEdfTrainer(os.path.join(CONFIGS, name), log_dir=os.path.join(run_dir, f"{name}_one"),
                                 n_scene_pad=2048, n_grasp_pad=512, device=dev, seed=0)
        tr.init(demos, checkpoint=os.path.join(CHECKPOINTS, f"{name}.npz"))
        dropout_off(tr.model)
        recs, worst, worst_update = [], (0.0, ""), (0.0, "")
        for rec in ranks[0][name]["records"]:  # this trainer runs the same steps on its own parameters
            before, ema_before = flat_arrays(tr.model), flat_arrays(tr.model, tr.ema)
            tr.model.train()
            loss, _, grads = tr.loss_and_grads(rec["inputs"].to(dev))
            one = flat_arrays(tr.model, grads)
            for k, g in flat_arrays(tr.model, rec["grads"]).items():
                worst = max(worst, (float(np.abs(g - one[k]).max()) / (float(np.abs(one[k]).max()) or 1.0), k))
            tr.apply_grads([g.to(dev) for g in rec["grads"]])
            for got, old_, new_ in ((rec["params"], before, flat_arrays(tr.model)),
                                    (rec["ema"], ema_before, flat_arrays(tr.model, tr.ema))):
                for k, v in new_.items():
                    moved = float(np.abs(v - old_[k]).max()) or 1.0
                    worst_update = max(worst_update, (float(np.abs(got[k] - v).max()) / moved, k))
            loss_rel = abs(rec["step_loss"] - float(loss.detach())) / abs(float(loss.detach()))
            recs.append(dict(loss=rec["step_loss"], loss_one=float(loss.detach()), loss_rel=loss_rel))
        same = len({r[name]["params_sha256"] for r in ranks}) == 1
        step_ms = [[x["step_ms"] for x in r[name]["records"]] for r in ranks]
        summary[f"dp_{name}"] = dict(steps=recs, grad_worst=worst[0], grad_worst_key=worst[1],
                                     update_worst=worst_update[0], update_worst_key=worst_update[1],
                                     params_equal=same, step_ms=step_ms)
        log(f"13c: {name}, {len(recs)} data-parallel steps over {MD_WORLD} ranks against one process's steps on the "
            f"same inputs: the step's loss relative {[f'{x['loss_rel']:.3g}' for x in recs]} (gate {loss_gate}); "
            f"worst gradient the step's update was given {worst[0]:.3g} of its key's max at {worst[1]} (gate "
            f"{grad_gate}); rank 0's parameters and EMA after each step against this process's update of those "
            f"gradients {worst_update[0]:.3g} of the key's largest change at {worst_update[1]} (gate {grad_gate}); "
            f"parameters equal on every rank after the steps: {same}; ms a step by rank {step_ms}")
        if not (all(x["loss_rel"] <= loss_gate for x in recs) and worst[0] <= grad_gate
                and worst_update[0] <= grad_gate and same):
            raise SmokeFailure(f"13c: the data-parallel {name} step differs from one process's")
        del tr

    # ---- the runtime refuses the gloo mesh on CUDA; 13d: NCCL collectives captured ----
    refused = [r["refused"] for r in ranks]
    summary["runtime_refuses_gloo"] = {k: all(x[k] is not None and "gloo" in x[k] for x in refused)
                                       for k in refused[0]}
    log(f"13: the runtime given the gloo mesh on {dev.type} (agent, scene-sharded score, data-parallel step) "
        f"refuses on every rank: {summary['runtime_refuses_gloo']} ({refused[0]['agent']!r})")
    if dev.type == "cuda" and not (len(summary["runtime_refuses_gloo"]) == 3
                                   and all(summary["runtime_refuses_gloo"].values())):
        raise SmokeFailure("13: the runtime ran over gloo groups on CUDA, which a CUDA graph cannot hold")
    nccl = nccl_capture_phase(dev.type)
    summary["nccl_capture"] = dict(equal=[r["equal"] for r in nccl["replays"]], capture_s=nccl["capture_s"],
                                   torch=nccl["torch"], nccl=nccl["nccl"], s=nccl["s"])
    return summary


def nccl_capture_rank(rank: int, run_dir: str, device_type: str = "cuda") -> None:
    """Phase 13d's one process: a one-rank NCCL group on the card, and the
    mesh's collectives and the data-parallel step's flat-gradient
    all-reduce on ``dist.group.WORLD``, run eagerly and replayed from one
    captured ``graphs.Program`` on two sets of inputs; saves both to
    ``run_dir``.  (``device_type="cpu"``: gloo and an eager program, a
    rehearsal on the host.)"""
    import torch
    import torch.distributed as dist

    from diffusion_edf_tpu_torch.graphs import Program
    from diffusion_edf_tpu_torch.parallel.mesh import (all_reduce_max, all_reduce_sum, copy_to_shards, gather_blocks,
                                                       make_mesh, reduce_from_shards)

    cuda = device_type == "cuda"
    if cuda:
        torch.cuda.set_device(0)
    dist.init_process_group("nccl" if cuda else "gloo", init_method=f"file://{run_dir}/rendezvous", world_size=1,
                            rank=rank)
    dev = torch.device("cuda", 0) if cuda else torch.device("cpu")
    group = dist.group.WORLD
    g = torch.Generator(device=dev).manual_seed(13)
    x = torch.randn(6, 5, 4, generator=g, device=dev)
    w = torch.randn(5, 4, generator=g, device=dev)

    def fn():
        xr = x.detach().requires_grad_(True)
        (grad,) = torch.autograd.grad((copy_to_shards(xr, group) * w).sum(), xr)  # its backward all-reduces
        return [reduce_from_shards(x * 3.0, group), all_reduce_max(x - w, group), gather_blocks(x, group, 1),
                grad] + all_reduce_sum([x, w], group)

    program = Program(fn, dev, torch.cuda.graph_pool_handle() if cuda else None, mesh=make_mesh())
    out = dict(torch=torch.__version__, nccl=".".join(map(str, torch.cuda.nccl.version())) if cuda else None,
               backend=dist.get_backend(), capture_s=program.capture_s, replays=[])
    for _ in range(2):  # new inputs in place, then eager against the replay
        x.normal_(generator=g)
        w.normal_(generator=g)
        eager = [t.detach().clone() for t in fn()]
        replay = [t.detach().clone() for t in program()]
        out["replays"].append(dict(equal=all(torch.equal(a, b) for a, b in zip(eager, replay)),
                                   max_abs=max(float((a - b).abs().max()) for a, b in zip(eager, replay)),
                                   shapes=[tuple(t.shape) for t in replay]))
    torch.save(out, os.path.join(run_dir, "13d.pt"))
    dist.destroy_process_group()


def nccl_capture_phase(device_type: str = "cuda") -> dict:
    """Phase 13d (``nccl_capture_rank`` in a process of its own, so that this
    one keeps no process group): collectives over NCCL captured in a CUDA
    graph equal the same calls eager, exactly."""
    import torch
    import torch.multiprocessing as mp

    run_dir = os.path.join(ROOT, "build", "nccl_capture")
    shutil.rmtree(run_dir, ignore_errors=True)
    os.makedirs(run_dir)
    t0 = time.perf_counter()
    mp.spawn(nccl_capture_rank, args=(run_dir, device_type), nprocs=1, join=True)
    res = torch.load(os.path.join(run_dir, "13d.pt"), weights_only=False)
    res["s"] = time.perf_counter() - t0
    log(f"13d: reduce_from_shards, all_reduce_max, gather_blocks, copy_to_shards' backward and the flat-gradient "
        f"all-reduce on a one-rank {res['backend']} group (torch {res['torch']}, NCCL {res['nccl']}), captured in "
        f"one graphs.Program ({res['capture_s']:.3f} s) and replayed twice on new inputs against the same calls "
        f"eager: equal {[r['equal'] for r in res['replays']]}, max-abs {[r['max_abs'] for r in res['replays']]} "
        f"(gate: exactly equal); {res['s']:.1f} s")
    if not all(r["equal"] for r in res["replays"]):
        raise SmokeFailure("13d: the captured NCCL collectives differ from eager")
    return res


# phase 14: the model-building tools (diffusion_edf_tpu_torch/tools/)
TOOLS_DIR = os.path.join(ROOT, "build", "smoke_tools")
PICK_SWEEP = os.path.join(ROOT, "reports", "schedule_sweep_pick_r2.json")
DUMP_DEMO_SEEDS, DUMP_SEEDS = dict(train=0, eval=500), 16  # 14a: one training and one held-out demo
CRITIC_FT_STEPS = 3
CRITIC_FT_RUNS = 3  # two eager (their difference is the spread) and one through the tool's compiled step
SWEEP_CANDIDATES, SWEEP_SEEDS = ("reference", "low_floor"), 4
DUMP_DTYPES = dict(scene_x="float32", scene_f="float32", scene_mask="bool", grasp_x="float32", grasp_f="float32",
                   grasp_mask="bool", samples="float32", trans_err="float32", rot_err_deg="float32",
                   target="float32", meta="uint8")
K_TRUNCATION_BUDGET = 0.01  # the JAX package's own budget (tests/test_neighbors.py:123-140)
FAMILY_SCORES = (("panda_bottle", "pick_lowres"), ("panda_bowl", "place_lowres"))


def dump_phase(dev, bundles, cfg) -> dict:
    """14a: ``gen_cascade_samples`` on the shipped pick cascade with the r2
    sweep's winner, one training and one held-out demo; returns the dump
    paths and the numbers."""
    from diffusion_edf_tpu_torch.eval import PREPROCESS as eval_pre
    from diffusion_edf_tpu_torch.eval import pose_errors
    from diffusion_edf_tpu_torch.tools import gen_cascade_samples
    from diffusion_edf_tpu_torch.train.data import TargetPoseDemo, compose_proc_fn
    from diffusion_edf_tpu_torch.train.synthetic import make_synthetic_dataset

    n_steps = sum(map(sum, cfg["N_steps_list"]))
    expected = n_steps + n_attentions(bundles)
    out = dict(paths={}, launches={}, seconds_per_demo={})
    for name, demo_seed in DUMP_DEMO_SEEDS.items():
        path = os.path.join(TOOLS_DIR, f"cascade_samples_pick_{name}.npz")
        reset_counters()
        t0 = time.perf_counter()
        gen_cascade_samples.main([
            "--task-type", "pick", "--configs-root-dir", os.path.join(CONFIGS, "pick_lowres"),
            "--checkpoint-dir", CHECKPOINT, "--cascade-configs-root-dir", os.path.join(CONFIGS, "pick_highres"),
            "--cascade-checkpoint-dir", os.path.join(CHECKPOINTS, "pick_highres.npz"), "--schedule-json", PICK_SWEEP,
            "--n-demos", "1", "--n-seeds", str(DUMP_SEEDS), "--demo-seed", str(demo_seed), "--out", path])
        out["seconds_per_demo"][name] = time.perf_counter() - t0
        out["launches"][name] = launched = counters()
        out["paths"][name] = path
        with np.load(path) as z:
            d = {k: z[k] for k in z.files}
        shapes = dict(scene_x=(1, 2048, 3), scene_f=(1, 2048, 3), scene_mask=(1, 2048), grasp_x=(1, 512, 3),
                      grasp_f=(1, 512, 3), grasp_mask=(1, 512), samples=(1, DUMP_SEEDS, 7),
                      trans_err=(1, DUMP_SEEDS), rot_err_deg=(1, DUMP_SEEDS), target=(1, 7), names=(1,))
        bad = [k for k in DUMP_DTYPES if str(d[k].dtype) != DUMP_DTYPES[k]] + [
            k for k in shapes if d[k].shape != shapes[k]]
        demo = make_synthetic_dataset(n_demos=1, seed=demo_seed, diverse=True)[0][0]
        proc = compose_proc_fn(eval_pre)(TargetPoseDemo(scene_pcd=demo.scene_pcd, grasp_pcd=demo.grasp_pcd,
                                                        target_poses=demo.target_poses))
        errs = pose_errors(d["samples"][0], proc.target_poses)
        same = all(np.array_equal(errs[k].astype(np.float32), d[k][0]) for k in ("trans_err", "rot_err_deg"))
        ok = (d["trans_err"] <= 1.0) & (d["rot_err_deg"] <= 5.0)
        log(f"14a: gen_cascade_samples, pick cascade ({n_steps} steps), {name} demo (demo seed {demo_seed}) x "
            f"{DUMP_SEEDS} seeds: {out['seconds_per_demo'][name]:.1f} s a demo; median {np.median(d['trans_err']):.3f} "
            f"cm {np.median(d['rot_err_deg']):.3f} deg, success {ok.mean():.3f}; keys {sorted(d)}; launches "
            f"{launched} (expected edge_kernel {expected}: {n_steps} steps + {n_attentions(bundles)} extractor "
            f"attentions); errors equal eval.pose_errors recomputed: {same}")
        if set(d) != set(DUMP_DTYPES) | {"names"} or bad or not d["names"].dtype.kind == "U":
            raise SmokeFailure(f"14a: the {name} dump is not in the JAX tool's format: {bad or sorted(d)}")
        if not (same and np.isfinite(d["samples"]).all() and np.isfinite(d["trans_err"]).all()):
            raise SmokeFailure(f"14a: the {name} dump's errors are not finite or not those of eval.pose_errors")
        if (launched["edge_kernel"], launched["fused_attention"], launched["edge_kernel_bf16"]) != (expected, 0, 0):
            raise SmokeFailure(f"14a: the {name} dump did not run through K1 as counted")
    return out


def critic_phase(dev, dumps) -> dict:
    """14b: the ``pick_ebm`` critic from ``pick_ebm_cascade.npz`` on 14a's
    dumps: held-out energies on ``kernel`` and ``fused`` against ``plain``,
    fine-tune steps (no launch), and the tool's main with its report and
    float16 export."""
    import torch

    from diffusion_edf_tpu_torch.graphs import pool_bytes
    from diffusion_edf_tpu_torch.tools import train_critic_cascade as tcc
    from diffusion_edf_tpu_torch.train.ranking import RankConfig
    from diffusion_edf_tpu_torch.weights import load_params_npz

    cfg_dir, ckpt = os.path.join(CONFIGS, "pick_ebm"), os.path.join(CHECKPOINTS, "pick_ebm_cascade.npz")
    model, train_cfg = tcc.build_critic(cfg_dir, dev, ckpt)
    per_demo = model_attentions(model) + 1  # the critic's extraction and one energy field
    ev, tr = tcc.load_dump(dumps["paths"]["eval"]), tcc.load_dump(dumps["paths"]["train"])
    E, launched = {}, {}
    for impl in ("plain", "kernel", "fused"):
        model.set_edge_impl(impl)
        reset_counters()
        with torch.no_grad():
            E[impl] = tcc.energies(model, torch.as_tensor(ev["samples"][0], device=dev),
                                   *tcc.dump_clouds(ev, 0, dev)).cpu().numpy()
        launched[impl] = counters()
    model.set_edge_impl(None)
    scale = float(np.abs(E["plain"]).max())
    errs = {impl: float(np.abs(E[impl] - E["plain"]).max()) for impl in ("kernel", "fused")}
    low = np.sort(E["plain"])[:2]
    decisive = bool(low[1] - low[0] > ENERGY_GATE * scale)
    same_exec = {impl: int(np.argmin(E[impl])) == int(np.argmin(E["plain"])) for impl in errs}
    log(f"14b: pick_ebm_cascade energies of the held-out dump's {DUMP_SEEDS} samples, against plain: kernel "
        f"{errs['kernel']:.3g}, fused {errs['fused']:.3g} (gate {ENERGY_GATE} x max|E| {scale:.3g}); executed sample "
        f"the same {same_exec} (required: {decisive}, the two lowest plain energies "
        f"{low[1] - low[0]:.3g} apart); launches {launched} ({per_demo} each on kernel and fused)")
    if not all(np.isfinite(e).all() for e in E.values()) or max(errs.values()) > ENERGY_GATE * scale:
        raise SmokeFailure("14b: the critic's kernel energies differ from the plain ones")
    if decisive and not all(same_exec.values()):
        raise SmokeFailure("14b: a kernel path executes another sample than plain")
    k, f, p = launched["kernel"], launched["fused"], launched["plain"]
    if (k["edge_kernel"], k["fused_attention"], f["fused_attention"], f["edge_kernel"], attention_launches(p)) != (
            per_demo, 0, per_demo, 0, 0):
        raise SmokeFailure("14b: the critic's energies did not run through the expected kernels")

    # fine-tune steps, dropout on: the plain path (the kernels have no backward), no launch; eager twice (their
    # spread) and through the tool's compiled step, from the same weights and generator seed
    rank_cfg = RankConfig.from_dict(train_cfg.get("critic_rank_configs", {}) or {})
    del model
    reset_counters()
    runs = []
    for i in range(CRITIC_FT_RUNS):
        captured = i == CRITIC_FT_RUNS - 1
        model = tcc.build_critic(cfg_dir, dev, ckpt)[0]
        if i == 0:
            start = dict(params=[p.detach().clone() for p in model.parameters()])
        opt = tcc.make_optimizer(list(model.parameters()), 1e-4, CRITIC_FT_STEPS)
        step = tcc.make_train_step(model, tr, RankConfig(n_negatives=16), rank_cfg, opt,
                                   torch.Generator(device=dev).manual_seed(0), use_runtime=captured)
        ms, losses = [], []
        for _ in range(CRITIC_FT_STEPS):
            t0 = time.perf_counter()
            losses.append(float(step(0)["loss"]))  # a read of the statistics: synchronised
            ms.append((time.perf_counter() - t0) * 1e3)
        params = [p.detach().clone() for p in model.parameters()]
        rec = dict(ms=ms, losses=losses, state=dict(loss=losses, params=params,
                                                    opt=[t.clone() for t in opt.state_tensors()[1:]]))
        if captured or i == CRITIC_FT_RUNS - 2:
            rec["busy_ms"], rec["kernels"] = train_profile(lambda _: step(0), steps=2)
        if captured:
            rec.update(capture_s=step.program.capture_s, pool_gb=pool_bytes(step.pool) / 1e9)
        runs.append(rec)
        del model, opt, step
        torch.cuda.empty_cache()
    train_launches = counters()
    eager, cap = runs[:-1], runs[-1]
    ms, losses = cap["ms"], cap["losses"]
    ms_e, ms_c = float(np.median([m for r in eager for m in r["ms"]])), float(np.median(ms[1:]))
    log(f"14b: {CRITIC_FT_STEPS} fine-tune steps (16 fan + {DUMP_SEEDS} cascade samples, dropout on), captured: "
        f"losses {[round(v, 5) for v in losses]}, ms a step {[round(v, 1) for v in ms]} (the first captures; eager "
        f"{ms_e:.1f} median), busy {cap['busy_ms']:.2f} ms (eager {eager[-1]['busy_ms']:.2f}), idle "
        f"{1 - cap['busy_ms'] / ms_c:.3f} (eager {1 - eager[-1]['busy_ms'] / ms_e:.3f}), kernels {cap['kernels']:.0f} "
        f"(eager {eager[-1]['kernels']:.0f}), capture {cap['capture_s']:.2f} s, graph pool {cap['pool_gb']:.2f} GB; "
        f"launches {train_launches}")
    gate = spread_gate("14b: the fine-tune steps", [r["state"] for r in eager], cap["state"],
                       train_floor(eager[0]["state"], start))
    if not np.isfinite(losses).all() or attention_launches(train_launches):
        raise SmokeFailure("14b: a fine-tune step is not finite or launched an attention kernel")

    # the tool's main: one epoch on the one-demo train dump; evaluations at epoch 0, 1 and on the best
    report_path, export = os.path.join(TOOLS_DIR, "critic_cascade_pick.json"), os.path.join(TOOLS_DIR, "critic.npz")
    reset_counters()
    t0 = time.perf_counter()
    report = tcc.main(["--configs-root-dir", cfg_dir, "--init-params-npz", ckpt,
                       "--train-dump", dumps["paths"]["train"], "--eval-dump", dumps["paths"]["eval"],
                       "--max-epochs", "1", "--eval-every", "1", "--export-best", export, "--out", report_path])
    main_s = time.perf_counter() - t0
    main_launches = counters()
    with open(os.path.join(ROOT, "reports", "critic_cascade_pick.json")) as fh:
        ref = json.load(fh)
    with np.load(export) as z, np.load(ckpt) as zs:
        keys_equal = set(z.files) == set(zs.files)
        f16 = all(z[key].dtype == np.float16 for key in z.files if key != "__meta__")
    load_params_npz(tcc.build_critic(cfg_dir, "cpu")[0], export)
    log(f"14b: train_critic_cascade main, 1 epoch: {main_s:.1f} s; epoch 0 {report['epochs'][0]}; launches "
        f"{main_launches} (expected edge_kernel {3 * per_demo}: 3 held-out evaluations); export keys equal the shipped "
        f"{keys_equal}, float16 {f16}")
    if (set(report) != set(ref) or [set(e) for e in report["epochs"]] != [set(ref["epochs"][0])] * 2
            or set(report["noise_floor"]) != set(ref["noise_floor"])):
        raise SmokeFailure("14b: the critic report's keys differ from the committed JAX report's")
    if not (keys_equal and f16) or main_launches["edge_kernel"] != 3 * per_demo:
        raise SmokeFailure("14b: the critic export or its evaluations are not as the JAX tool's")
    return dict(rel_energy_err={k: v / scale for k, v in errs.items()}, energy_launches=launched,
                step_ms=ms, losses=losses, train_launches=train_launches, main_s=main_s, main_launches=main_launches,
                epoch0=report["epochs"][0], eager_ms=ms_e, captured_ms=ms_c, eager_busy_ms=eager[-1]["busy_ms"],
                captured_busy_ms=cap["busy_ms"], eager_kernels=eager[-1]["kernels"], captured_kernels=cap["kernels"],
                capture_s=cap["capture_s"], pool_gb=cap["pool_gb"], **gate)


def sweep_phase(dev, bundles) -> dict:
    """14c: ``sweep_schedule.sweep`` with two of its candidates on one demo
    of the default split; K1's launches per candidate."""
    from diffusion_edf_tpu_torch.agent import DiffusionEdfAgent
    from diffusion_edf_tpu_torch.eval import PREPROCESS as eval_pre
    from diffusion_edf_tpu_torch.tools import sweep_schedule
    from diffusion_edf_tpu_torch.train.synthetic import make_split_dataset

    agent = DiffusionEdfAgent(bundles, eval_pre, UNPROCESS)
    cands = [c for c in sweep_schedule.candidate_schedules("pick") if c["name"] in SWEEP_CANDIDATES]
    per_cand = []

    def on_entry(entry):
        per_cand.append((entry["name"], counters()))
        reset_counters()

    reset_counters()
    t0 = time.perf_counter()
    report = sweep_schedule.sweep(agent, cands, {"default": make_split_dataset("default", n_demos=1, seed=1000)},
                                  "pick", 1, SWEEP_SEEDS, 0, out=os.path.join(TOOLS_DIR, "sweep.json"),
                                  on_entry=on_entry)
    with open(os.path.join(ROOT, "reports", "schedule_sweep_pick.json")) as fh:
        ref = json.load(fh)
    ref_entry = ref["candidates"][0]
    out = dict(seconds=time.perf_counter() - t0, launches={}, seconds_per_candidate={}, winner=report["winner"])
    for c, (name, launched) in zip(report["candidates"], per_cand):
        expected = c["total_steps"] + n_attentions(bundles)
        out["launches"][name] = launched
        out["seconds_per_candidate"][name] = c["wall_s"]
        log(f"14c: sweep candidate {name} ({c['total_steps']} steps), 1 demo x {SWEEP_SEEDS} seeds: {c['wall_s']} s, "
            f"success {c['default']['success']}, medians {c['default']['trans_cm_median']:.3f} cm "
            f"{c['default']['rot_deg_median']:.3f} deg; launches {launched} (expected edge_kernel {expected})")
        if set(c) != set(ref_entry) - {"unseen_poses"} or set(c["default"]) != set(ref_entry["default"]):
            raise SmokeFailure(f"14c: candidate {name}'s entry keys differ from the committed JAX report's")
        if not (0.0 <= c["default"]["success"] <= 1.0 and 0.0 <= c["default"]["best_success"] <= 1.0):
            raise SmokeFailure(f"14c: candidate {name}'s success is outside [0, 1]")
        if (launched["edge_kernel"], launched["fused_attention"], launched["edge_kernel_bf16"]) != (expected, 0, 0):
            raise SmokeFailure(f"14c: candidate {name} did not run through K1 as counted")
    if set(report) != set(ref) or [c["name"] for c in report["candidates"]] != list(SWEEP_CANDIDATES):
        raise SmokeFailure("14c: the sweep report's keys differ from the committed JAX report's")
    log(f"14c: winner {report['winner']}; {out['seconds']:.1f} s")
    return out


def loop_phase(dev) -> dict:
    """14d: ``train_eval_loop`` on ``panda_bowl/pick_lowres`` warm-started
    from its checkpoint: one epoch on two synthetic bowl demos, an
    evaluation before and after it."""
    from diffusion_edf_tpu_torch.tools import train_eval_loop
    from diffusion_edf_tpu_torch.train.factory import build_score_model
    from diffusion_edf_tpu_torch.train.trainer import load_configs
    from diffusion_edf_tpu_torch.weights import load_params_npz

    cfg_dir = os.path.join(ROOT, "diffusion_edf_tpu_torch", "configs", "panda_bowl", "pick_lowres")
    log_dir, export = os.path.join(TOOLS_DIR, "loop"), os.path.join(TOOLS_DIR, "bowl_pick_lowres.npz")
    model_cfg = load_configs(cfg_dir)[2]
    model = build_score_model(model_cfg["model_name"], model_cfg["model_kwargs"])
    expected = 2 * (900 + model_attentions(model))  # two evaluations of the 900-step reference recipe
    reset_counters()
    t0 = time.perf_counter()
    best = train_eval_loop.main([
        "--configs-root-dir", cfg_dir, "--task-type", "pick", "--task-family", "bowl", "--synthetic-demos", "2",
        "--max-epochs", "1", "--eval-every", "1", "--eval-demos", "1", "--n-seeds", "4", "--splits", "default",
        "--init-params-npz", os.path.join(ROOT, "checkpoints", "panda_bowl", "pick_lowres.npz"),
        "--log-name", log_dir, "--export-best", export])
    seconds = time.perf_counter() - t0
    launched = counters()
    with open(os.path.join(log_dir, "learning_curve.jsonl")) as fh:
        curve = [json.loads(line) for line in fh]
    with open(os.path.join(ROOT, "reports", "learning_curve_pick_lowres.jsonl")) as fh:
        ref = json.loads(fh.readline())
    with np.load(export) as z:
        f16 = all(z[k].dtype == np.float16 for k in z.files if k != "__meta__")
    load_params_npz(model, export)
    log(f"14d: train_eval_loop, panda_bowl/pick_lowres from its checkpoint, 1 epoch on 2 demos, 2 evaluations of "
        f"1 demo x 4 seeds: {seconds:.1f} s; curve {curve}; best epoch {best['epoch']}; launches {launched} "
        f"(expected edge_kernel {expected}: 2 x (900 steps + extractor attentions)); export float16 {f16}")
    if [set(r) for r in curve] != [set(ref) - {"unseen_poses"}] * 2 or any(
            set(r["default"]) != set(ref["default"]) for r in curve):
        raise SmokeFailure("14d: the learning curve's lines are not the JAX tool's")
    if not (os.path.exists(os.path.join(log_dir, "best.json")) and f16 and best["epoch"] == 1):
        raise SmokeFailure("14d: best.json or the float16 export is missing")
    if launched["edge_kernel"] != expected:
        raise SmokeFailure("14d: the loop's evaluations did not run through K1 as counted (or training launched it)")
    return dict(seconds=seconds, curve=curve, launches=launched)


def k_truncation_phase(dev, bundles) -> dict:
    """14e: ``k_truncation_report`` at full ``pick_lowres`` width, 5 demos x
    8 poses, held to the budget and to the committed report's call sites."""
    from diffusion_edf_tpu_torch.tools import k_truncation_report

    n_demos = 5
    reset_counters()
    t0 = time.perf_counter()
    rows = k_truncation_report.main(["--configs-root-dir", os.path.join(CONFIGS, "pick_lowres"), "--n-demos",
                                     str(n_demos), "--n-poses", "8", "--json-out",
                                     os.path.join(TOOLS_DIR, "k_truncation.json")])
    seconds = time.perf_counter() - t0
    launched = counters()
    with open(os.path.join(ROOT, "reports", "k_truncation.json")) as fh:
        ref = {r["tag"]: r for r in json.load(fh)}
    by_tag = {r["tag"]: r for r in rows}
    expected = n_demos * (n_attentions(bundles[:1]) + 1)
    # the committed rows count destinations of fewer demos: the same number a demo, if the call sites are the same
    ratios = {tag: ref[tag]["n_eval"] * n_demos / by_tag[tag]["n_eval"] for tag in ref if tag in by_tag}
    for tag, r in by_tag.items():
        rr = ref.get(tag, {})
        log(f"14e: {tag:22s} r {r['r']:.4f} k {r['k']:3d} max degree {r['max_degree']:4d} (report "
            f"{rr.get('max_degree')}) truncated {r['frac_truncated']:.5f} (report {rr.get('frac_truncated')}) n_eval "
            f"{r['n_eval']} (report {rr.get('n_eval')})")
    log(f"14e: {seconds:.1f} s; launches {launched} (expected edge_kernel {expected}); demos behind the committed "
        f"report's rows, tag by tag: {sorted(set(ratios.values()))}")
    worst = max(r["frac_truncated"] for r in rows)
    if worst > K_TRUNCATION_BUDGET:
        raise SmokeFailure(f"14e: a call site truncates {worst:.4f} of its neighbourhoods "
                           f"(budget {K_TRUNCATION_BUDGET})")
    if set(by_tag) != set(ref) or any(by_tag[t]["k"] != ref[t]["k"] or abs(by_tag[t]["r"] - ref[t]["r"]) > 1e-9
                                      for t in ref):
        raise SmokeFailure("14e: the call sites, radii or caps differ from the committed report's")
    if len(set(ratios.values())) != 1 or launched["edge_kernel"] != expected:
        raise SmokeFailure("14e: the destinations a demo or the K1 launches are not as expected")
    return dict(seconds=seconds, rows=rows, launches=launched, report_demos=ratios[next(iter(ratios))])


def family_score_phase(dev) -> dict:
    """14f: one score of ``panda_bottle/pick_lowres`` and of
    ``panda_bowl/place_lowres`` from their checkpoints, extraction
    included, ``kernel`` against ``plain``."""
    import torch

    from diffusion_edf_tpu_torch.agent import load_model_bundle
    from diffusion_edf_tpu_torch.eval import PREPROCESS as eval_pre
    from diffusion_edf_tpu_torch.train.data import compose_proc_fn, pad_pointcloud
    from diffusion_edf_tpu_torch.train.synthetic import make_synthetic_dataset

    out = {}
    for family, name in FAMILY_SCORES:
        b = load_model_bundle(os.path.join(ROOT, "diffusion_edf_tpu_torch", "configs", family, name),
                              os.path.join(ROOT, "checkpoints", family, f"{name}.npz"), device=dev)
        seq = make_synthetic_dataset(n_demos=1, seed=0, family=family.split("_")[1])[0]
        demo = compose_proc_fn(eval_pre)(seq[0 if name.startswith("pick") else 1])
        rng = np.random.default_rng(0)
        T0 = np.asarray(demo.target_poses[0], np.float64)
        q = T0[:4] + rng.normal(0, 0.2, (N_SEEDS, 4))
        T = np.concatenate([q / np.linalg.norm(q, axis=-1, keepdims=True), T0[4:] + rng.normal(0, 2.0, (N_SEEDS, 3))],
                           -1)
        T = torch.as_tensor(T.astype(np.float32), device=dev)
        m = b.model

        def whole_score(impl):
            m.set_edge_impl(impl)
            try:
                with torch.no_grad():
                    res = m.score(*one_request(
                        T, m.get_key_pcd_multiscale(pad_pointcloud(demo.scene_pcd, b.n_scene_pad, dev)),
                        m.get_query_pcd(pad_pointcloud(demo.grasp_pcd, b.n_grasp_pad, dev)),
                        torch.full((N_SEEDS,), 0.1, device=dev)))
            finally:
                m.set_edge_impl(None)
            return torch.cat(list(res), dim=-1)

        reset_counters()
        sk = whole_score("kernel")
        launched = counters()
        sp = whole_score("plain")
        err = float((sk - sp).abs().max() / sp.abs().max())
        n_a = n_attentions([b])
        out[f"{family}/{name}"] = dict(rel_err=err, launches=launched)
        log(f"14f: {family}/{name} (shipped checkpoint): one score evaluation, extraction included, kernel against "
            f"plain {err:.3g} of max|score| (gate {HIGHRES_SCORE_GATE}); launches {launched} ({n_a} extractor "
            f"attentions + 1)")
        if not (err <= HIGHRES_SCORE_GATE and bool(torch.isfinite(sk).all())) or launched["edge_kernel"] != n_a + 1:
            raise SmokeFailure(f"14f: {family}/{name}'s kernel score differs from the plain one")
        del b, m
    return out


def tools_phase(dev) -> dict:
    """Phase 14, the model-building tools (see the module docstring);
    returns its numbers."""
    import torch

    from diffusion_edf_tpu_torch.agent import load_model_bundle
    from diffusion_edf_tpu_torch.eval import to_diffusion_configs

    shutil.rmtree(TOOLS_DIR, ignore_errors=True)
    os.makedirs(TOOLS_DIR)
    with open(PICK_SWEEP) as fh:
        sweep = json.load(fh)
    win = next(c for c in sweep["candidates"] if c["name"] == sweep["winner"])
    cfg = to_diffusion_configs({**win["schedule"], "name": win["name"]}, n_stages=2)
    bundles = [load_model_bundle(os.path.join(CONFIGS, n), os.path.join(CHECKPOINTS, n + ".npz"), device=dev)
               for n in ("pick_lowres", "pick_highres")]
    summary = {}
    for key, fn in (("cascade_dump", lambda: dump_phase(dev, bundles, cfg)),
                    ("critic", lambda: critic_phase(dev, summary["cascade_dump"])),
                    ("sweep", lambda: sweep_phase(dev, bundles)),
                    ("loop", lambda: loop_phase(dev)),
                    ("k_truncation", lambda: k_truncation_phase(dev, bundles)),
                    ("family_scores", lambda: family_score_phase(dev))):
        t0 = time.perf_counter()
        summary[key] = fn()
        torch.cuda.synchronize()
        summary[key + "_s"] = time.perf_counter() - t0
        torch.cuda.empty_cache()
    return summary


def rollout_timing(run, steps: int, reps: int = 3):
    """(wall ms a step (median of ``reps`` unprofiled runs), device-busy ms a
    step, kernels a step) of ``run()``, one rollout of ``steps`` steps whose
    caches and runtime entries exist already; the device numbers from
    ``torch.profiler`` (None when it records no kernel)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    walls = []
    for _ in range(reps):
        t = time.perf_counter()
        run()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    events = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.device_time for e in events) / 1e3 / steps if events else None
    return float(np.median(walls)) * 1e3 / steps, busy, len(events) / steps


def langevin_step_rows(agent, scene, grasp, Ts_init, sched, generator) -> dict:
    """One Langevin step of ``agent``'s first stage at the first stage of
    ``sched``, eager (``langevin_sample``) and captured (its runtime's
    rollout entry, replayed): for each, :func:`rollout_timing`'s wall ms,
    device busy ms, idle share and kernels a step."""
    import torch

    from diffusion_edf_tpu_torch.diffusion.langevin import build_schedule, langevin_sample

    b, rt = agent.models[0], agent._runtimes[0]
    st = build_schedule(diffusion_schedules=sched["diffusion_schedules_list"][0], N_steps=sched["N_steps_list"][0],
                        timesteps=sched["timesteps_list"][0], ang_mult=b.ang_mult, lin_mult=b.lin_mult,
                        temperatures=sched["temperatures_list"][0], time_exponent_temp=sched["time_exponent_temp"],
                        time_exponent_alpha=sched["time_exponent_alpha"])
    steps = len(st.t)
    T0 = torch.as_tensor(np.concatenate([Ts_init[:, :4], Ts_init[:, 4:] * np.float32(100.0)], -1),
                         device=b.device)[None]
    with torch.no_grad(), rt.lock:
        km, q = rt.extract([agent._prep(scene, grasp)])
        timings = {
            "eager": rollout_timing(lambda: langevin_sample(lambda T, t: b.model.score(T, km, q, t), T0, st,
                                                            b.ang_mult, b.lin_mult, generator=generator), steps),
            "captured": rollout_timing(lambda: rt.rollout(km, q, T0, st, generator, True), steps),
        }
    return {name: dict(wall_ms=wall, busy_ms=busy, idle_share=None if busy is None else 1 - busy / wall,
                       kernels=kernels, steps=steps) for name, (wall, busy, kernels) in timings.items()}


def step_row_text(row) -> str:
    busy, idle = row["busy_ms"], row["idle_share"]
    busy_text = "not measured" if busy is None else f"{busy:.3f} ms"
    idle_text = "not measured" if idle is None else f"{idle:.3f}"
    return f"wall {row['wall_ms']:.3f} ms, device busy {busy_text}, idle share {idle_text}, kernels {row['kernels']:.1f}"


def runtime_runs(label, make_agent, scene, grasp, Ts, schedule, gen):
    """Phase 15's comparison on one path: two eager requests (their spread),
    then one agent through the runtime twice (capture, then replays only),
    the same generator seed each time.  Returns its record."""
    import torch

    runs = {}
    for name, use_runtime in (("eager", False), ("eager again", False), ("captured", True), ("replayed", True)):
        agent = make_agent(use_runtime) if name != "replayed" else agent
        reset_counters()
        t = time.perf_counter()
        (traj, _, _, info), capture_s = capture_seconds(
            lambda: agent.sample(scene, grasp, Ts, generator=gen(1), **schedule))
        torch.cuda.synchronize()
        runs[name] = dict(traj=traj, launches=counters(), s=time.perf_counter() - t, info=info, capture_s=capture_s)
    eager = runs["eager"]["traj"]
    spread = float(np.abs(runs["eager again"]["traj"][-1] - eager[-1]).max())
    gate = RUNTIME_POSE_GATE if spread == 0.0 else max(RUNTIME_POSE_GATE, 2 * spread)
    diff = {k: float(np.abs(runs[k]["traj"][-1] - eager[-1]).max()) for k in ("captured", "replayed")}
    rec = dict(spread=spread, gate=gate, diff=diff, launches={k: v["launches"] for k, v in runs.items()},
               request_s={k: v["s"] for k, v in runs.items()},
               ms_per_step={k: 1e3 * sum(v["info"]["rollout_s"]) / sum(v["info"]["steps"]) for k, v in runs.items()},
               cache_sizes=[rt.cache_sizes() for rt in agent._runtimes],
               capture_s=round(runs["captured"]["capture_s"], 4), agent=agent)
    if agent.critic is not None:
        e = runs["eager"]["info"]["energy"]
        rec["energy_diff"] = max(float(np.abs(runs[k]["info"]["energy"] - e).max()) for k in ("captured", "replayed"))
        rec["energy_gate"] = gate * max(1.0, float(np.abs(e).max()))
        rec["cache_sizes"].append(agent._critic_runtime.cache_sizes())
    energies = f"; energies {rec['energy_diff']:.3g} apart" if "energy_diff" in rec else ""
    log(f"15 {label}: captured vs eager final poses {diff['captured']:.3g}, replayed {diff['replayed']:.3g} (gate "
        f"{gate:.3g}; two eager runs {spread:.3g} apart){energies}; launches eager {rec['launches']['eager']}, "
        f"captured {rec['launches']['captured']}, replayed "
        f"{rec['launches']['replayed']}; request s {({k: round(v, 3) for k, v in rec['request_s'].items()})}; rollout "
        f"ms a step {({k: round(v, 3) for k, v in rec['ms_per_step'].items()})}; entries {rec['cache_sizes']}; capture "
        f"s {rec['capture_s']}")
    if spread > 0.0:
        log(f"15 {label}: two eager runs differ by {spread:.3g}: an op of this path is not deterministic")
    if not (max(diff.values()) <= gate and rec.get("energy_diff", 0.0) <= rec.get("energy_gate", 0.0)
            and runs["captured"]["launches"] == runs["eager"]["launches"]
            == runs["replayed"]["launches"] and np.isfinite(runs["replayed"]["traj"]).all()):
        raise SmokeFailure(f"15 {label}: the runtime's rollout or its launch counts differ from the eager agent's")
    return rec


def runtime_phase(dev, bundle, scene, grasp, pbundles, pre_unpre, pscene, pgrasp, Ts_init) -> dict:
    """Phase 15 (run after phase 9): the sampling runtime on the card at full
    width (see the module docstring), with the served preprocessing, which
    draws nothing (so a second request sees the clouds of the first).
    Returns its summary."""
    import torch

    from diffusion_edf_tpu_torch.agent import DiffusionEdfAgent

    def gen(seed):
        return torch.Generator(device=dev).manual_seed(seed)

    summary = {}
    for impl in ("kernel", "fused", "plain"):
        bundle.model.set_edge_impl(impl)
        summary[f"pick_lowres_{impl}"] = runtime_runs(
            f"pick_lowres stage ({impl}, {N_SEEDS} seeds x {N_STEPS} steps)",
            lambda rt: DiffusionEdfAgent([bundle], *pre_unpre, use_runtime=rt), scene, grasp, Ts_init, SCHEDULE, gen)
    bundle.model.set_edge_impl(None)
    summary["place_request_kernel"] = runtime_runs(
        f"place request (kernel, {N_SEEDS} seeds)",
        lambda rt: DiffusionEdfAgent(pbundles[:2], *pre_unpre, critic=pbundles[2], use_runtime=rt),
        pscene, pgrasp, Ts_init, PICK_REQUEST, gen)

    # no new entry after a warmup with the shapes of the later requests, and two of them
    paths = (("pick_lowres", [bundle], None, scene, grasp, SCHEDULE),
             ("place", pbundles[:2], pbundles[2], pscene, pgrasp, PICK_REQUEST))
    for label, models, critic, sc_, gr_, sched in paths:
        agent = DiffusionEdfAgent(models, *pre_unpre, critic=critic)
        _, capture_s = capture_seconds(
            lambda: agent.warmup(sc_, gr_, n_seeds=N_SEEDS, diffusion_configs=sched, record_trajectory=True))
        runtimes = agent._runtimes + ([agent._critic_runtime] if critic is not None else [])
        before = [rt.cache_sizes() for rt in runtimes]
        for i in range(2):
            agent.sample(sc_, gr_, seed_poses(N_SEEDS, seed=70 + i), generator=gen(i), **sched)
        after = [rt.cache_sizes() for rt in runtimes]
        rec = summary[f"{label}_entries"] = dict(
            after_warmup=before, after_two_requests=after, capture_s=round(capture_s, 4),
            pool_mb=[None if rt.pool_bytes() is None else rt.pool_bytes() / 1e6 for rt in runtimes])
        log(f"15 {label}: entries after warmup {before}; after two requests {after}; capture s {rec['capture_s']}; "
            f"graph pool MB {rec['pool_mb']}")
        if before != after or not all(sum(b.values()) for b in before):
            raise SmokeFailure(f"15 {label}: a request after the warmup added runtime entries")

        # one Langevin step of the first stage, eager and captured: wall, device busy, idle share, kernels
        for name, row in langevin_step_rows(agent, sc_, gr_, Ts_init, sched, gen(1)).items():
            summary[f"{label}_step_{name}"] = row
            log(f"15 {label} Langevin step ({name}, kernel, {N_SEEDS} seeds, {row['steps']}-step first stage): "
                f"{step_row_text(row)}")
    for rec in summary.values():
        rec.pop("agent", None)
    return summary


def reset_counters() -> None:
    from diffusion_edf_tpu_torch.nn import edge_kernel as ek
    from diffusion_edf_tpu_torch.nn import fused_attention as fa
    from diffusion_edf_tpu_torch.nn import gather

    ek.launches = ek.launches_bf16 = fa.launches = gather.launches = 0


def counters() -> dict:
    from diffusion_edf_tpu_torch.nn import edge_kernel as ek
    from diffusion_edf_tpu_torch.nn import fused_attention as fa
    from diffusion_edf_tpu_torch.nn import gather

    return dict(edge_kernel=ek.launches, edge_kernel_bf16=ek.launches_bf16, fused_attention=fa.launches,
                gather_last_t=gather.launches)


def attention_launches(launched: dict) -> int:
    """The launches of the edge attention's kernels (K1, K2, K3) in a
    ``counters()`` reading: none of them has a backward, so training runs
    none; the gather transpose runs in every backward."""
    return launched["edge_kernel"] + launched["edge_kernel_bf16"] + launched["fused_attention"]


def main() -> int:
    try:
        return run()
    except SmokeFailure as e:
        log(f"FAIL: {e}")
        return 1


def run() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels run only on the GPU", file=sys.stderr)
        return 1
    from diffusion_edf_tpu_torch.agent import DiffusionEdfAgent, load_model_bundle
    from diffusion_edf_tpu_torch.geom.sh import spherical_harmonics
    from diffusion_edf_tpu_torch.nn import attention, cuda_build
    from diffusion_edf_tpu_torch.nn import edge_kernel as ek
    from diffusion_edf_tpu_torch.nn import fused_attention as fa
    from diffusion_edf_tpu_torch.train.data import pad_pointcloud
    from diffusion_edf_tpu_torch.train.trainer import load_configs

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
        real_tf = capture_attention_inputs(tga, lambda: model.score(*one_request(T32, key_ms, query, time_vec)))
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
            if real[label][3].numel() != rows:
                raise SmokeFailure(f"the model hands {label} {real[label][3].numel()} slots, not {rows}")
            k1[label], err = k1_masked_case(label, ga, real[label], g, dev)
            max_err = max(max_err, err)

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
        for label, ga in (("tensor_field", tga), ("extractor_pool_0", pga), ("tensor_field_k_cap", tga)):
            msg, attr, sc, mask, pre, post = real[label]
            mask = mask.clone()
            mask[0] = mask[mask.shape[0] // 2] = False  # rows with every slot masked
            k3[label], err = k3_case(label, ga, (msg, attr, sc, mask, pre, post), g, dev, k1[label]["ms"])
            k3_err = max(k3_err, err)
    del real, real_tf, real_pool, cap

    # ---- phase 2d: K1 (given the mask) and K3 at the place models' shapes ----
    import yaml

    with open(os.path.join(CONFIGS, "preprocess.yaml")) as f:  # the server's preprocessing: no jitter
        serve_pre = yaml.safe_load(f)
    pre_unpre = (serve_pre["preprocess_config"], serve_pre["unprocess_config"])
    place = {n: load_model_bundle(os.path.join(CONFIGS, n), os.path.join(CHECKPOINTS, n + ".npz"), device=dev)
             for n in PLACE_MODELS}
    pscene, pgrasp = place_clouds()
    pscene_p, pgrasp_p = DiffusionEdfAgent([], *pre_unpre)._prep(pscene, pgrasp)  # as the place request sees them
    pl_model = place["place_lowres"].model
    with torch.no_grad():
        pkey = pl_model.get_key_pcd_multiscale(pad_pointcloud(pscene_p, place["place_lowres"].n_scene_pad, dev))
        pquery = pl_model.get_query_pcd(pad_pointcloud(pgrasp_p, place["place_lowres"].n_grasp_pad, dev))
        ptga = pl_model.score_head.key_tensor_field.gnn_block_init.ga
        kpga = pl_model.query_model.tensor_field.gnn_block_init.ga
        place_inputs = (
            ("place_tensor_field", ptga, capture_attention_inputs(
                ptga, lambda: pl_model.score(*one_request(T32, pkey, pquery, time_vec)))),
            ("keypoint_tensor_field", kpga, capture_attention_inputs(
                kpga, lambda: pl_model.get_query_pcd(pad_pointcloud(pgrasp_p, place["place_lowres"].n_grasp_pad, dev)))),
        )
        log(f"place_lowres: {int(pquery.mask.sum())} of {pquery.n} keypoints kept after the bbox crop; grasp cloud "
            f"{pgrasp_p.n} points after voxelisation; the key field's {place_inputs[0][2][3].numel()} edge rows "
            f"({N_SEEDS} seeds x {pquery.n} keypoints x K {place_inputs[0][2][3].shape[1]})")
        for label, ga, captured in place_inputs:
            k1[label], err = k1_masked_case(label, ga, captured, g, dev)
            max_err = max(max_err, err)
            k3[label], err = k3_case(label, ga, captured, g, dev, k1[label]["ms"])
            k3_err = max(k3_err, err)
    del place_inputs

    # ---- phase 2e: K1 (given the mask) and K3 at the sapien key field, shipped and seeded weights ----
    sapien_cases, err, err3 = sapien_kernel_cases(dev, g)
    for label, (rec1, rec3) in sapien_cases.items():
        k1[label], k3[label] = rec1, rec3
    max_err, k3_err = max(max_err, err), max(k3_err, err3)

    # ---- phase 2f: the transpose of the tensor product's and the linear layers' gathers ----
    gathers = gather_cases(dev)

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

    n_attn = [n_attentions([b]) for b in bundles]
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
    check_request("pick request (fused)", traj_f, info_f, n_total, N_SEEDS)
    e_f, final_f = info_f["energy"], traj_f[-1]
    with torch.no_grad():  # the energies are the critic's energies of the returned final poses
        cm = critic.model
        ckey = cm.get_key_pcd_multiscale(pad_pointcloud(scene_p, critic.n_scene_pad, dev))
        cq = cm.get_query_pcd(pad_pointcloud(grasp_p, critic.n_grasp_pad, dev))
        again = cm.energy(*one_request(torch.as_tensor(final_f, device=dev), ckey, cq,
                                       torch.ones(N_SEEDS, device=dev)))[0].cpu().numpy()
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
    request_drift("pick request fused vs plain", traj_f, info_f, traj_q, info_q, T0)
    log(f"pick request (plain): rollout {[round(x * 1e3, 1) for x in info_q['rollout_s']]} ms, critic "
        f"{info_q['critic_s'] * 1e3:.1f} ms")

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
                out = model.score(*one_request(
                    T32, model.get_key_pcd_multiscale(pad_pointcloud(scene_p, bundle.n_scene_pad, dev)),
                    model.get_query_pcd(pad_pointcloud(grasp_p, bundle.n_grasp_pad, dev)), time_vec))
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

    # ---- phase 8: the whole place request ----
    pbundles = [place[n] for n in PLACE_MODELS]

    def set_place_impl(impl):
        for b in pbundles:
            b.model.set_edge_impl(impl)

    def place_agent():
        return DiffusionEdfAgent(pbundles[:2], *pre_unpre, critic=pbundles[2])

    with torch.no_grad():  # the keypoints each stage keeps after the bbox crop
        kept = [int(b.model.get_query_pcd(pad_pointcloud(pgrasp_p, b.n_grasp_pad, dev)).mask.sum()) for b in pbundles]
    log(f"place request: keypoints kept after the bbox crop per stage (lowres, highres, critic): {kept} of "
        f"{pquery.n}")
    if min(kept) == 0:
        raise SmokeFailure("a place stage keeps no keypoint: the comparison would be vacuous")
    # a field a step, every extractor attention (key and query models), the critic's field
    p_extract = n_attentions(pbundles)
    p_expected = n_total + p_extract + 1
    place_agent().sample(pscene, pgrasp, Ts_init[:2], generator=gen(9), record_trajectory=False, **short)  # warm-up
    place_runs = {}
    # the witness run: the plain request from seed translations moved by 1e-6 of themselves (about 8 float32
    # steps: one step can vanish in the rescale to cm)
    Ts_moved = np.concatenate([Ts_init[:, :4], Ts_init[:, 4:] * np.float32(1 + 1e-6)], -1)
    for impl in (None, "fused", "plain", "plain, seeds moved 1e-6"):
        set_place_impl("plain" if impl and impl.startswith("plain") else impl)
        reset_counters()
        traj_x, _, _, info_x = place_agent().sample(pscene, pgrasp, Ts_moved if impl and "moved" in impl else Ts_init,
                                                    generator=gen(1), **PICK_REQUEST)
        torch.cuda.synchronize()
        place_runs[impl] = (traj_x, info_x, counters())
        log(f"place request ({impl or 'default: kernel'}): {N_SEEDS} seeds, steps {info_x['steps']}, extract "
            f"{[round(x * 1e3, 1) for x in info_x['extract_s']]} ms, rollout "
            f"{[round(x * 1e3, 1) for x in info_x['rollout_s']]} ms "
            f"({sum(info_x['rollout_s']) * 1e3 / n_total:.3f} ms per step), critic {info_x['critic_s'] * 1e3:.1f} ms, "
            f"launches {place_runs[impl][2]} (expected {p_expected} on the kernel paths: {n_total} steps + "
            f"{p_extract} extractor attentions + 1)")
        check_request(f"place request ({impl or 'kernel'})", traj_x, info_x, n_total, N_SEEDS)
    set_place_impl(None)
    count8, count8f = place_runs[None][2], place_runs["fused"][2]
    if not (count8["edge_kernel"] == p_expected and count8["fused_attention"] == 0
            and count8f["fused_attention"] == p_expected and count8f["edge_kernel"] == 0
            and sum(place_runs["plain"][2].values()) == 0):
        raise SmokeFailure("the place request did not run through the expected kernels")
    traj_q, info_q, _ = place_runs["plain"]
    for impl in (None, "fused"):
        request_drift(f"place request {impl or 'kernel'} vs plain", *place_runs[impl][:2], traj_q, info_q, T0)
    place_drift_witness(place_runs, T0, (sum(PICK_REQUEST["N_steps_list"][0]), n_total + 1))
    with torch.no_grad():
        for impl in ("kernel", "fused", "plain"):
            pl_model.set_edge_impl(impl)
            wall, busy, n_kernels, _ = step_profile(pl_model, T32, pkey, pquery, time_vec, wall_steps=10)
            log(f"place score step ({impl}): wall {wall:.3f} ms, device busy {busy:.3f} ms, idle share "
                f"{1 - busy / wall:.3f}, kernels {n_kernels:.0f}")
    pl_model.set_edge_impl(None)

    # ---- phase 9: serving ----
    from diffusion_edf_tpu_torch.serve import AgentService, run_server

    with open(os.path.join(CONFIGS, "server.yaml")) as f:  # the served schedule is phase 4's, its knobs server.yaml's
        served = dict(yaml.safe_load(f), pick_diffusion_configs=PICK_REQUEST, place_diffusion_configs=PICK_REQUEST)
    from diffusion_edf_tpu_torch.serve.cli import warmup_service

    agents = dict(pick_agent=DiffusionEdfAgent([bundle, highres], *pre_unpre, critic=critic),
                  place_agent=DiffusionEdfAgent(pbundles[:2], *pre_unpre, critic=pbundles[2]))
    service = AgentService(**agents, configs=json.loads(json.dumps(served)))
    t = time.perf_counter()
    warmup_service(service, n_seeds=4)  # the served schedules, and the seed count of the endpoint checks below
    log(f"serving: warm-up of both agents with the served schedules {time.perf_counter() - t:.1f} s; entries "
        f"{[rt.cache_sizes() for a in agents.values() for rt in a._runtimes + [a._critic_runtime]]}")
    batched = AgentService(**agents, configs=json.loads(json.dumps(served)), batching=dict(max_batch=4, window_ms=500))
    servers = [run_server(svc, host="127.0.0.1", port=0, block=False) for svc in (service, batched)]
    url, url_b = (f"http://127.0.0.1:{h.server_address[1]}" for h in servers)
    n_wire = n_total + 2
    try:
        checks = [http(url + "/health"), http(url + "/get_configs"),
                  http(url + "/reconfigure", {"place_trajectory_configs": dict(served["place_trajectory_configs"],
                                                                               n_steps=8)}), http(url + "/nowhere")]
        if not (checks[0] == (200, {"status": "ok"}) and checks[1][0] == 200 and "place_diffusion_configs" in checks[1][1]
                and checks[2][1]["place_trajectory_configs"]["n_steps"] == 8 and checks[3][0] == 404):
            raise SmokeFailure(f"serving: /health, /get_configs, /reconfigure or the 404 answered {checks}")
        for task, (sc_, gr_), n_traj in (("pick", (scene, grasp), 10), ("place", (pscene, pgrasp), 8)):
            code, out = http(url + "/denoise", wire_request(task, sc_, gr_, seed_poses(4, seed=40)))
            if code != 200:
                raise SmokeFailure(f"serving: {task} /denoise answered {code}: {out}")
            check_wire_trajectory(f"{task} /denoise", out["trajectories"], n_wire, 4)
            code, out = http(url + "/request_trajectories", wire_request(task, sc_, gr_, seed_poses(4, seed=41)))
            if code != 200 or np.asarray(out["trajectories"]).shape != (4, n_traj, 7):
                raise SmokeFailure(f"serving: {task} /request_trajectories answered {code}")
            check_wire_trajectory(f"{task} /request_trajectories", out["denoise"]["trajectories"], n_wire, 4)
            log(f"serving: {task} /denoise and /request_trajectories ok (trajectories {n_wire} x 4 x 7 in metres, "
                f"energies {np.round(out['denoise']['energy'], 4).tolist()})")
        code, out = http(url + "/denoise", {"task_type": "place"})
        if code != 500 or "error" not in out:
            raise SmokeFailure(f"serving: a bad request answered {code}, not a JSON 500")

        # four concurrent place requests through one dispatch: one request's launches a Langevin step
        import threading

        reqs = [wire_request("place", *place_clouds(seed=50 + i), seed_poses(20, seed=50 + i)) for i in range(4)]
        reset_counters()
        one = http(url + "/denoise", reqs[0])[1]
        l1 = counters()["edge_kernel"]
        results = [None] * 4

        def post(i):
            results[i] = http(url_b + "/denoise", reqs[i])

        def batched_round():
            t = time.perf_counter()
            threads = [threading.Thread(target=post, args=(i,)) for i in range(4)]
            for th in threads:
                th.start()
            for th in threads:
                th.join()
            return time.perf_counter() - t

        reset_counters()
        t_first = batched_round()  # the batched entries' first call: their eager first passes and captures
        l4 = counters()["edge_kernel"]
        per_step = ((l1 - p_extract - 1) / n_total, (l4 - 4 * p_extract - 1) / n_total)
        log(f"serving: 4 concurrent place requests (20 seeds each): {t_first * 1e3:.1f} ms, batch_stats "
            f"{batched.batch_stats}; K1 launches {l4} against {l1} for one request ({p_extract} extractor attentions "
            f"a request): {per_step[1]:.2f} against {per_step[0]:.2f} a Langevin step")
        if not (all(c == 200 for c, _ in results) and batched.batch_stats["dispatches"] == 1
                and batched.batch_stats["batched_requests"] == 4 and per_step[0] == per_step[1] == 1.0):
            raise SmokeFailure("serving: the four place requests did not go through one dispatch")
        for _, out in results + [(200, one)]:
            check_wire_trajectory("place /denoise, 20 seeds", out["trajectories"], n_wire, 20)
        t_batched = batched_round()  # replays, as the sequential requests below
        t = time.perf_counter()
        lat = []
        for r in reqs:
            t1 = time.perf_counter()
            http(url + "/denoise", r)
            lat.append(time.perf_counter() - t1)
        t_seq = time.perf_counter() - t
        log(f"serving: served place /denoise (20 seeds, 100 + 100 steps, critic): p50 latency "
            f"{np.median(lat) * 1e3:.1f} ms over {len(lat)} ({', '.join(f'{x * 1e3:.1f}' for x in lat)}); 4 sequential "
            f"{t_seq * 1e3:.1f} ms against 4 batched {t_batched * 1e3:.1f} ms ({t_seq / t_batched:.2f} x; the first "
            f"batched round, which captured its entries, {t_first * 1e3:.1f} ms)")
    finally:
        for h in servers:
            h.shutdown()

    # sample_batch of two different requests at temperature 0 against two sample() calls
    cold2 = dict(PICK_REQUEST, N_steps_list=[[10, 10], [10, 10, 5]],
                 temperatures_list=[[0.0, 0.0], [0.0, 0.0, 0.0]])
    pair = [place_clouds(seed=60), place_clouds(seed=61)]
    Ts2 = np.stack([seed_poses(8, seed=60), seed_poses(8, seed=61)])
    pa = agents["place_agent"]  # deterministic preprocessing, so both calls see the same clouds
    traj_b2, _ = pa.sample_batch([c[0] for c in pair], [c[1] for c in pair], Ts2, generator=gen(2), **cold2)
    batch_err = 0.0
    for i, (sc_, gr_) in enumerate(pair):
        traj_s, _, _, _ = pa.sample(sc_, gr_, Ts2[i], generator=gen(2), **cold2)
        batch_err = max(batch_err, float(np.abs(traj_b2[i, -1] - traj_s[-1]).max()))
    log(f"sample_batch of 2 place requests vs 2 sample() calls at temperature 0: final-pose max diff {batch_err:.3g} "
        f"(gate 1e-4)")
    if not batch_err <= 1e-4:
        raise SmokeFailure("sample_batch differs from sample()")

    # ---- phase 15 (run here, before phase 10's profiling of training): the sampling runtime ----
    t = time.perf_counter()
    runtime = runtime_phase(dev, bundle, scene, grasp, pbundles, pre_unpre, pscene, pgrasp, Ts_init)
    log(f"phase 15: {time.perf_counter() - t:.1f} s; runtime summary {json.dumps(runtime)}")

    # ---- phase 10: training on the card ----
    t = time.perf_counter()
    train = train_phase(dev, scene, grasp)
    log(f"phase 10: {time.perf_counter() - t:.1f} s; train summary {json.dumps(train)}")

    # ---- phase 11: the shipped cascades through the evaluation harness ----
    t = time.perf_counter()
    evaluation = eval_phase(dev)
    log(f"phase 11: {time.perf_counter() - t:.1f} s; eval summary {json.dumps(evaluation)}")

    # ---- phase 12: the sapien family ----
    t = time.perf_counter()
    sapien = sapien_phase(dev)
    log(f"phase 12: {time.perf_counter() - t:.1f} s; sapien summary {json.dumps(sapien)}")

    # ---- phase 13: multi-device, two ranks on the card ----
    t = time.perf_counter()
    multi = multi_device_phase(dev, final)
    log(f"phase 13: {time.perf_counter() - t:.1f} s; multi-device summary {json.dumps(multi)}")

    # ---- phase 14: the model-building tools ----
    t = time.perf_counter()
    tools = tools_phase(dev)
    log(f"phase 14: {time.perf_counter() - t:.1f} s ("
        f"{', '.join(f'{k[:-2]} {v:.1f} s' for k, v in tools.items() if k.endswith('_s'))}); tools summary "
        f"{json.dumps({k: v for k, v in tools.items() if k != 'k_truncation'})}")
    log(f"chip_smoke: {time.perf_counter() - t_start:.1f} s in all")

    src = "diffusion_edf_tpu_torch/csrc/"
    # every kernel's own keys keep their meaning: the pick tensor field (K1 and K3 given its own mask, as the
    # path runs them) and the launches of the path first measured on it; the place shapes and the place
    # request's launches stand beside them, in by_shape and launches_by_path
    shapes = ("tensor_field", "place_tensor_field", "keypoint_tensor_field", "sapien_key_field",
              "sapien_key_field_seeded")
    kernels = [
        dict(name="edge_kernel", route="cuda", source=src + "edge_kernel.cu",
             replaces="diffusion_edf_tpu/nn/edge_kernel.py:477", launches=launches, max_abs_err=max_err,
             launches_by_path=dict(pick_lowres_stage=launches, place_request=count8["edge_kernel"],
                                   captured_pick_lowres_stage=runtime["pick_lowres_kernel"]["launches"]["replayed"][
                                       "edge_kernel"],
                                   captured_place_request=runtime["place_request_kernel"]["launches"]["replayed"][
                                       "edge_kernel"],
                                   eval_pick_cascade=evaluation["pick"]["launches"]["edge_kernel"],
                                   eval_place_cascade=evaluation["place"]["launches"]["edge_kernel"],
                                   sapien_lowres_stage=sapien["stage"]["launches"]["kernel"]["edge_kernel"],
                                   seed_sharded_stage_by_rank=multi["seed_sharded_stage"]["launches"],
                                   query_sharded_score_by_rank=multi["sharded_score"]["query_kernel"]["launches"],
                                   scene_sharded_score_by_rank=multi["sharded_score"]["scene_kernel"]["launches"],
                                   cascade_dump=sum(v["edge_kernel"]
                                                    for v in tools["cascade_dump"]["launches"].values()),
                                   critic_cascade_eval=(tools["critic"]["energy_launches"]["kernel"]["edge_kernel"]
                                                        + tools["critic"]["main_launches"]["edge_kernel"]),
                                   schedule_sweep={k: v["edge_kernel"] for k, v in tools["sweep"]["launches"].items()},
                                   train_eval_loop=tools["loop"]["launches"]["edge_kernel"],
                                   k_truncation=tools["k_truncation"]["launches"]["edge_kernel"],
                                   family_scores={k: v["launches"]["edge_kernel"]
                                                  for k, v in tools["family_scores"].items()}),
             by_shape={n: k1[n] for n in shapes}, **k1["tensor_field"]),
        dict(name="edge_kernel_bf16", route="cuda", source=src + "edge_kernel.cu",
             replaces="diffusion_edf_tpu/nn/edge_kernel.py:568", launches=count5["edge_kernel_bf16"],
             max_abs_err=k2_err, **k2["tensor_field"]),
        dict(name="fused_attention", route="cuda", source=src + "fused_attention.cu",
             replaces="diffusion_edf_tpu/nn/fused_attention.py:331", launches=count4["fused_attention"],
             max_abs_err=k3_err, launches_by_path=dict(
                 pick_request=count4["fused_attention"], place_request=count8f["fused_attention"],
                 captured_pick_lowres_stage=runtime["pick_lowres_fused"]["launches"]["replayed"]["fused_attention"],
                 sapien_lowres_stage=sapien["stage"]["launches"]["fused"]["fused_attention"],
                 query_sharded_score_by_rank=multi["sharded_score"]["query_fused"]["launches"],
                 critic_cascade_eval=tools["critic"]["energy_launches"]["fused"]["fused_attention"]),
             by_shape={n: k3[n] for n in shapes}, **k3["tensor_field"]),
        # no TPU kernel: the JAX package leaves the backward of its gathers to XLA.  Its path is training: the
        # launches of the captured pick_lowres epoch (its capture; the replays count none), and beside them those
        # of every other training run, each read from that run alone
        dict(name="gather_last_t", route="cuda", source=src + "gather.cu", replaces=None,
             launches=train["pick_lowres_captured"]["gather_launches"]["capturing_epoch"],
             launches_by_path=dict(
                 captured_train_epoch={n: train[f"{n}_captured"]["gather_launches"] for n, _ in TRAIN_RUNTIME_CASES},
                 pick_lowres_train=train["pick_lowres_train"]["launches"]["gather_last_t"],
                 pick_ebm_train=train["pick_ebm_train"]["launches"]["gather_last_t"],
                 critic_finetune=tools["critic"]["train_launches"]["gather_last_t"],
                 train_eval_loop=tools["loop"]["launches"]["gather_last_t"]),
             by_shape=gathers),
    ]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
