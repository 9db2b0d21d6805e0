"""Seed-sharded Langevin sampling, the scene-sharded score and the
data-parallel train step over a :class:`..parallel.mesh.Mesh`
(counterpart of the JAX package's ``parallel/sharded.py``).

Parameters and scene features are replicated (every rank holds and
computes the same); the sharded axis is the seeds (sampling), the scene's
points (the scene-sharded score) or the diffused poses (training).  Each
rank runs the normal single-process code on its block, with the edge
kernels of its ``edge_impl``; the collectives are those of
``parallel/mesh.py``.

Each function has a compiled counterpart, as the JAX package jits each:
the agent's runtime rolls out a rank's block of the seeds
(``agent.py::_BundleRuntime``), :func:`scene_sharded_score_fn` holds one
``graphs.Program`` a shape, and the trainer one a demo shape (the step of
:func:`make_sharded_train_step`).  On CUDA over NCCL groups each program
is a CUDA graph with the collectives inside it; on the CPU it runs eagerly.
``use_runtime=False`` (and :func:`sharded_langevin_sample`) run eagerly: the
reference.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

from ..data import FeaturedPoints
from ..diffusion.langevin import LangevinSchedule, langevin_sample
from ..geom import so3
from ..graphs import Program, copy_into
from ..ops.neighbors import pairwise_sqdist
from .mesh import Mesh, gather_batch, gather_blocks, pad_to_multiple, replicate, shard_batch, use_mesh

__all__ = [
    "pad_seeds_to_multiple", "sharded_langevin_sample", "split_scene_for_mesh", "scene_sharded_score_fn",
    "make_sharded_train_step", "cap_bound_rows", "valid_points_by_block",
]


def pad_seeds_to_multiple(T_seed: torch.Tensor, n: int, dim: int = 0) -> Tuple[torch.Tensor, int]:
    """Pad the seed axis ``dim`` to a multiple of ``n`` (repeating the last
    seed); returns (padded, original count)."""
    return pad_to_multiple(T_seed, n, dim)


def sharded_langevin_sample(
    mesh: Mesh,
    score_fn: Callable,
    generator: Optional[torch.Generator],
    T_seed: torch.Tensor,  # ([R,] nT, 7)
    schedule: LangevinSchedule,
    ang_mult: float,
    lin_mult: float,
    record_trajectory: bool = False,
):
    """Langevin rollout with the seeds (axis -2 of ``T_seed``) sharded over
    the mesh's ``"data"`` axis: the seeds are padded to a multiple of the
    axis size, each rank rolls out its block with ``score_fn`` (closing over
    its replicated parameters and features) and no collective, and the
    final poses (and the trajectory, if asked) are gathered at the end.

    Every rank holds a generator in the same state; each step it draws the
    noise of the whole padded batch and keeps its block.  So the result is
    the one-process rollout of the padded batch with the same generator.
    It is not that of the unpadded batch: ``torch.randn`` of a longer
    shape does not begin with the numbers of a shorter one.  Returns
    ``(T_final, trajectory or None)``, the padding dropped."""
    W = mesh.axis_size("data")
    Tp, n_orig = pad_seeds_to_multiple(T_seed, W, dim=-2)
    n = Tp.shape[-2]
    blk = n // W
    start = mesh.index("data") * blk
    T, traj = langevin_sample(score_fn, Tp.narrow(-2, start, blk), schedule, ang_mult, lin_mult,
                              generator=generator, record_trajectory=record_trajectory, seed_block=(n, start))
    group = mesh.group("data")
    T = gather_blocks(T, group, -2).narrow(-2, 0, n_orig)
    if record_trajectory:
        traj = gather_blocks(traj, group, -2).narrow(-2, 0, n_orig)
    return T, traj


def split_scene_for_mesh(
    key_ms: List[FeaturedPoints],
    n_shards: int,
    min_per_shard: Optional[Sequence[int]] = None,
) -> List[FeaturedPoints]:
    """Pad each scale's point count (axis -2 of ``x``, clouds alone or
    stacked over requests) to a multiple of ``n_shards``, the padded points
    masked off, so the cloud splits into equal blocks.

    ``min_per_shard``: per scale, the fewest points a block holds (pass each
    scale's neighbour cap ``k``), so every rank's radius search sees as many
    candidates as the cap, as the JAX package's shard-local search requires
    (``k <= n_src``); the block shapes then match the JAX package's."""
    out = []
    for i, fp in enumerate(key_ms):
        n = fp.n
        target = max(n, n_shards * (min_per_shard[i] if min_per_shard else 0))
        target += (-target) % n_shards
        pad = target - n

        def p(a, fill, dim):
            if a is None or pad == 0:
                return a
            shape = list(a.shape)
            shape[dim] = pad
            return torch.cat([a, torch.full(shape, fill, dtype=a.dtype, device=a.device)], dim=dim)

        out.append(FeaturedPoints(x=p(fp.x, 0.0, -2), f=p(fp.f, 0.0, -2), mask=p(fp.mask, False, -1),
                                  w=p(fp.w, 0.0, -1)))
    return out


def _split_for_model(model, key_ms: List[FeaturedPoints], n_shards: int) -> List[FeaturedPoints]:
    """:func:`split_scene_for_mesh` with the model's neighbour caps as
    ``min_per_shard``."""
    k_ms = model.score_head.key_tensor_field.k_multiscale
    return split_scene_for_mesh(key_ms, n_shards, k_ms if len(k_ms) == len(key_ms) else None)


def _scene_block(fp: FeaturedPoints, parts: int, index: int) -> FeaturedPoints:
    blk = fp.n // parts
    cut = lambda a, dim: None if a is None else a.narrow(dim, index * blk, blk)  # noqa: E731
    return FeaturedPoints(x=cut(fp.x, -2), f=cut(fp.f, -2), mask=cut(fp.mask, -1), w=cut(fp.w, -1))


def scene_sharded_score_fn(
    mesh: Mesh,
    model,
    key_ms: List[FeaturedPoints],
    query: FeaturedPoints,
    scene_axis: str = "model",
    data_axis: str = "data",
    method: str = "score",
    use_runtime: bool = True,
):
    """Score function with the scene (key) cloud partitioned over
    ``scene_axis`` and the pose seeds over ``data_axis``:
    ``score(Ts (R, nT, 7), time (R, nT)) -> (ang, lin)`` on every rank,
    with ``key_ms`` and ``query`` stacked over requests as ``model.score``
    takes them (``method="energy"``: a critic's energies (R, nT)).

    ``model`` is built with ``key_tensor_field_kwargs["scene_axis_name"] =
    scene_axis`` (the same parameters as the replicated model; the name only
    adds the collectives of ``nn/attention.py``).  Each rank attends its own
    block of every scale (the dense ``null`` scale becomes blockwise dense
    attention), so a scene costs 1 / M of its points and edge work a rank.

    **Exactness.**  Each rank runs the radius search over its own block with
    the same per-scale cap ``k``, so the attended edge set is the union of
    per-block nearest-``k``: a superset of the replicated path's global
    nearest-``k`` wherever some query point's in-radius degree exceeds
    ``k``.  Where the radius (not the cap) binds, the result is the
    replicated path's up to summation order; otherwise the sharded path
    attends more in-radius edges and moves smoothly away from it (towards
    the cap-free limit, not wrong, but dependent on the shard count).  Size
    the caps so that truncation is rare.  Scales are padded so that every
    block holds at least ``k`` points (:func:`split_scene_for_mesh`).

    **Runtime** (``use_runtime=True``, the counterpart of the JAX
    function's ``jax.jit``): one ``graphs.Program`` a ``(Ts.shape,
    time.shape)`` (``score.entries``), whose first call runs the score
    eagerly under ``torch.no_grad()`` and, on CUDA, captures it (this rank's
    pose block, the softmax tail's collectives, ``copy_to_shards`` and the
    final gather) in one CUDA graph that later calls of the shape replay;
    the mesh's groups must be NCCL there (else it raises).  Every rank calls
    the score with the same shapes in the same order.  ``use_runtime=False``
    runs eagerly: the reference."""
    M = mesh.axis_size(scene_axis)
    local = [_scene_block(fp, M, mesh.index(scene_axis)) for fp in _split_for_model(model, key_ms, M)]

    def run(Ts: torch.Tensor, time: torch.Tensor):
        T_b, n = shard_batch(mesh, Ts, data_axis, dim=1)
        t_b, _ = shard_batch(mesh, time, data_axis, dim=1)
        with use_mesh(mesh):
            out = getattr(model, method)(T_b, local, query, t_b)
        if isinstance(out, torch.Tensor):
            return gather_batch(mesh, out, n, data_axis, dim=1)
        return tuple(gather_batch(mesh, o, n, data_axis, dim=1) for o in out)

    if not use_runtime:
        return run
    device = query.x.device
    pool = torch.cuda.graph_pool_handle() if device.type == "cuda" else None
    entries: Dict[tuple, Tuple[List[torch.Tensor], Program]] = {}

    def score(Ts: torch.Tensor, time: torch.Tensor):
        key = (tuple(Ts.shape), tuple(time.shape))
        entry = entries.get(key)
        if entry is None:
            inputs = [Ts.to(device, copy=True), time.to(device, copy=True)]

            def fn():
                with torch.no_grad():
                    return run(*inputs)
            entry = entries[key] = (inputs, Program(fn, device, pool, mesh=mesh))
            out = entry[1].out
        else:
            copy_into(entry[0], [Ts, time])
            out = entry[1]()
        return out.clone() if isinstance(out, torch.Tensor) else tuple(o.clone() for o in out)

    score.entries = entries
    return score


def cap_bound_rows(model, Ts: torch.Tensor, key_ms: List[FeaturedPoints], query: FeaturedPoints) -> int:
    """How many valid query rows (pose x query point, over the R requests)
    have more valid key points within some finite-radius scale's radius
    than that scale's neighbour cap: the rows where the scene-sharded score
    may attend more edges than the replicated one."""
    field = model.score_head.key_tensor_field
    x = so3.transform_points(query.x[:, None], Ts).reshape(Ts.shape[0], -1, 3)  # (R, nT*nQ, 3)
    valid = query.mask[:, None, :].expand(Ts.shape[0], Ts.shape[1], query.n).reshape(Ts.shape[0], -1)
    over = torch.zeros_like(valid)
    for n, fp in enumerate(key_ms):
        enc = getattr(field, f"parser_{n}")
        if hasattr(enc, "r_cutoff"):
            within = (pairwise_sqdist(x, fp.x) <= enc.r_cutoff ** 2) & fp.mask[:, None, :]
            over |= within.sum(-1) > enc.k
    return int((over & valid).sum())


def valid_points_by_block(model, key_ms: List[FeaturedPoints], n_shards: int) -> List[List[int]]:
    """The valid key points of every scale (outer) in each of the
    ``n_shards`` blocks (inner) that :func:`scene_sharded_score_fn` gives
    the ranks of its scene axis."""
    return [[int(_scene_block(fp, n_shards, i).mask.sum()) for i in range(n_shards)]
            for fp in _split_for_model(model, key_ms, n_shards)]


def make_sharded_train_step(mesh: Mesh, trainer) -> Callable[..., Dict[str, float]]:
    """Data-parallel :meth:`DiffusionEdfTrainer.step <..train.trainer.
    DiffusionEdfTrainer.step>` over the mesh's ``"data"`` axis; returns
    ``step(batch) -> stats``.

    Every rank makes the same draws with the same generator, scores its
    block of the diffused poses (n_schedules x n_samples_x_ref) and, for a
    critic, of the ranked poses; the blocks are gathered, so the loss and
    its statistics are one process's on every rank.  The gathered blocks'
    backward keeps each rank's own block, so each rank's gradient is its
    block's share, and an all-reduce sums them into one process's gradient;
    then every rank takes the same AMSGrad and EMA update.  The parameters
    are made equal (rank 0's) here and stay equal.

    With dropout on, every rank draws every mask from the trainer's
    generator, whose state is equal on every rank: the extractor's masks are
    one process's, and a mask over the per-pose rows of the score or the
    energy is drawn for the whole batch and narrowed to the rank's block
    (``parallel/mesh.py::pose_block``).  So the step is one process's step,
    dropout included, when the step's pose counts (the diffused poses, and a
    critic's ranked poses) are multiples of the axis size; otherwise it is
    one process's step on the batch padded as ``shard_batch`` pads it.

    The trainer's runtime (``use_runtime=True``, the default) compiles the
    step, as the JAX package jits it: one ``graphs.Program`` a demo shape
    holding the draws, the forward on the block, the gathers, the backward,
    the gradient all-reduce, AMSGrad and the EMA, on CUDA one CUDA graph
    over NCCL groups (gloo groups raise); ``step`` and
    ``trainer.train_epoch(mesh=mesh)`` replay it.  Every rank steps on the
    same demos in the same order."""
    with torch.no_grad():
        for t in trainer.params + trainer.ema:
            replicate(mesh, t)

    def step(batch) -> Dict[str, float]:
        return trainer.step(batch, mesh=mesh)

    return step
