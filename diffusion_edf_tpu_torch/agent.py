"""Inference agent: one or more cascade stages of annealed Langevin sampling,
then an optional EBM critic that ranks the final poses by energy (counterpart
of the JAX package's ``agent.py``).  Per stage the scene and grasp features
are extracted once, then the rollout runs on the model's device; the final
pose of one stage seeds the next.

``sample_batch`` serves R requests that share a diffusion config with one
score evaluation per Langevin step for all of them: the request axis is
folded into the rows of the key tensor field (each query point still attends
only to its own request's key points), so the edge kernels see R times the
rows of one request.  ``sample`` is ``sample_batch`` of one request.

Each bundle, and the critic, has a :class:`_BundleRuntime` (the
counterpart of the JAX package's), built once with the agent: its four
entry points (``extract_key``, ``extract_query``, ``rollout``, ``energy``)
serve ``sample`` and ``sample_batch`` alike, since the request count is
part of an entry's shape (the JAX runtime keeps a ``_b`` copy of each,
``jax.vmap`` over the requests, another program).  They hold one entry
per input shape, each with static buffers and ``graphs.Program``s:
on CUDA a graph captured at the entry's first call (one for the whole
extraction or energy, one for each variant of the Langevin step: with noise,
and at temperature 0), replayed at every later call; on the CPU the same
entries run eagerly.  ``cache_sizes()`` counts the entries, as the JAX
runtime counts its compiled executables: after a :meth:`DiffusionEdfAgent.warmup`
with the shapes of later calls, those calls add none.  An entry is dropped
when its bundle's parameters are written (their version counters), moved,
or when the model's ``edge_impl`` or training mode changes.

Given a mesh, each Langevin rollout is seed-sharded over its ``data`` axis
(the counterpart of the JAX package's ``sharded_langevin_sample``): every
rank extracts the features, rolls out its block of every request's seeds
(padded to a multiple of the axis size) and gathers the final poses (and
the trajectory); the critic and the next stage see all of them.  In the
runtime a rank's rollout entry holds its block: the step graphs draw
nothing and run no collective (the noise of the whole padded batch is
drawn before them and each step reads its block, as ``langevin_sample(
seed_block=)`` draws it), and the gather is one more program after them,
on CUDA a graph over the mesh's NCCL groups (an agent over gloo groups on
CUDA raises).  Extraction and the critic's energies are replicated: the
same entries as without a mesh.  An agent built with ``use_runtime=False``
runs every stage eagerly (``parallel/sharded.py::sharded_langevin_sample``
with a mesh): the reference.
"""
from __future__ import annotations

import dataclasses
import threading
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from .data import FeaturedPoints, stack_points
from .diffusion.langevin import (N_COLUMNS, LangevinSchedule, build_schedule, draws_noise, langevin_sample,
                                 langevin_step, schedule_table)
from .graphs import Program, copy_into, pool_bytes
from .nn import cuda_build
from .parallel.mesh import Mesh, gather_blocks, pad_to_multiple, require_capturable
from .parallel.sharded import sharded_langevin_sample
from .train.data import PointCloud, TargetPoseDemo, compose_proc_fn, pad_pointcloud
from .train.factory import build_score_model
from .train.trainer import load_configs
from .utils.profiling import span
from .weights import init_params, load_params_npz

__all__ = ["ModelBundle", "DiffusionEdfAgent", "load_model_bundle", "load_params_npz"]


@dataclasses.dataclass
class ModelBundle:
    model: Any
    ang_mult: float
    lin_mult: float
    n_scene_pad: int = 2048
    n_grasp_pad: int = 512

    @property
    def device(self) -> torch.device:
        return next(self.model.parameters()).device


def load_model_bundle(
    configs_root_dir: str,
    checkpoint: Optional[str] = None,
    train_configs_file: str = "train_configs.yaml",
    task_configs_file: str = "task_configs.yaml",
    n_scene_pad: int = 2048,
    n_grasp_pad: int = 512,
    init_seed: int = 0,
    device: Union[str, torch.device] = "cuda",
    edge_impl: Optional[str] = None,
) -> ModelBundle:
    """Build a model from its config directory, with seeded random weights
    or the flat ``.npz`` ``checkpoint``, on ``device``.  ``edge_impl``
    selects the attention edge segment (see ``nn/attention.py``)."""
    _, _, model_cfg = load_configs(configs_root_dir, train_configs_file, task_configs_file)
    model = build_score_model(model_cfg["model_name"], model_cfg["model_kwargs"], edge_impl=edge_impl)
    init_params(model, torch.Generator().manual_seed(init_seed))
    if checkpoint is not None:
        load_params_npz(model, checkpoint)
    model.to(device).eval()
    sh = model_cfg["model_kwargs"]["score_head_kwargs"]
    return ModelBundle(
        model=model, ang_mult=float(sh["ang_mult"]), lin_mult=float(sh["lin_mult"]),
        n_scene_pad=n_scene_pad, n_grasp_pad=n_grasp_pad,
    )


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _kept_points(key_ms: Sequence[FeaturedPoints]) -> int:
    """The points the key clouds keep (their masks), summed over scales and
    requests: one read of the device."""
    return int(torch.stack([k.mask.sum() for k in key_ms]).sum())


def _padded(bundle: ModelBundle, preps, device: Union[str, torch.device] = "cpu"):
    """Every request's scene and grasp cloud (``preps``: processed (scene,
    grasp) pairs), padded to the bundle's sizes on ``device``."""
    return ([pad_pointcloud(s, bundle.n_scene_pad, device) for s, _ in preps],
            [pad_pointcloud(g, bundle.n_grasp_pad, device) for _, g in preps])


def _key_scales(model, scenes: List[FeaturedPoints]) -> List[FeaturedPoints]:
    """The key clouds of every request's padded scene, each scale stacked over requests."""
    return [stack_points(scale) for scale in zip(*(model.get_key_pcd_multiscale(c) for c in scenes))]


def _query(model, grasps: List[FeaturedPoints]) -> FeaturedPoints:
    """The query of every request's padded grasp cloud, stacked over requests."""
    return stack_points([model.get_query_pcd(c) for c in grasps])


ENTRY_POINTS = ("extract_key", "extract_query", "rollout", "energy")


@dataclasses.dataclass
class _Entry:
    """An extraction entry (one padded cloud a request, static; the program
    stacks its outputs over requests), or an energy entry (the poses, static;
    ``src`` the extraction outputs that its program reads)."""

    inputs: List[Any]
    program: Program
    src: Any = None


class _Rollout:
    """The Langevin rollout of one shape: static poses, step counter,
    schedule table, noise draws and trajectory, and one program for each
    variant of the step the schedule's pattern holds (True: with noise).
    With a mesh the poses and the trajectory are this rank's block of the
    seeds padded to ``n``, the noise is the whole padded batch's, and one
    more program gathers the blocks."""

    def __init__(self, score_fn, src, R: int, nT: int, pattern: Tuple[bool, ...], record: bool,
                 device: torch.device, pool, mesh: Optional[Mesh] = None):
        S = len(pattern)
        self.src, self.pattern, self.device, self.pool, self.mesh = src, pattern, device, pool, mesh
        self.shape = (R, nT, S, record)
        self.score_fn = score_fn
        W = mesh.axis_size("data") if mesh is not None else 1
        self.nT, self.n = nT, nT + (-nT) % W
        self.blk = self.n // W
        self.start = mesh.index("data") * self.blk if mesh is not None else 0
        self.T = torch.zeros(R, self.blk, 7, device=device)
        self.step = torch.zeros(1, dtype=torch.long, device=device)
        self.table = torch.zeros(S, N_COLUMNS, device=device)
        self.noise = torch.zeros(S, 2, R, self.n, 3, device=device) if any(pattern) else None
        self.traj = torch.zeros(S + 1, R, self.blk, 7, device=device) if record else None
        self.steps: Dict[bool, Program] = {}
        self.gather: Optional[Program] = None

    def _step_fn(self, hot: bool):
        # the step closes over the buffers, not over self: a cycle would leave the entry's graphs to the
        # garbage collector, which may run while another graph is being captured
        score_fn, T, table, step, traj = self.score_fn, self.T, self.table, self.step, self.traj
        noise, start, blk = self.noise if hot else None, self.start, self.blk

        def fn():
            langevin_step(score_fn, T, table, step,
                          None if noise is None else noise.index_select(0, step)[0].narrow(-2, start, blk), traj)
        return fn

    def _gather_fn(self):
        T, traj, group = self.T, self.traj, self.mesh.group("data")

        def fn():
            return gather_blocks(T, group, -2), None if traj is None else gather_blocks(traj, group, -2)
        return fn

    def run(self, T0: torch.Tensor, table: np.ndarray, generator: Optional[torch.Generator]):
        if self.mesh is not None:
            T0 = pad_to_multiple(T0, self.n // self.blk, dim=-2)[0].narrow(-2, self.start, self.blk)
        self.T.copy_(T0)
        self.step.zero_()
        self.table.copy_(torch.as_tensor(table))
        if self.traj is not None:
            self.traj[0].copy_(self.T)
        # the draws the eager rollout makes, in its order: an angular then a linear block a step with noise
        for i, hot in enumerate(self.pattern):
            if hot:
                self.noise[i, 0].normal_(generator=generator)
                self.noise[i, 1].normal_(generator=generator)
        for hot in self.pattern:
            program = self.steps.get(hot)
            if program is None:  # its first run is this step's
                self.steps[hot] = Program(self._step_fn(hot), self.device, self.pool, entry="rollout",
                                          shape=(*self.shape, hot))
            else:
                program()
        if self.mesh is None:
            return self.T, self.traj
        if self.gather is None:
            self.gather = Program(self._gather_fn(), self.device, self.pool, mesh=self.mesh, entry="rollout",
                                  shape=(*self.shape, "gather"))
            T, traj = self.gather.out
        else:
            T, traj = self.gather()
        return T.narrow(-2, 0, self.nT), None if traj is None else traj.narrow(-2, 0, self.nT)


class _BundleRuntime:
    """The compiled sampling path of one bundle (see the module docstring),
    its rollouts seed-sharded over ``mesh``'s ``data`` axis if given.
    Callers hold ``lock`` from :meth:`extract` until they have read what
    :meth:`rollout` or :meth:`energy` returned: the buffers are shared."""

    def __init__(self, bundle: ModelBundle, mesh: Optional[Mesh] = None):
        self.bundle, self.mesh = bundle, mesh
        self.lock = threading.RLock()
        self._attention = [m for m in bundle.model.modules() if hasattr(m, "edge_impl")]
        self._stamp = None
        self._drop()

    def _drop(self) -> None:
        self.entries: Dict[str, Dict[tuple, Any]] = {name: {} for name in ENTRY_POINTS}
        dev = self.bundle.device
        self.pool = torch.cuda.graph_pool_handle() if dev.type == "cuda" else None

    def _check(self) -> None:
        """Drop every entry when the bundle's tensors were written or moved, or
        its mode or ``edge_impl`` changed: a graph reads the operands derived
        from the weights that it saw."""
        model = self.bundle.model
        stamp = (model.training, tuple(m.edge_impl for m in self._attention),
                 tuple((id(t), t.data_ptr(), t._version) for t in (*model.parameters(), *model.buffers())))
        if stamp != self._stamp:
            if self._stamp is not None:
                self._drop()
            self._stamp = stamp

    def cache_sizes(self) -> Dict[str, int]:
        """The number of entries (shapes) of each entry point."""
        return {name: len(self.entries[name]) for name in ENTRY_POINTS}

    def pool_bytes(self) -> Optional[int]:
        """Device memory of the runtime's graph pool (None on the CPU)."""
        return pool_bytes(self.pool)

    def _extraction(self, name: str, clouds: List[FeaturedPoints], fn) -> Any:
        """``fn(model, clouds)`` through the entry of ``name`` for the clouds' shape."""
        key = (len(clouds), clouds[0].n)
        entry = self.entries[name].get(key)
        if entry is not None:
            copy_into(entry.inputs, clouds)
            return entry.program()
        dev, model = self.bundle.device, self.bundle.model
        inputs = [FeaturedPoints(x=c.x.to(dev), f=c.f.to(dev), mask=c.mask.to(dev)) for c in clouds]
        entry = self.entries[name][key] = _Entry(inputs, Program(lambda: fn(model, inputs), dev, self.pool,
                                                                 entry=name, shape=key))
        return entry.program.out

    def extract(self, preps):
        """Every request's key scales and query (``preps``: processed (scene,
        grasp) pairs), stacked over requests: the static outputs of the
        ``extract_key`` and ``extract_query`` entries."""
        self._check()
        scenes, grasps = _padded(self.bundle, preps)
        return self._extraction("extract_key", scenes, _key_scales), self._extraction("extract_query", grasps, _query)

    def rollout(self, key_ms, query, T0: torch.Tensor, sched: LangevinSchedule, generator, record: bool):
        """The Langevin rollout from ``T0`` (R, nT, 7) on :meth:`extract`'s
        outputs: the static (final poses, trajectory (S + 1, R, nT, 7) or
        None).  Its noise is what :func:`langevin_sample` draws from
        ``generator``."""
        R, nT = T0.shape[:2]
        pattern = tuple(bool(h) for h in draws_noise(sched))
        key = (R, nT, len(pattern), record, pattern)
        entry = self.entries["rollout"].get(key)
        if entry is None or entry.src[0] is not key_ms or entry.src[1] is not query:
            model = self.bundle.model

            def score_fn(T, t):
                return model.score(T, key_ms, query, t)

            entry = self.entries["rollout"][key] = _Rollout(score_fn, (key_ms, query), R, nT, pattern, record,
                                                            self.bundle.device, self.pool, self.mesh)
        return entry.run(T0, schedule_table(sched, self.bundle.ang_mult, self.bundle.lin_mult), generator)

    def energy(self, key_ms, query, T: torch.Tensor) -> torch.Tensor:
        """The energies (R, nT) of the poses ``T`` on :meth:`extract`'s outputs."""
        R, nT = T.shape[:2]
        entry = self.entries["energy"].get((R, nT))
        if entry is not None and entry.src[0] is key_ms and entry.src[1] is query:
            copy_into(entry.inputs, [T])
            return entry.program()
        dev, model = self.bundle.device, self.bundle.model
        Ts, ones = T.to(dev).clone(), torch.ones(R, nT, device=dev)
        program = Program(lambda: model.energy(Ts, key_ms, query, ones), dev, self.pool, entry="energy",
                          shape=(R, nT))
        self.entries["energy"][(R, nT)] = _Entry([Ts], program, (key_ms, query))
        return program.out


class DiffusionEdfAgent:
    def __init__(
        self,
        models: Sequence[ModelBundle],
        preprocess_config: Sequence[Dict],
        unprocess_config: Sequence[Dict],
        preprocess_seed: Optional[int] = None,
        critic: Optional[ModelBundle] = None,
        mesh: Optional[Mesh] = None,
        use_runtime: bool = True,
    ):
        """``preprocess_seed`` seeds the jitter ops of the preprocessing;
        ``critic`` is an EBM model whose energy orders the sampled poses;
        ``mesh`` shards the seeds of every rollout over its ``data`` axis
        (every rank of the mesh calls :meth:`sample` with the same
        arguments and a generator in the same state, and gets the same
        result: one process's on the seeds padded to a multiple of the axis
        size).  On CUDA the runtime holds the mesh's collectives in CUDA
        graphs, so its groups must be NCCL (a gloo mesh raises here).
        ``use_runtime=False`` runs every stage eagerly (extraction,
        ``langevin_sample`` or ``sharded_langevin_sample``, energy): the
        reference the runtime is held to."""
        self.models = list(models)
        self.mesh = mesh
        self.critic = critic
        self.use_runtime = use_runtime
        if use_runtime:
            for b in self.models:
                require_capturable(mesh, b.device, "DiffusionEdfAgent(mesh=)")
        self._runtimes = [_BundleRuntime(b, mesh) for b in self.models]
        self._critic_runtime = _BundleRuntime(critic) if critic is not None else None
        self.proc_fn = compose_proc_fn(preprocess_config, seed=preprocess_seed)
        self.unrescale = 1.0  # the unprocess pipeline is a rescale (cm -> m) of poses
        for op in unprocess_config:
            if op["name"] == "rescale":
                self.unrescale *= float(op["kwargs"]["rescale_factor"])

    def _prep(self, scene_pcd: PointCloud, grasp_pcd: PointCloud):
        with span("agent.preprocess"):
            demo = self.proc_fn(TargetPoseDemo(scene_pcd=scene_pcd, grasp_pcd=grasp_pcd,
                                               target_poses=np.zeros((1, 7))))
        return demo.scene_pcd, demo.grasp_pcd

    def sample(
        self,
        scene_pcd: PointCloud,
        grasp_pcd: PointCloud,
        Ts_init: np.ndarray,  # (nT, 7) in raw (metre) units
        N_steps_list: Sequence[Sequence[int]],
        timesteps_list: Sequence[Sequence[float]],
        temperatures_list: Sequence[Union[float, Sequence[float]]],
        diffusion_schedules_list: Sequence[Sequence[Sequence[float]]],
        log_t_schedule: bool = True,
        time_exponent_temp: float = 1.0,
        time_exponent_alpha: float = 0.5,
        generator: Optional[torch.Generator] = None,
        record_trajectory: bool = True,
    ) -> Tuple[np.ndarray, PointCloud, PointCloud, Dict[str, Any]]:
        """Cascaded annealed Langevin sampling of one request.  ``generator``
        draws the Langevin noise and must live on the models' device; without
        one, a generator is seeded from ``np.random``.  Returns (trajectory
        (steps + stages, nT, 7) in processed (cm) units, processed scene,
        processed grasp, info with per-stage host timings: the durations of
        the ``agent.extract``, ``agent.rollout`` and ``agent.critic`` spans;
        and ``info["key_points"]``, each stage's kept key points).
        With a critic the trajectory's pose axis is sorted by the energy of
        the final poses, ascending, and ``info["energy"]`` holds the sorted
        energies."""
        scene_p, grasp_p = self._prep(scene_pcd, grasp_pcd)
        scheds = self._schedules(N_steps_list, timesteps_list, temperatures_list, diffusion_schedules_list,
                                 log_t_schedule, time_exponent_temp, time_exponent_alpha)
        traj, info = self._run([(scene_p, grasp_p)], np.asarray(Ts_init, dtype=np.float32)[None], scheds, generator,
                               record_trajectory)
        if "energy" in info:
            info["energy"] = info["energy"][0]
        return traj[0], scene_p, grasp_p, info

    def sample_batch(
        self,
        scene_pcds: Sequence[PointCloud],
        grasp_pcds: Sequence[PointCloud],
        Ts_init: np.ndarray,  # (R, nT, 7) in raw (metre) units
        N_steps_list: Sequence[Sequence[int]],
        timesteps_list: Sequence[Sequence[float]],
        temperatures_list: Sequence[Union[float, Sequence[float]]],
        diffusion_schedules_list: Sequence[Sequence[Sequence[float]]],
        log_t_schedule: bool = True,
        time_exponent_temp: float = 1.0,
        time_exponent_alpha: float = 0.5,
        generator: Optional[torch.Generator] = None,
        record_trajectory: bool = True,
        n_seeds: Optional[Sequence[int]] = None,
    ) -> Tuple[np.ndarray, Dict[str, Any]]:
        """R independent (scene, grasp, seeds) requests that share the
        diffusion config, sampled together: extraction runs per request, every
        Langevin step and the critic once for all.  Returns (trajectory (R,
        steps + stages, nT, 7) in processed (cm) units, info; with a critic
        every request's pose axis is sorted by its energies, ascending, and
        ``info["energy"]`` is (R, nT)).  ``n_seeds`` gives each request's
        count of real seeds when the caller padded the seed axis to a common
        nT: the critic gives the padding seeds of request i (those past
        ``n_seeds[i]``) energy +inf, so they sort after every real seed.

        Noise: every step draws one (R, nT, 3) block for the angular part,
        then one for the linear part, from ``generator``, request after
        request; so R = 1 with a generator of a given seed gives what
        ``sample`` gives with that seed."""
        assert len(scene_pcds) == len(grasp_pcds) == np.asarray(Ts_init).shape[0]
        preps = [self._prep(s, g) for s, g in zip(scene_pcds, grasp_pcds)]
        scheds = self._schedules(N_steps_list, timesteps_list, temperatures_list, diffusion_schedules_list,
                                 log_t_schedule, time_exponent_temp, time_exponent_alpha)
        return self._run(preps, np.asarray(Ts_init, dtype=np.float32), scheds, generator, record_trajectory, n_seeds)

    def _schedules(self, N_steps_list, timesteps_list, temperatures_list, diffusion_schedules_list, log_t_schedule,
                   time_exponent_temp, time_exponent_alpha) -> List[LangevinSchedule]:
        """Each stage's Langevin schedule from the diffusion config of a call."""
        return [build_schedule(
            diffusion_schedules=diffusion_schedules_list[mi], N_steps=N_steps_list[mi], timesteps=timesteps_list[mi],
            ang_mult=b.ang_mult, lin_mult=b.lin_mult, temperatures=temperatures_list[mi], log_t_schedule=log_t_schedule,
            time_exponent_temp=time_exponent_temp, time_exponent_alpha=time_exponent_alpha,
        ) for mi, b in enumerate(self.models)]

    @torch.no_grad()
    def _run(self, preps, Ts_init: np.ndarray, scheds: List[LangevinSchedule], generator, record_trajectory: bool,
             n_seeds: Optional[Sequence[int]] = None):
        R, nT = Ts_init.shape[:2]
        pose_scale = 1.0 / self.unrescale if self.unrescale != 1.0 else 1.0
        T0 = np.concatenate([Ts_init[..., :4], Ts_init[..., 4:] * np.float32(pose_scale)], axis=-1)
        info: Dict[str, Any] = {"extract_s": [], "key_points": [], "rollout_s": [], "steps": []}
        trajs = []
        T = None
        for mi, (bundle, sched) in enumerate(zip(self.models, scheds)):
            model, dev = bundle.model, bundle.device
            T = torch.as_tensor(T0, device=dev) if T is None else T.to(dev)
            if generator is None:
                generator = torch.Generator(device=dev).manual_seed(int(np.random.randint(0, 2**31 - 1)))
            extract = span("agent.extract", device_work=True, stage=mi, model=type(model).__name__)
            rollout = span("agent.rollout", device_work=True, stage=mi, steps=len(sched.t))
            if self.use_runtime:
                rt = self._runtimes[mi]
                with rt.lock:
                    with extract:
                        key_ms, query = rt.extract(preps)
                        _sync(dev)
                        extract.attrs["key_points"] = _kept_points(key_ms)
                    with rollout:
                        T, traj = rt.rollout(key_ms, query, T, sched, generator, record_trajectory)
                        T = T.clone()
                        traj = traj.transpose(0, 1).cpu().numpy() if record_trajectory else None
                        _sync(dev)
            else:
                with extract:
                    scenes, grasps = _padded(bundle, preps, dev)
                    key_ms, query = _key_scales(model, scenes), _query(model, grasps)
                    _sync(dev)
                    extract.attrs["key_points"] = _kept_points(key_ms)

                def score_fn(Ts, t, model=model, key_ms=key_ms, query=query):
                    return model.score(Ts, key_ms, query, t)

                with rollout:
                    if self.mesh is None:
                        T, traj = langevin_sample(score_fn, T, sched, bundle.ang_mult, bundle.lin_mult,
                                                  generator=generator, record_trajectory=record_trajectory)
                    else:
                        T, traj = sharded_langevin_sample(self.mesh, score_fn, generator, T, sched, bundle.ang_mult,
                                                          bundle.lin_mult, record_trajectory=record_trajectory)
                    traj = traj.transpose(0, 1).cpu().numpy() if record_trajectory else None
                    _sync(dev)
            info["extract_s"].append(extract.seconds)
            info["key_points"].append(extract.attrs["key_points"])
            info["rollout_s"].append(rollout.seconds)
            info["steps"].append(len(sched.t))
            trajs.append(traj if record_trajectory else T[:, None].cpu().numpy())
        Ts_out = np.concatenate(trajs, axis=1)  # (R, steps + stages, nT, 7)
        if self.critic is not None:
            c = self.critic
            dev = c.device
            with span("agent.critic", device_work=True) as critic:
                Tl = torch.as_tensor(np.ascontiguousarray(Ts_out[:, -1]), device=dev)
                if self.use_runtime:
                    rt = self._critic_runtime
                    with rt.lock:
                        energy = rt.energy(*rt.extract(preps), Tl).cpu().numpy()
                else:
                    scenes, grasps = _padded(c, preps, dev)
                    energy = c.model.energy(Tl, _key_scales(c.model, scenes), _query(c.model, grasps),
                                            torch.ones(R, nT, device=dev)).cpu().numpy()
            info["critic_s"] = critic.seconds
            if n_seeds is not None:
                energy[np.arange(nT)[None, :] >= np.asarray(n_seeds)[:, None]] = np.inf
            order = np.argsort(energy, axis=-1)
            Ts_out = np.take_along_axis(Ts_out, order[:, None, :, None], axis=2)
            info["energy"] = np.take_along_axis(energy, order, axis=-1)
        return Ts_out, info

    def warmup(self, scene_pcd: PointCloud, grasp_pcd: PointCloud, n_seeds: int = 1,
               diffusion_configs: Optional[Dict] = None, record_trajectory: bool = False) -> None:
        """Build the CUDA kernels (``nvcc`` at first use, ``nn/cuda_build.py``)
        and prepare every runtime entry that requests of these shapes need:
        one request of ``n_seeds`` seeds with ``diffusion_configs`` (the
        ``N_steps_list`` ... dict later :meth:`sample` calls pass; default a
        one-step schedule) and ``record_trajectory``.  That fills the operand
        caches of every attention and, on CUDA, captures each entry's graphs,
        so that later calls of the same shapes capture nothing
        (``cache_sizes()`` of every runtime stays as it is)."""
        if any(b.device.type == "cuda" for b in self.models):
            cuda_build.build_all()
        Ts = np.concatenate([np.tile([[1.0, 0, 0, 0]], (n_seeds, 1)), np.zeros((n_seeds, 3))], -1)
        n = len(self.models)
        cfg = diffusion_configs or dict(N_steps_list=[[1]] * n, timesteps_list=[[0.01]] * n,
                                        temperatures_list=[[1.0]] * n, diffusion_schedules_list=[[[1.0, 0.9]]] * n)
        self.sample(scene_pcd, grasp_pcd, Ts, record_trajectory=record_trajectory, **cfg)

    def unprocess_poses(self, Ts: np.ndarray) -> np.ndarray:
        """cm -> metres on the translation part, in float64: metres scaled
        back to centimetres give the float32 poses the program computed
        exactly (a float32 product rounds a quarter of them by an ulp)."""
        Ts = np.asarray(Ts, dtype=np.float64)
        return np.concatenate([Ts[..., :4], Ts[..., 4:] * self.unrescale], axis=-1)
