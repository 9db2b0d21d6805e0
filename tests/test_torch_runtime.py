"""The agent's sampling runtime (``agent.py::_BundleRuntime``) on the CPU,
where its entries run eagerly with the static buffers and the step counter
on the device that the card captures: the rollout equals
``langevin_sample`` bit for bit, later calls of a warmed-up shape add no
entry, a write to the parameters drops the entries, ``warmup`` takes the JAX
package's arguments, and the runtime's cascade with critic and its batched
requests equal the eager agent's bit for bit.  The cascade against the JAX
agent is ``tests/test_torch_critic.py``'s, which goes through the runtime."""
import gc
import inspect
import weakref

import numpy as np
import pytest
import torch
import yaml

import __graft_entry__ as ge
from diffusion_edf_tpu.agent import DiffusionEdfAgent as JAgent
from diffusion_edf_tpu_torch.agent import ENTRY_POINTS, DiffusionEdfAgent, _BundleRuntime, load_model_bundle
from diffusion_edf_tpu_torch.diffusion.langevin import build_schedule, langevin_sample
from diffusion_edf_tpu_torch.graphs import Program
from diffusion_edf_tpu_torch.train.data import PointCloud

from .test_torch_agent import PREPROCESS, UNPROCESS, _clouds

torch.set_num_threads(1)

# a noisy segment, then one at temperature 0 (the shipped server.yaml's highres stage ends with one)
DIFF_CFG = dict(
    N_steps_list=[[3, 2]],
    timesteps_list=[[0.04, 0.02]],
    temperatures_list=[[1.0, 0.0]],
    diffusion_schedules_list=[[[1.0, 0.15], [0.15, 0.02]]],
    log_t_schedule=True,
    time_exponent_temp=1.0,
    time_exponent_alpha=0.5,
)
PADS = dict(n_scene_pad=256, n_grasp_pad=96)


def _config_dir(root, name, ebm=False):
    cfg = ge._model_config(tiny=True)
    if ebm:  # as configs/panda_mug/pick_ebm: no time encoding on the edges
        cfg["model_kwargs"]["score_head_kwargs"].update(ebm=True, edge_time_encoding=False)
    d = root / name
    d.mkdir()
    (d / "train_configs.yaml").write_text(yaml.safe_dump(dict(model_config_file="score_model_configs.yaml")))
    (d / "task_configs.yaml").write_text(yaml.safe_dump(dict(task_type="pick")))
    (d / "score_model_configs.yaml").write_text(yaml.safe_dump(cfg))
    return str(d)


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    root = tmp_path_factory.mktemp("runtime")
    return {name: _config_dir(root, name, ebm=name == "ebm") for name in ("low", "high", "ebm")}


def _bundle(dirs, name, seed):
    return load_model_bundle(dirs[name], device="cpu", init_seed=seed, **PADS)


def _request(seed, n_seeds):
    sp, sc, gp, gcol = _clouds(seed)
    rng = np.random.default_rng(seed + 10)
    q = rng.normal(size=(n_seeds, 4))
    Ts = np.concatenate([q / np.linalg.norm(q, axis=-1, keepdims=True),
                         rng.uniform([-0.03, -0.03, 0.07], [0.03, 0.03, 0.11], (n_seeds, 3))], -1)
    return PointCloud(sp, sc), PointCloud(gp, gcol), Ts.astype(np.float32)


def _gen(seed):
    return torch.Generator().manual_seed(seed)


@pytest.mark.parametrize("record", [True, False])
@pytest.mark.parametrize("R", [1, 2])
def test_rollout_equals_langevin_sample_bitwise(dirs, R, record):
    """The runtime's rollout (twice: the first run builds the entry, the
    second runs it again) against ``langevin_sample`` on the same
    extraction outputs and generator seed, with a temperature-0 segment."""
    bundle = _bundle(dirs, "low", 3)
    agent = DiffusionEdfAgent([bundle], PREPROCESS, UNPROCESS, preprocess_seed=0)
    preps = [agent._prep(*_request(i, 3)[:2]) for i in range(R)]
    T0 = torch.as_tensor(np.stack([_request(i, 3)[2] for i in range(R)]) * np.float32([1, 1, 1, 1, 100, 100, 100]))
    sched = build_schedule(diffusion_schedules=DIFF_CFG["diffusion_schedules_list"][0], N_steps=[3, 2],
                           timesteps=[0.04, 0.02], ang_mult=bundle.ang_mult, lin_mult=bundle.lin_mult,
                           temperatures=[1.0, 0.0], time_exponent_temp=1.0)
    rt = _BundleRuntime(bundle)
    with torch.no_grad():
        key_ms, query = rt.extract(preps)
        ref = langevin_sample(lambda T, t: bundle.model.score(T, key_ms, query, t), T0, sched, bundle.ang_mult,
                              bundle.lin_mult, generator=_gen(7), record_trajectory=record)
        for _ in range(2):
            T, traj = rt.rollout(key_ms, query, T0, sched, _gen(7), record)
            assert torch.equal(T, ref[0])
            assert (traj is None) == (not record) and (traj is None or torch.equal(traj, ref[1]))
    assert float((ref[0] - T0).abs().max()) > 1e-3  # the poses moved
    assert rt.cache_sizes() == dict(extract_key=1, extract_query=1, rollout=1, energy=0)


def test_no_new_entry_after_warmup(dirs):
    """The counterpart of ``tests/test_agent_serve.py``'s no-retrace test:
    after a warmup with the real schedule and seed count, two ``sample``
    calls add no entry; a new seed count adds exactly one rollout."""
    agent = DiffusionEdfAgent([_bundle(dirs, "low", 3)], PREPROCESS, UNPROCESS)
    scene, grasp, Ts = _request(0, 2)
    agent.warmup(scene, grasp, n_seeds=2, diffusion_configs=DIFF_CFG, record_trajectory=True)
    sizes0 = agent._runtimes[0].cache_sizes()
    assert ENTRY_POINTS == ("extract_key", "extract_query", "rollout", "energy")
    assert sizes0 == dict(extract_key=1, extract_query=1, rollout=1, energy=0)
    for i in range(2):
        agent.sample(scene, grasp, Ts, generator=_gen(i), **DIFF_CFG)
    assert agent._runtimes[0].cache_sizes() == sizes0
    agent.sample(scene, grasp, _request(1, 3)[2], generator=_gen(2), **DIFF_CFG)
    assert agent._runtimes[0].cache_sizes() == dict(sizes0, rollout=2)


def test_parameter_write_drops_entries(dirs):
    """An in-place write to one parameter drops every entry (two rollout
    shapes become one after the next call), and that call equals a fresh
    agent's on the written weights."""
    bundle = _bundle(dirs, "low", 3)
    agent = DiffusionEdfAgent([bundle], PREPROCESS, UNPROCESS)
    scene, grasp, Ts = _request(0, 2)
    agent.sample(scene, grasp, Ts, generator=_gen(0), **DIFF_CFG)
    agent.sample(scene, grasp, Ts[:1], generator=_gen(0), **DIFF_CFG)
    assert agent._runtimes[0].cache_sizes()["rollout"] == 2
    with torch.no_grad():
        next(bundle.model.parameters()).mul_(1.5)
    after = agent.sample(scene, grasp, Ts, generator=_gen(1), **DIFF_CFG)[0]
    assert agent._runtimes[0].cache_sizes()["rollout"] == 1
    fresh = DiffusionEdfAgent([bundle], PREPROCESS, UNPROCESS).sample(scene, grasp, Ts, generator=_gen(1),
                                                                      **DIFF_CFG)[0]
    np.testing.assert_array_equal(after, fresh)


def test_warmup_takes_the_jax_arguments(dirs):
    """The JAX package's ``warmup`` signature, names and defaults, and its
    call as ``tests/test_agent_serve.py`` makes it; the default call warms
    the one-step schedule without recording the trajectory."""
    params = lambda f: [(p.name, p.default) for p in inspect.signature(f).parameters.values()]  # noqa: E731
    assert params(DiffusionEdfAgent.warmup) == params(JAgent.warmup)
    agent = DiffusionEdfAgent([_bundle(dirs, "low", 3)], PREPROCESS, UNPROCESS)
    scene, grasp, _ = _request(0, 2)
    agent.warmup(scene, grasp)
    assert list(agent._runtimes[0].entries["rollout"]) == [(1, 1, 1, False, (True,))]
    agent.warmup(scene, grasp, n_seeds=2, diffusion_configs=DIFF_CFG, record_trajectory=True)
    assert (1, 2, 5, True, (True,) * 3 + (False,) * 2) in agent._runtimes[0].entries["rollout"]


def test_cascade_and_batch_equal_the_eager_agent(dirs):
    """lowres -> highres -> critic through the runtime against the same
    agent run eagerly (``use_runtime=False``), noise on: trajectories and
    energies equal to the bit; the same for ``sample_batch`` of two
    requests, which adds the entries of two requests to the same entry
    points."""
    bundles = [_bundle(dirs, n, s) for n, s in (("low", 3), ("high", 4), ("ebm", 5))]
    cfg = dict(DIFF_CFG, N_steps_list=[[2, 2], [2, 1]], timesteps_list=[[0.04, 0.02], [0.02, 0.01]],
               temperatures_list=[[1.0, 1.0], [1.0, 0.0]],
               diffusion_schedules_list=[[[1.0, 0.15], [0.15, 0.09]], [[0.09, 0.03], [0.03, 0.012]]])
    agents = [DiffusionEdfAgent(bundles[:2], PREPROCESS, UNPROCESS, critic=bundles[2], use_runtime=u)
              for u in (True, False)]
    scene, grasp, Ts = _request(0, 3)
    (traj_r, _, _, info_r), (traj_e, _, _, info_e) = (a.sample(scene, grasp, Ts, generator=_gen(0), **cfg)
                                                      for a in agents)
    np.testing.assert_array_equal(traj_r, traj_e)
    np.testing.assert_array_equal(info_r["energy"], info_e["energy"])
    assert np.abs(traj_r[-1] - traj_r[0]).max() > 1e-3
    reqs = [_request(i, 3) for i in range(2)]
    batch = [a.sample_batch([r[0] for r in reqs], [r[1] for r in reqs], np.stack([r[2] for r in reqs]),
                            generator=_gen(1), n_seeds=[3, 2], **cfg) for a in agents]
    np.testing.assert_array_equal(batch[0][0], batch[1][0])
    np.testing.assert_array_equal(batch[0][1]["energy"], batch[1][1]["energy"])
    assert np.isinf(batch[0][1]["energy"][1, -1])  # the padding seed ranks last
    for rt in agents[0]._runtimes:
        assert rt.cache_sizes() == dict(extract_key=2, extract_query=2, rollout=2, energy=0)
    assert agents[0]._critic_runtime.cache_sizes() == dict(extract_key=2, extract_query=2, rollout=0, energy=2)
    assert all(sum(rt.cache_sizes().values()) == 0 for rt in agents[1]._runtimes)


def test_program_on_cpu_runs_eagerly_into_its_outputs():
    """A program's later calls copy into the first call's outputs; an output
    that is a parameter is left alone (its version counter does not move)."""
    p = torch.nn.Parameter(torch.ones(3))
    x = torch.zeros(3)
    with torch.no_grad():
        prog = Program(lambda: (p, x * 2 + 1), torch.device("cpu"))
        out = prog.out
        version = p._version
        x.fill_(2.0)
        assert prog() is out
    assert out[0] is p and p._version == version and torch.equal(out[1], torch.full((3,), 5.0))
    assert prog.graph is None and prog.capture_s == 0.0 and prog.delta == (0, 0, 0)


def test_dropped_entries_free_without_the_garbage_collector(dirs):
    """An agent's entries (and on CUDA their graphs) go when the agent goes,
    by reference counting: left to the garbage collector, a graph could be
    destroyed while another one is being captured, which fails that capture."""
    agent = DiffusionEdfAgent([_bundle(dirs, "low", 3)], PREPROCESS, UNPROCESS)
    scene, grasp, Ts = _request(0, 2)
    agent.sample(scene, grasp, Ts, generator=_gen(0), **DIFF_CFG)
    refs = [weakref.ref(e) for entries in agent._runtimes[0].entries.values() for e in entries.values()]
    assert len(refs) == 3
    gc.disable()
    try:
        del agent
        assert all(r() is None for r in refs)
    finally:
        gc.enable()
