"""The port's multi-device paths on the CPU against the port's single
process and the JAX package on the conftest's virtual 8-device mesh: the
port's ranks are spawned processes in a gloo group (``tests/torch_ranks.py``).

* seed-sharded Langevin sampling at 2 and 4 ranks against one process on
  the padded batch with the same generator (1e-6), and against the JAX
  package's ``sharded_langevin_sample`` with the toy score of
  ``tests/test_parallel.py`` at temperature 0 (1e-5); the agent's mesh
  entry against one process (1e-6), and its runtime (the seed-sharded
  rollout entries) against the eager agent (``use_runtime=False``) on the
  mesh bit for bit, a two-stage cascade with a critic through ``sample``
  and ``sample_batch``, with no entry added after a ``warmup``;
* the query- and the scene-sharded score of the tiny model on a (2, 2)
  (data, model) mesh against the JAX package on the same mesh shape (1e-4)
  and the port's replicated score; the tiny critic's energy and its score
  (the gradient of the energy, through the collectives' backward) under a
  scene group and under query sharding against the replicated ones; the
  scene-sharded score's runtime and the query-sharded score in a
  ``graphs.Program`` against the eager calls bit for bit, first call and
  replay; a gloo mesh is not ``capturable`` on CUDA, and a program over it
  there refuses."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as ge
from diffusion_edf_tpu.diffusion import build_schedule as j_build_schedule
from diffusion_edf_tpu.models.data import FeaturedPoints as JFP
from diffusion_edf_tpu.parallel import make_mesh as j_make_mesh
from diffusion_edf_tpu.parallel import pad_seeds_to_multiple as j_pad
from diffusion_edf_tpu.parallel import scene_sharded_score_fn as j_scene_sharded_score_fn
from diffusion_edf_tpu.parallel import sharded_langevin_sample as j_sharded_langevin_sample
from diffusion_edf_tpu.train.factory import build_score_model as j_build
from diffusion_edf_tpu_torch.agent import DiffusionEdfAgent, load_model_bundle
from diffusion_edf_tpu_torch.data import FeaturedPoints as TFP
from diffusion_edf_tpu_torch.data import stack_points
from diffusion_edf_tpu_torch.diffusion.langevin import build_schedule, langevin_sample
from diffusion_edf_tpu_torch.nn.layers import keep_mask
from diffusion_edf_tpu_torch.parallel import make_mesh
from diffusion_edf_tpu_torch.parallel.mesh import pose_block
from diffusion_edf_tpu_torch.parallel.sharded import cap_bound_rows, pad_seeds_to_multiple
from diffusion_edf_tpu_torch.train.data import PointCloud
from diffusion_edf_tpu_torch.train.factory import build_score_model as t_build
from diffusion_edf_tpu_torch.weights import init_params

from . import torch_ranks
from .test_torch_agent import tiny_config_dir  # noqa: F401 (fixture)
from .test_torch_runtime import _config_dir as runtime_config_dir
from .test_torch_tables import torch_to_jax_params
from .test_torch_train import _model_cfg

torch.set_num_threads(1)


def _toy_seeds(n, seed=1):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(n, 4))
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    return np.concatenate([q, rng.normal(size=(n, 3))], -1).astype(np.float32)


def test_mesh_of_one_process():
    mesh = make_mesh(axis_names=("data", "model"))
    assert mesh.shape == {"data": 1, "model": 1} and mesh.group("data") is None and mesh.index("model") == 0


def test_mesh_of_one_process_is_capturable():
    """One process holds no group: its programs may capture on CUDA too."""
    mesh = make_mesh()
    assert mesh.backends() == [] and mesh.capturable("cuda") and mesh.capturable("cpu")


@pytest.mark.parametrize("shape", [(12, 4, 5), (12, 3)], ids=["attention", "irreps"])
def test_keep_mask_of_a_pose_block(shape):
    """Inside ``pose_block(R=2, n=6, start=2, size=2)`` a dropout mask over
    the block's rows (2 requests x 2 poses x 3 rows a pose) is the mask of
    the whole batch's rows, narrowed to the block, from the same generator
    state; outside, the plain draw."""
    full = keep_mask((36,) + shape[1:], 0.3, torch.Generator().manual_seed(0), "cpu")
    with pose_block(2, 6, 2, 2):
        block = keep_mask(shape, 0.3, torch.Generator().manual_seed(0), "cpu")
    want = full.reshape((2, 6, 3) + shape[1:])[:, 2:4].reshape(shape)
    assert torch.equal(block, want) and 0 < int(block.sum()) < block.numel()
    assert torch.equal(keep_mask(shape, 0.3, torch.Generator().manual_seed(0), "cpu"), full[:12])


@pytest.mark.parametrize("n", [5, 8, 1])
def test_pad_seeds_matches_jax(n):
    T = _toy_seeds(n)
    tp, tn = pad_seeds_to_multiple(torch.as_tensor(T), 8)
    jp, jn = j_pad(jnp.asarray(T), 8)
    assert tn == jn == n
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))


@pytest.mark.parametrize("world", [2, 4])
def test_sharded_langevin_matches_one_process(tmp_path, world):
    """13 seeds padded to a multiple of the ranks, temperature 1: the final
    poses and the trajectory of every rank equal one process's rollout of
    the padded batch with the same generator."""
    T0 = _toy_seeds(13)
    sched = build_schedule([[1.0, 0.05]], [20], [0.05], ang_mult=1.0, lin_mult=1.0)
    outs = torch_ranks.spawn("langevin", world, tmp_path, T0=T0, schedule=tuple(sched), seed=3)
    Tp, _ = pad_seeds_to_multiple(torch.as_tensor(T0), world)
    T1, traj1 = langevin_sample(torch_ranks.toy_score, Tp, sched, 1.0, 1.0, generator=torch.Generator().manual_seed(3))
    for o in outs:
        assert o["T"].shape == (13, 7) and o["traj"].shape == (21, 13, 7)
        np.testing.assert_allclose(o["T"].numpy(), T1[:13].numpy(), atol=1e-6)
        np.testing.assert_allclose(o["traj"].numpy(), traj1[:, :13].numpy(), atol=1e-6)


def test_sharded_langevin_matches_jax(tmp_path):
    """The JAX package's test case (16 seeds, 20 steps) at temperature 0:
    two port ranks against the JAX rollout sharded over 8 virtual devices."""
    T0 = _toy_seeds(16)
    kw = dict(diffusion_schedules=[[1.0, 0.05]], N_steps=[20], timesteps=[0.05], ang_mult=1.0, lin_mult=1.0,
              temperatures=0.0)
    outs = torch_ranks.spawn("langevin", 2, tmp_path, T0=T0, schedule=tuple(build_schedule(**kw)), seed=0)
    jT, _ = j_sharded_langevin_sample(j_make_mesh(), lambda T, t: (-T[..., 1:4], -T[..., 4:]), jax.random.PRNGKey(0),
                                      jnp.asarray(T0), j_build_schedule(**kw), 1.0, 1.0)
    for o in outs:
        np.testing.assert_allclose(o["T"].numpy(), np.asarray(jT), atol=1e-5)


def test_agent_mesh_matches_one_process(tmp_path, tiny_config_dir):  # noqa: F811
    """``DiffusionEdfAgent(mesh=...)`` on two ranks, 5 seeds: the trajectory
    of one process on the 6 padded seeds, with the same generator.  Then
    the runtime against the eager agent on the mesh, a lowres -> highres ->
    critic cascade, noise on: trajectories and energies of ``sample`` and
    of ``sample_batch`` (two requests, 5 and 3 real seeds) equal to the bit
    on every rank, and the entries after ``warmup`` unchanged by the
    ``sample`` of its shapes."""
    rng = np.random.default_rng(0)
    scene = PointCloud(points=rng.uniform(-12, 12, (200, 3)).astype(np.float32),
                       colors=rng.uniform(0, 1, (200, 3)).astype(np.float32))
    grasp = PointCloud(points=rng.uniform(-4, 4, (50, 3)).astype(np.float32) + np.float32([0, 0, 10]),
                       colors=rng.uniform(0, 1, (50, 3)).astype(np.float32))
    Ts = _toy_seeds(5) * np.float32([1, 1, 1, 1, 5, 5, 5])
    kw = dict(cfg_dir=tiny_config_dir, scene=scene, grasp=grasp, seed=7)
    critic_dir = runtime_config_dir(tmp_path, "ebm", ebm=True)
    outs = torch_ranks.spawn("agent", 2, tmp_path, Ts_init=Ts, mesh_shape=(2,), critic_dir=critic_dir, **kw)
    one = torch_ranks._agent(Ts_init=np.concatenate([Ts, Ts[-1:]]), mesh_shape=None, **kw)
    for o in outs:
        assert o["traj"].shape == (5, 5, 7)
        np.testing.assert_allclose(o["traj"], one["traj"][:, :5], atol=1e-6)
        run, ref = o["runtime"], o["eager"]
        assert run["traj"].shape == (7, 5, 7) and run["batch"].shape == (2, 7, 5, 7)
        for k in ("traj", "energy", "batch", "batch_energy"):
            np.testing.assert_array_equal(run[k], ref[k], err_msg=k)
        assert np.abs(run["traj"][-1] - run["traj"][0]).max() > 1e-3
        assert np.isinf(run["batch_energy"][1, -2:]).all()  # the padding seeds rank last
        assert o["sizes_after"] == o["sizes_warm"]
        assert o["rollout_entries"] == [(R, 5, 3, True, (True, True, False)) for R in (1, 2)]  # sample, sample_batch
    np.testing.assert_array_equal(outs[0]["runtime"]["batch"], outs[1]["runtime"]["batch"])


def _scene(n=64, seed=0, half=20.0):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-half, half, (n, 3)).astype(np.float32)
    f = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    return x, f, np.ones(n, bool)


def _poses(n=4, seed=1, reach=10.0):
    T = _toy_seeds(n, seed) * np.float32([1, 1, 1, 1, reach, reach, reach])
    return T, np.full(n, 0.5, np.float32)


def _replicated(model, scene, Ts, time, critic=False):
    pcd = TFP(*(torch.as_tensor(a) for a in scene))
    with torch.no_grad():
        key_ms = [stack_points([p]) for p in model.get_key_pcd_multiscale(pcd)]
        query = stack_points([model.get_query_pcd(pcd)])
        T, t = torch.as_tensor(Ts)[None], torch.as_tensor(time)[None]
        out = {"score": model.score(T, key_ms, query, t), "cap_bound": cap_bound_rows(model, T, key_ms, query)}
        if critic:
            out["energy"] = model.energy(T, key_ms, query, t)
    return out


def test_sharded_scores_match_jax(tmp_path):
    """Tiny model, a dense 64-point scene (a 6 cm cube, so that the first
    scale's cap of 8 binds for some query rows), 4 poses, (data, model) =
    (2, 2): the query-sharded score against the replicated ones, the
    scene-sharded score against the JAX package's scene-sharded score on 4
    of the 8 virtual devices in the same shape (both cut the scene into the
    same blocks, so their edge sets match where a cap binds)."""
    cfg = ge._model_config(tiny=True)
    tmodel = init_params(t_build(cfg["model_name"], cfg["model_kwargs"]), torch.Generator().manual_seed(1))
    scene, (Ts, time) = _scene(half=3.0), _poses(reach=1.0)
    Ts[:, :4] = [1.0, 0.0, 0.0, 0.0]
    Ts[:, 6] -= 10.5  # the tiny query's keypoints sit at z = 10.5: into the scene
    ref = _replicated(tmodel, scene, Ts, time)
    assert ref["cap_bound"] > 0
    (out, *_) = torch_ranks.spawn("scores", 4, tmp_path, cfg=cfg, state=tmodel.state_dict(), scene=scene, Ts=Ts,
                                  time=time, mesh_shape=(2, 2))

    jmodel = j_build(cfg["model_name"], cfg["model_kwargs"])
    params = torch_to_jax_params(tmodel)
    jscene = JFP(*(jnp.asarray(a) for a in scene))
    key_ms = jax.jit(lambda p, s: jmodel.apply(p, s, method=jmodel.get_key_pcd_multiscale))(params, jscene)
    query = jax.jit(lambda p, s: jmodel.apply(p, s, method=jmodel.get_query_pcd))(params, jscene)
    jref = jax.jit(lambda p, T, t: jmodel.apply(p, T, key_ms, query, t, method=jmodel.score))(
        params, jnp.asarray(Ts), jnp.asarray(time))
    cfg_sh = ge._model_config(tiny=True)
    cfg_sh["model_kwargs"]["score_head_kwargs"]["key_tensor_field_kwargs"]["scene_axis_name"] = "model"
    jmodel_sh = j_build(cfg_sh["model_name"], cfg_sh["model_kwargs"])
    jscene_sh = j_scene_sharded_score_fn(j_make_mesh(4, ("data", "model"), (2, 2)), jmodel_sh, params, key_ms, query)
    jsh = jscene_sh(jnp.asarray(Ts), jnp.asarray(time))
    moved = max(float((out["scene"][i] - ref["score"][i]).abs().max()) for i in range(2))
    print(f"cap-bound query rows: {ref['cap_bound']} of {len(Ts) * query.x.shape[0]}; the scene-sharded score "
          f"{moved:.3g} from the replicated one")
    assert moved > 1e-3  # the blocks' union of nearest-k differs from the global nearest-k here
    for i in range(2):
        np.testing.assert_allclose(out["query"][i][0].numpy(), np.asarray(jref[i]), atol=1e-4)
        np.testing.assert_allclose(out["query"][i].numpy(), ref["score"][i].numpy(), atol=1e-5)
        np.testing.assert_allclose(out["scene"][i][0].numpy(), np.asarray(jsh[i]), atol=1e-4)
    _runtime_equals_eager(out, ("",))


def _runtime_equals_eager(out, suffixes):
    """The runtime's outputs of one rank against its eager calls, bit for
    bit, and the gloo mesh's refusal on CUDA."""
    assert out["backends"] == ["gloo"] and out["capturable"] == {"cuda": False, "cpu": True}
    assert "gloo" in out["refused"] and "CUDA graph" in out["refused"]
    for sfx in suffixes:
        assert out["entries" + sfx] == 1
        eager = {"runtime": {n: out[n + sfx] for n in ("scene", "query")},
                 "runtime_flipped": out["eager_flipped" + sfx]}
        for run, want in eager.items():
            for name in ("scene", "query"):
                got, ref = (x if isinstance(x, tuple) else (x,) for x in (out[run + sfx][name], want[name]))
                for g, r in zip(got, ref, strict=True):
                    np.testing.assert_array_equal(g.numpy(), r.numpy(), err_msg=f"{run}{sfx} {name}")


def test_critic_under_scene_group(tmp_path):
    """The tiny critic: its energies and its score (the gradient of the
    energy through ``copy_to_shards`` / ``reduce_from_shards``) under a
    scene group and under query sharding, against the replicated critic,
    where no cap binds."""
    cfg = _model_cfg(True, 0.0)
    tmodel = init_params(t_build(cfg["model_name"], cfg["model_kwargs"]), torch.Generator().manual_seed(2))
    scene, (Ts, time) = _scene(seed=3), _poses(seed=4)
    ref = _replicated(tmodel, scene, Ts, time, critic=True)
    assert ref["cap_bound"] == 0
    outs = torch_ranks.spawn("scores", 4, tmp_path, cfg=cfg, state=tmodel.state_dict(), scene=scene, Ts=Ts, time=time,
                             mesh_shape=(2, 2), critic=True)
    assert float(ref["score"][0].abs().max()) > 0
    for o in outs:
        _runtime_equals_eager(o, ("", "_energy"))
        for k in ("query_energy", "scene_energy"):
            np.testing.assert_allclose(o[k].numpy(), ref["energy"].numpy(), rtol=1e-5, atol=1e-6, err_msg=k)
        for k in ("query", "scene"):
            for i in range(2):
                np.testing.assert_allclose(o[k][i].numpy(), ref["score"][i].numpy(), rtol=1e-4, atol=1e-5,
                                           err_msg=k)
