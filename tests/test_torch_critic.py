"""The EBM critic: a tiny EBM model's energy and score (the gradient of the
energy) in the port against the JAX model on shared parameters, and the tiny
two-stage agent with a critic against the JAX agent.

The agents run at temperature 0, where the Langevin noise term is exactly
zero: the noise of the two frameworks cannot match."""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

import __graft_entry__ as ge
from diffusion_edf_tpu.agent import DiffusionEdfAgent as JAgent
from diffusion_edf_tpu.agent import ModelBundle as JBundle
from diffusion_edf_tpu.models.data import FeaturedPoints as JFP
from diffusion_edf_tpu.train.data import PointCloud as JPC
from diffusion_edf_tpu.train.factory import build_score_model as j_build
from diffusion_edf_tpu_torch.agent import DiffusionEdfAgent as TAgent
from diffusion_edf_tpu_torch.agent import load_model_bundle
from diffusion_edf_tpu_torch.data import FeaturedPoints as TFP
from diffusion_edf_tpu_torch.train.data import PointCloud as TPC
from diffusion_edf_tpu_torch.train.data import pad_pointcloud

from .test_torch_agent import POSE_GATE, PREPROCESS, UNPROCESS, _clouds
from .test_torch_model import _inputs
from .test_torch_tables import one_request, t, torch_to_jax_params

torch.set_num_threads(1)


def _tiny_cfg(ebm: bool):
    cfg = copy.deepcopy(ge._model_config(tiny=True))
    if ebm:  # as configs/panda_mug/pick_ebm: no time encoding on the edges
        cfg["model_kwargs"]["score_head_kwargs"].update(ebm=True, edge_time_encoding=False)
    return cfg


def _config_dir(root, name, cfg):
    d = root / name
    d.mkdir()
    (d / "train_configs.yaml").write_text(yaml.safe_dump(dict(model_config_file="score_model_configs.yaml")))
    (d / "task_configs.yaml").write_text(yaml.safe_dump(dict(task_type="pick")))
    (d / "score_model_configs.yaml").write_text(yaml.safe_dump(cfg))
    return str(d)


def _bundles(root, name, ebm, init_seed, cfg=None):
    """The port's bundle and the JAX bundle on the same parameters (``cfg``:
    another configuration than the tiny pick model's)."""
    cfg = cfg or _tiny_cfg(ebm)
    tb = load_model_bundle(_config_dir(root, name, cfg), device="cpu", n_scene_pad=256, n_grasp_pad=96,
                           init_seed=init_seed)
    jb = JBundle(model=j_build(cfg["model_name"], cfg["model_kwargs"]), params=torch_to_jax_params(tb.model),
                 ang_mult=tb.ang_mult, lin_mult=tb.lin_mult, n_scene_pad=256, n_grasp_pad=96)
    return tb, jb


@pytest.mark.parametrize("edge_impl", ["plain", "fused"])
def test_tiny_ebm_energy_matches_jax(tmp_path, edge_impl):
    tb, jb = _bundles(tmp_path, "ebm", True, init_seed=2)
    tmodel, jmodel = tb.model, jb.model
    assert tmodel.use_ebm and not hasattr(tmodel.score_head, "time_mlps")
    tmodel.set_edge_impl(edge_impl)
    x, f, mask, Ts, time = _inputs(64, 50, 3)
    jscene = JFP(x=jnp.asarray(x), f=jnp.asarray(f), mask=jnp.asarray(mask))
    tscene = TFP(x=t(x), f=t(f), mask=torch.as_tensor(mask))
    je = jax.jit(lambda p, s, T, tt: jmodel.apply(
        p, T, jmodel.apply(p, s, method=jmodel.get_key_pcd_multiscale),
        jmodel.apply(p, s, method=jmodel.get_query_pcd), tt, method=jmodel.energy))(
            jb.params, jscene, jnp.asarray(Ts), jnp.asarray(time))
    with torch.no_grad():
        km, q = tmodel.get_key_pcd_multiscale(tscene), tmodel.get_query_pcd(tscene)
        te = tmodel.energy(*one_request(Ts, km, q, time))[0]
        # the score of an EBM model is the gradient of its energy (ebm_score), which
        # the kernels cannot give: an explicit kernel edge_impl refuses the autograd
        if edge_impl == "plain":
            tang, tlin = (s[0] for s in tmodel.score(*one_request(Ts, km, q, time)))
        else:
            with pytest.raises(RuntimeError, match="no backward"):
                tmodel.score(*one_request(Ts, km, q, time))
    assert te.shape == (3,) and float(te.min()) > 0
    # energies are O(1) sums of squares; 1e-5 holds for the module path and
    # for the fused core's other summation order alike
    np.testing.assert_allclose(np.asarray(je), te.numpy(), atol=1e-5)
    if edge_impl == "plain":
        jang, jlin = jmodel.apply(jb.params, jnp.asarray(Ts), jmodel.apply(jb.params, jscene, method=jmodel.get_key_pcd_multiscale),
                                  jmodel.apply(jb.params, jscene, method=jmodel.get_query_pcd), jnp.asarray(time),
                                  method=jmodel.score)
        for a, b in ((jang, tang), (jlin, tlin)):  # gradients of O(1) energies, scaled by ang_mult / lin_mult
            np.testing.assert_allclose(np.asarray(a), b.numpy(), atol=1e-4 * max(1.0, float(np.abs(a).max())))


def test_tiny_cascade_with_critic_matches_jax(tmp_path):
    """lowres -> highres -> critic: final poses within the pose gate, the
    same energy order, ``info["energy"]`` ascending and within 1e-4."""
    (t1, j1), (t2, j2), (tc, jc) = (_bundles(tmp_path, n, ebm, s) for n, ebm, s in
                                    (("low", False, 3), ("high", False, 4), ("ebm", True, 5)))
    sp, sc, gp, gc = _clouds()
    rng = np.random.default_rng(7)
    q = rng.normal(size=(4, 4))
    Ts_init = np.concatenate([q / np.linalg.norm(q, axis=-1, keepdims=True),
                              rng.uniform([-0.03, -0.03, 0.07], [0.03, 0.03, 0.11], (4, 3))], -1)
    diff = dict(
        N_steps_list=[[2, 2], [2, 1]], timesteps_list=[[0.04, 0.02], [0.02, 0.01]],
        temperatures_list=[[0.0, 0.0], [0.0, 0.0]],
        diffusion_schedules_list=[[[1.0, 0.15], [0.15, 0.09]], [[0.09, 0.03], [0.03, 0.012]]],
        log_t_schedule=True, time_exponent_temp=1.0, time_exponent_alpha=0.5,
    )
    traj_t, _, _, info_t = TAgent([t1, t2], PREPROCESS, UNPROCESS, critic=tc).sample(
        TPC(sp, sc), TPC(gp, gc), Ts_init, generator=torch.Generator().manual_seed(0), **diff)
    traj_j, _, _, info_j = JAgent([j1, j2], PREPROCESS, UNPROCESS, critic=jc).sample(
        JPC(sp, sc), JPC(gp, gc), Ts_init, key=jax.random.PRNGKey(0), **diff)
    assert traj_t.shape == traj_j.shape == (4 + 1 + 3 + 1, 4, 7)
    assert info_t["steps"] == [4, 3] and info_t["critic_s"] > 0
    e_t, e_j = info_t["energy"], np.asarray(info_j["energy"])
    assert e_t.shape == (4,) and np.all(np.diff(e_t) >= 0)
    np.testing.assert_allclose(e_t, e_j, atol=1e-4)
    # the same order: the sorted seed axis starts from the same initial poses
    np.testing.assert_allclose(traj_t[0], np.asarray(traj_j[0]), atol=1e-5)
    assert np.abs(traj_t[0] - traj_t[0][::-1]).max() > 1e-3  # the seeds differ, so the order is checkable
    drift = float(np.abs(traj_t[-1] - np.asarray(traj_j[-1])).max())
    print(f"tiny cascade + critic final-pose drift port vs JAX: {drift:.3g}")
    assert drift <= POSE_GATE
    # the energies are those of the returned final poses, in the returned order
    tc.model.set_edge_impl("plain")
    agent = TAgent([t1, t2], PREPROCESS, UNPROCESS, critic=tc)
    scene_p, grasp_p = agent._prep(TPC(sp, sc), TPC(gp, gc))
    with torch.no_grad():
        km = tc.model.get_key_pcd_multiscale(pad_pointcloud(scene_p, 256, "cpu"))
        qq = tc.model.get_query_pcd(pad_pointcloud(grasp_p, 96, "cpu"))
        again = tc.model.energy(*one_request(traj_t[-1], km, qq, np.ones(4)))[0].numpy()
    np.testing.assert_allclose(again, e_t, atol=1e-5)
