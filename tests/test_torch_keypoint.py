"""The place models' query side in the port against the JAX package on shared
parameters: the ``KeypointExtractor`` alone (bbox crop, sigmoid and softmax
weights, ``weight_mult``), a tiny place model's score and a tiny place
critic's energy, and a tiny place cascade with a place critic against the
JAX agent at temperature 0.  The place config copies and checkpoints are
checked in ``test_torch_agent.py``."""
import copy
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as ge
from diffusion_edf_tpu.agent import DiffusionEdfAgent as JAgent
from diffusion_edf_tpu.models.data import FeaturedPoints as JFP
from diffusion_edf_tpu.models.keypoint import KeypointExtractor as JKeypointExtractor
from diffusion_edf_tpu.train.data import PointCloud as JPC
from diffusion_edf_tpu.train.factory import build_score_model as j_build
from diffusion_edf_tpu_torch.agent import DiffusionEdfAgent as TAgent
from diffusion_edf_tpu_torch.data import FeaturedPoints as TFP
from diffusion_edf_tpu_torch.models.keypoint import KeypointExtractor
from diffusion_edf_tpu_torch.train.data import PointCloud as TPC
from diffusion_edf_tpu_torch.train.factory import build_score_model as t_build
from diffusion_edf_tpu_torch.weights import init_params

from .test_models import place_config
from .test_torch_agent import POSE_GATE, PREPROCESS, UNPROCESS, _clouds
from .test_torch_critic import _bundles
from .test_torch_model import _inputs
from .test_torch_tables import t, torch_to_jax_params

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parents[1]
GATE = 2e-5  # tiny widths (tests/test_edge_kernel.py)
# crops about half of _grasp's points: z below 0 and |x| above 1.5
BBOX = [[-1.5, 1.5], [-3.0, 3.0], [0.0, 3.0]]


def _grasp(n=64, n_valid=56, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 1.2, size=(n, 3)).astype(np.float32)
    f = rng.uniform(0, 1, size=(n, 3)).astype(np.float32)
    mask = np.arange(n) < n_valid
    x[~mask] = 1e6
    return x, f, mask


@pytest.mark.parametrize("activation,weight_mult,bbox", [
    pytest.param("sigmoid", None, BBOX, id="sigmoid-bbox"),
    pytest.param("softmax", None, BBOX, id="softmax-bbox"),
    pytest.param("softmax", 2.5, None, id="softmax-weight_mult"),
])
def test_keypoint_extractor_matches_flax(activation, weight_mult, bbox):
    """``test_models.place_config``'s widths, its extractor cut to one layer
    a scale (the JAX compile of two takes twice as long)."""
    kw = copy.deepcopy(place_config()["query_kwargs"])
    kw["feature_extractor_kwargs"].update(n_layers=[1, 1], n_layers_midstream=1)
    kw["keypoint_kwargs"] = dict(kw["keypoint_kwargs"], bbox=bbox)
    kw.update(weight_activation=activation, weight_mult=weight_mult)
    x, f, mask = _grasp()
    tmod = init_params(KeypointExtractor(**kw), torch.Generator().manual_seed(4))
    with torch.no_grad():
        tmod.weight_dense.bias.fill_(0.3)  # weights away from 0.5, the softmax away from uniform
        tout = tmod(TFP(x=t(x), f=t(f), mask=torch.as_tensor(mask)))
    jpts = JFP(x=jnp.asarray(x), f=jnp.asarray(f), mask=jnp.asarray(mask))
    jout = jax.jit(JKeypointExtractor(**kw).apply)(torch_to_jax_params(tmod), jpts)
    m = int(np.ceil(0.1 * 64))
    assert tout.x.shape == (m, 3) and tout.f.shape == (m, 30) and tout.w.shape == (m,)
    np.testing.assert_array_equal(np.asarray(jout.mask), tout.mask.numpy())
    inside = mask & (np.all((x >= np.asarray(bbox)[:, 0]) & (x <= np.asarray(bbox)[:, 1]), -1) if bbox else True)
    assert int(tout.mask.sum()) == min(m, int(inside.sum())) and (bbox is None or inside.sum() < mask.sum())
    for name in ("x", "f", "w"):
        np.testing.assert_allclose(np.asarray(getattr(jout, name)), getattr(tout, name).numpy(), atol=GATE)
    w, keep = tout.w.numpy(), tout.mask.numpy()
    assert (w[~keep] == 0).all() and (w[keep] > 0).all() and np.ptp(w[keep]) > 1e-3
    if activation == "softmax":
        np.testing.assert_allclose(w.sum(), weight_mult or 1.0, rtol=1e-5)  # softplus(weight_mult_logit)


def _place_cfg(ebm: bool = False, bbox_z=(-5.0, 30.0)):
    """The tiny configuration of ``__graft_entry__.py`` with the place
    models' query: a ``KeypointExtractor`` of ``test_models.place_config``'s
    widths, through the factory (which fills its neighbour caps); its bbox
    keeps the points with z in ``bbox_z``."""
    cfg = copy.deepcopy(ge._model_config(tiny=True))
    mk = cfg["model_kwargs"]
    q = place_config()["query_kwargs"]
    fe = dict(mk["key_kwargs"]["feature_extractor_kwargs"])
    for knob in ("k_pool", "k_self", "k_up"):
        fe.pop(knob)
    tf = dict(q["tensor_field_kwargs"])
    tf.pop("k_multiscale")
    mk["query_model"] = "KeypointExtractor"
    mk["query_kwargs"] = dict(
        feature_extractor_name="UnetFeatureExtractor", feature_extractor_kwargs=fe, tensor_field_kwargs=tf,
        keypoint_kwargs=dict(pool_ratio=0.1, weight_pre_emb_dim=8, bbox=[[-30, 30], [-30, 30], list(bbox_z)]),
        weight_activation="sigmoid", weight_mult=None,
    )
    if ebm:  # as configs/panda_mug/place_ebm: no time encoding on the edges
        mk["score_head_kwargs"].update(ebm=True, edge_time_encoding=False)
    return cfg


@pytest.fixture(scope="module")
def place_model():
    """A tiny place model's parameters and the JAX model's key clouds, query
    and score on them (computed once for every ``edge_impl``)."""
    cfg = _place_cfg(bbox_z=(17.0, 30.0))  # keeps 2 points of the 7 FPS asks for: masked query slots
    tmodel = init_params(t_build(cfg["model_name"], cfg["model_kwargs"]), torch.Generator().manual_seed(6))
    jmodel = j_build(cfg["model_name"], cfg["model_kwargs"])
    params = torch_to_jax_params(tmodel)
    x, f, mask, Ts, time = _inputs(64, 56, 3, seed=2)
    scene = JFP(x=jnp.asarray(x), f=jnp.asarray(f), mask=jnp.asarray(mask))

    def run(p, s, T, tt):
        km = jmodel.apply(p, s, method=jmodel.get_key_pcd_multiscale)
        q = jmodel.apply(p, s, method=jmodel.get_query_pcd)
        return km, q, jmodel.apply(p, T, km, q, tt, method=jmodel.score)

    jout = jax.tree_util.tree_map(np.asarray, jax.jit(run)(params, scene, jnp.asarray(Ts), jnp.asarray(time)))
    return tmodel, (x, f, mask, Ts, time), jout


@pytest.mark.parametrize("edge_impl", ["plain", "fused"])
def test_tiny_place_model_score_matches_jax(place_model, edge_impl):
    """Key clouds, query points and weights, and the score, to 1e-4 as the
    pick model's test (``test_torch_model.py``)."""
    tmodel, (x, f, mask, Ts, time), (jkm, jq, (jang, jlin)) = place_model
    tmodel.set_edge_impl(edge_impl)
    scene = TFP(x=t(x), f=t(f), mask=torch.as_tensor(mask))
    with torch.no_grad():
        tkm, tq = tmodel.get_key_pcd_multiscale(scene), tmodel.get_query_pcd(scene)
        tang, tlin = tmodel.score(t(Ts), tkm, tq, t(time))
    for a, b in zip(jkm, tkm):
        np.testing.assert_allclose(a.f, b.f.numpy(), atol=1e-4)
    np.testing.assert_array_equal(jq.mask, tq.mask.numpy())
    assert 0 < int(tq.mask.sum()) < tq.mask.numel()
    for name in ("x", "f", "w"):
        np.testing.assert_allclose(getattr(jq, name), getattr(tq, name).numpy(), atol=1e-4)
    np.testing.assert_allclose(jang, tang.numpy(), atol=1e-4)
    np.testing.assert_allclose(jlin, tlin.numpy(), atol=1e-4)


def test_tiny_place_critic_energy_matches_jax():
    cfg = _place_cfg(ebm=True)
    tmodel = init_params(t_build(cfg["model_name"], cfg["model_kwargs"]), torch.Generator().manual_seed(8))
    jmodel = j_build(cfg["model_name"], cfg["model_kwargs"])
    params = torch_to_jax_params(tmodel)
    x, f, mask, Ts, time = _inputs(64, 56, 3, seed=3)
    jscene = JFP(x=jnp.asarray(x), f=jnp.asarray(f), mask=jnp.asarray(mask))
    je = jax.jit(lambda p, s, T, tt: jmodel.apply(
        p, T, jmodel.apply(p, s, method=jmodel.get_key_pcd_multiscale),
        jmodel.apply(p, s, method=jmodel.get_query_pcd), tt, method=jmodel.energy))(
            params, jscene, jnp.asarray(Ts), jnp.asarray(time))
    with torch.no_grad():
        tscene = TFP(x=t(x), f=t(f), mask=torch.as_tensor(mask))
        te = tmodel.energy(t(Ts), tmodel.get_key_pcd_multiscale(tscene), tmodel.get_query_pcd(tscene), t(time))
    assert te.shape == (3,) and float(te.min()) > 0
    # the pick critic's test holds 1e-5; here the query features come out of
    # a tensor field too, one network more (seen 1.3e-5 on energies of 0.56)
    np.testing.assert_allclose(np.asarray(je), te.numpy(), atol=5e-5)


def test_tiny_place_cascade_with_critic_matches_jax(tmp_path):
    """place lowres -> highres -> place critic against the JAX agent at
    temperature 0: final poses within the pose gate, energies within 1e-4 in
    the same order (``test_torch_critic.py``'s tolerances)."""
    (t1, j1), (t2, j2), (tc, jc) = (_bundles(tmp_path, n, ebm, s, cfg=_place_cfg(ebm)) for n, ebm, s in
                                    (("low", False, 3), ("high", False, 4), ("ebm", True, 5)))
    sp, sc, gp, gc = _clouds()
    rng = np.random.default_rng(7)
    q = rng.normal(size=(3, 4))
    Ts_init = np.concatenate([q / np.linalg.norm(q, axis=-1, keepdims=True),
                              rng.uniform([-0.03, -0.03, 0.07], [0.03, 0.03, 0.11], (3, 3))], -1)
    diff = dict(
        N_steps_list=[[2, 1], [1, 1]], timesteps_list=[[0.04, 0.02], [0.02, 0.01]],
        temperatures_list=[[0.0, 0.0], [0.0, 0.0]],
        diffusion_schedules_list=[[[1.0, 0.15], [0.15, 0.09]], [[0.09, 0.03], [0.03, 0.012]]],
        log_t_schedule=True, time_exponent_temp=1.0, time_exponent_alpha=0.5,
    )
    traj_t, _, _, info_t = TAgent([t1, t2], PREPROCESS, UNPROCESS, critic=tc).sample(
        TPC(sp, sc), TPC(gp, gc), Ts_init, generator=torch.Generator().manual_seed(0), **diff)
    traj_j, _, _, info_j = JAgent([j1, j2], PREPROCESS, UNPROCESS, critic=jc).sample(
        JPC(sp, sc), JPC(gp, gc), Ts_init, key=jax.random.PRNGKey(0), **diff)
    assert traj_t.shape == traj_j.shape == (3 + 1 + 2 + 1, 3, 7)
    e_t, e_j = info_t["energy"], np.asarray(info_j["energy"])
    assert np.all(np.diff(e_t) >= 0)
    np.testing.assert_allclose(e_t, e_j, atol=1e-4)
    np.testing.assert_allclose(traj_t[0], np.asarray(traj_j[0]), atol=1e-5)
    drift = float(np.abs(traj_t[-1] - np.asarray(traj_j[-1])).max())
    print(f"tiny place cascade + critic final-pose drift port vs JAX: {drift:.3g}")
    assert drift <= POSE_GATE
