"""The sapien model family in the port against the JAX package on the same
parameters: ``ForwardOnlyFeatureExtractor`` (the key model of every
``sapien*/…_highres`` config) and ``PointAttentiveScoreModel`` (every
``sapien*/…_lowres`` config: the key cloud is a ``KeypointExtractor``'s,
whose point weights become the head's post-attention weights).  Tiny widths
to 2e-5; the slow case runs the shipped ``sapien/pick_lowres`` checkpoint at
full width.  The checkpoint's exact keys are checked in
``test_torch_agent.py``."""
import copy
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from diffusion_edf_tpu.models.data import FeaturedPoints as JFP
from diffusion_edf_tpu.models.extractor import ForwardOnlyFeatureExtractor as JForwardOnly
from diffusion_edf_tpu.models.score_model import PointAttentiveScoreModel as JPointAttentive
from diffusion_edf_tpu.train.factory import build_score_model as j_build
from diffusion_edf_tpu_torch.data import FeaturedPoints as TFP
from diffusion_edf_tpu_torch.models.extractor import ForwardOnlyFeatureExtractor
from diffusion_edf_tpu_torch.models.keypoint import KeypointExtractor
from diffusion_edf_tpu_torch.models.score_model import MultiscaleScoreModel, PointAttentiveScoreModel
from diffusion_edf_tpu_torch.train.factory import build_score_model as t_build
from diffusion_edf_tpu_torch.weights import flax_key, init_params, load_params_npz

from .test_models import IRREPS, IRREPS_SH, tiny_config
from .test_torch_model import _inputs
from .test_torch_tables import one_request, t, torch_to_jax_params

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parents[1]
GATE = 2e-5  # tiny widths (tests/test_edge_kernel.py)


def _scene(x, f, mask):
    return (TFP(x=t(x), f=t(f), mask=torch.as_tensor(mask)),
            JFP(x=jnp.asarray(x), f=jnp.asarray(f), mask=jnp.asarray(mask)))


def test_forward_only_extractor_matches_jax():
    """``tests/test_models.py``'s tiny extractor as a forward-only one, with
    three layers on the second scale; ``n_layers_midstream`` and ``k_up``
    are ignored by both."""
    kw = dict(tiny_config()["key_kwargs"]["feature_extractor_kwargs"], n_layers=[2, 3])
    tmod = init_params(ForwardOnlyFeatureExtractor(**kw), torch.Generator().manual_seed(2))
    x, f, mask, _, _ = _inputs(64, 20, 1, seed=4)  # fewer valid points than the first scale keeps
    tscene, jscene = _scene(x, f, mask)
    with torch.no_grad():
        tout = tmod(tscene)
    jout = jax.jit(JForwardOnly(**kw).apply)(torch_to_jax_params(tmod), jscene)
    assert len(tout) == len(jout) == 2 and int(tout[0].mask.sum()) == 20 < tout[0].mask.numel()
    assert not any(n.startswith(("mid_layer", "up_", "unpool")) for n, _ in tmod.named_modules())
    for j, p in zip(jout, tout):
        np.testing.assert_array_equal(np.asarray(j.mask), p.mask.numpy())
        assert int(p.mask.sum()) > 0
        np.testing.assert_allclose(np.asarray(j.x), p.x.numpy(), atol=GATE)
        np.testing.assert_allclose(np.asarray(j.f), p.f.numpy(), atol=GATE)
        assert p.f.shape[-1] == 30 and float(p.f.abs().max()) > 0


def _point_attentive_kwargs():
    """The tiny configuration of ``tests/test_models.py::test_point_attentive_model``."""
    fe_kwargs = dict(tiny_config()["key_kwargs"]["feature_extractor_kwargs"])
    common = dict(irreps_output=IRREPS, irreps_sh=IRREPS_SH, num_heads=2, length_emb_dim=16, n_layers=1,
                  irreps_mlp_mid=2, cutoff_method="edge_attn", r_mincut_nonscalar_sh=0.1, length_enc_max_r=10.0,
                  alpha_drop=0.0)
    key_tf = dict(common, fc_neurons=[16, 16, 16], r_cluster_multiscale=[2.0, None], k_multiscale=[8, 999])
    head_tf = dict(common, fc_neurons=[-1, 16, 16], r_cluster_multiscale=[None], k_multiscale=[999])
    return dict(
        query_model="StaticKeypointModel",
        score_head_kwargs=dict(max_time=1.0, time_emb_mlp=[32, 32, 16], ang_mult=2.5, lin_mult=15.0,
                               edge_time_encoding=True, query_time_encoding=False, key_tensor_field_kwargs=head_tf),
        key_kwargs=dict(feature_extractor_name="UnetFeatureExtractor", feature_extractor_kwargs=fe_kwargs,
                        tensor_field_kwargs=key_tf, keypoint_kwargs=dict(pool_ratio=0.2, weight_pre_emb_dim=8),
                        weight_activation="sigmoid", weight_mult=None),
        query_kwargs=dict(irreps_output=IRREPS, keypoint_coords=[[0.5, 0.5, 1.0], [-0.5, -0.5, 1.0]]),
    )


def _compare(tmodel, jmodel, params, x, f, mask, Ts, time, atol, jit=True):
    """Key cloud (with its point weights), query and score of one request;
    ``jit=False`` runs the JAX model eagerly."""
    tscene, jscene = _scene(x, f, mask)

    def run(p, s, T, tt):
        km = jmodel.apply(p, s, method=jmodel.get_key_pcd_multiscale)
        q = jmodel.apply(p, s, method=jmodel.get_query_pcd)
        return km, q, jmodel.apply(p, T, km, q, tt, method=jmodel.score)

    jkm, jq, (jang, jlin) = jax.tree_util.tree_map(np.asarray, (jax.jit(run) if jit else run)(
        params, jscene, jnp.asarray(Ts), jnp.asarray(time)))
    with torch.no_grad():
        tkm, tq = tmodel.get_key_pcd_multiscale(tscene), tmodel.get_query_pcd(tscene)
        tang, tlin = (s[0] for s in tmodel.score(*one_request(Ts, tkm, tq, time)))
    assert len(jkm) == len(tkm) == 1
    key = tkm[0]
    np.testing.assert_array_equal(jkm[0].mask, key.mask.numpy())
    for name in ("x", "f", "w"):
        np.testing.assert_allclose(getattr(jkm[0], name), getattr(key, name).numpy(), atol=atol, err_msg=name)
    assert (key.w[~key.mask] == 0).all()
    np.testing.assert_allclose(jq.f, tq.f.detach().numpy(), atol=atol)
    scale = max(1.0, float(np.abs(jang).max()), float(np.abs(jlin).max()))
    np.testing.assert_allclose(jang, tang.numpy(), atol=atol * scale)
    np.testing.assert_allclose(jlin, tlin.numpy(), atol=atol * scale)
    return key


def test_point_attentive_model_matches_jax():
    """Against the JAX model run eagerly: under ``jax.jit`` XLA moves the key
    cloud's features by up to 1.3e-4 here (the keypoint tensor field; its
    feature extractor agrees to 7e-7 either way), where the port and eager
    JAX agree to 5e-7."""
    kw = _point_attentive_kwargs()
    tmodel = init_params(PointAttentiveScoreModel(**copy.deepcopy(kw)), torch.Generator().manual_seed(5))
    with torch.no_grad():  # point weights away from 0.5, where their effect on the softmax would be uniform
        tmodel.key_model.weight_dense.bias.fill_(0.4)
    assert isinstance(tmodel.key_model, KeypointExtractor)
    assert tmodel.score_head.key_tensor_field.gnn_block_init.use_src_point_attn
    key = _compare(tmodel, JPointAttentive(**kw), torch_to_jax_params(tmodel), *_inputs(64, 56, 3, seed=5),
                   atol=GATE, jit=False)
    assert key.x.shape == (int(np.ceil(0.2 * 64)), 3)
    assert np.ptp(key.w[key.mask].numpy()) > 1e-4  # weights that matter


SAPIEN_CONFIGS = [f"{family}/{m}" for family in ("sapien", "sapien_bottle")
                  for m in ("pick_lowres", "pick_highres", "place_lowres", "place_highres")] + ["sapien/pick_lowres_synth"]


@pytest.mark.parametrize("name", SAPIEN_CONFIGS)
def test_factory_builds_the_sapien_configs(name):
    """Both sapien model names build from every sapien config: the lowres
    models as ``PointAttentiveScoreModel`` on a ``KeypointExtractor`` key, the
    highres models as ``MultiscaleScoreModel`` on a forward-only extractor."""
    with open(ROOT / "diffusion_edf_tpu" / "configs" / name / "score_model_configs.yaml") as fh:
        cfg = yaml.safe_load(fh)
    model = t_build(cfg["model_name"], cfg["model_kwargs"])
    if name.endswith(("lowres", "lowres_synth")):
        assert cfg["model_name"] == "PointAttentiveScoreModel" and isinstance(model, PointAttentiveScoreModel)
        assert isinstance(model.key_model, KeypointExtractor)
        assert model.score_head.key_tensor_field.gnn_block_init.use_src_point_attn
    else:
        assert isinstance(model, MultiscaleScoreModel)
        assert isinstance(model.key_model, ForwardOnlyFeatureExtractor)
    assert all(p.is_floating_point() for p in model.parameters())


def test_sapien_highres_keys_match_jax():
    """No checkpoint ships for a sapien highres model: its flax keys and
    shapes against the JAX model's, from ``jax.eval_shape`` of its init."""
    with open(ROOT / "diffusion_edf_tpu_torch" / "configs" / "sapien" / "pick_highres" / "score_model_configs.yaml") as fh:
        cfg = yaml.safe_load(fh)
    model = t_build(cfg["model_name"], cfg["model_kwargs"])
    n = 128
    s = JFP(x=jnp.zeros((n, 3)), f=jnp.zeros((n, 3)), mask=jnp.ones((n,), bool))
    shapes = jax.eval_shape(j_build(cfg["model_name"], cfg["model_kwargs"]).init, jax.random.PRNGKey(0),
                            jnp.zeros((2, 7)), s, s, jnp.ones((2,)))
    jkeys = {"/".join(str(getattr(k, "key", k)) for k in path): tuple(leaf.shape)
             for path, leaf in jax.tree_util.tree_leaves_with_path(shapes)}
    tkeys = {}
    for name, p in model.named_parameters():
        key, idx = flax_key(name)
        tkeys.setdefault(key, []).append((idx, tuple(p.shape)))
    assert set(tkeys) == set(jkeys)
    for key, items in tkeys.items():
        shape = items[0][1] if not items[0][0] else (len(items),) + items[0][1]
        assert shape == jkeys[key], key


@pytest.mark.slow
def test_full_width_sapien_checkpoint_score_matches_jax():
    """The shipped ``sapien/pick_lowres`` checkpoint at full width: 3e-4.
    Its point weights are 0.5 everywhere: the checkpoint's ``weight_dense``
    is all zero."""
    with open(ROOT / "diffusion_edf_tpu_torch" / "configs" / "sapien" / "pick_lowres" / "score_model_configs.yaml") as fh:
        cfg = yaml.safe_load(fh)
    tmodel = load_params_npz(t_build(cfg["model_name"], cfg["model_kwargs"]),
                             str(ROOT / "checkpoints" / "sapien" / "pick_lowres.npz"))
    jmodel = j_build(cfg["model_name"], cfg["model_kwargs"])
    _compare(tmodel, jmodel, torch_to_jax_params(tmodel), *_inputs(256, 240, 4, seed=0), atol=3e-4)
