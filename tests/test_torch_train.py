"""Training in the port against the JAX package, on the CPU at tiny widths
(the whole train step against ``jax.value_and_grad`` is in
``test_torch_train_step.py``).

* the routing of autograd and dropout away from the kernels (the CUDA
  launch itself is refused in ``test_torch_cuda.py``);
* dropout (the irreps dropout and the attention-weight dropout) given the
  same keep masks, to 1e-6 and 2e-5, and its keep rate and scale;
* the straight-through clamp of the edge cutoff;
* augmentation, the symmetry-orbit frame, ranked poses and their loss, and
  the score-matching loss with its statistics, given the same draws, to 1e-6;
* the optimizer against optax (``make_optimizer``), five updates, 1e-6
  relative;
* derived-weight caches after an update, the trainer end to end (two
  epochs, the log's keys, ``save`` / ``restore`` bit-equal and the next step
  equal to an uninterrupted run's, ``export`` read with exact keys by both
  packages and scored alike), and the synthetic demos bit-equal."""
import copy
import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import yaml

import __graft_entry__ as ge
from diffusion_edf_tpu import agent as jagent
from diffusion_edf_tpu.geom import so3 as jso3
from diffusion_edf_tpu.geom.irreps import Irreps
from diffusion_edf_tpu.models.data import FeaturedPoints as JFP
from diffusion_edf_tpu.models.score_model import train_loss as j_train_loss
from diffusion_edf_tpu.nn.attention import GraphAttention as JGA
from diffusion_edf_tpu.nn.layers import EquivariantDropout as JDrop
from diffusion_edf_tpu.train import augment as jaug
from diffusion_edf_tpu.train import data as jdata
from diffusion_edf_tpu.train import ranking as jrank
from diffusion_edf_tpu.train import synthetic as jsyn
from diffusion_edf_tpu.train.factory import build_score_model as j_build
from diffusion_edf_tpu.train.trainer import make_optimizer
from diffusion_edf_tpu_torch.data import FeaturedPoints as TFP
from diffusion_edf_tpu_torch.models.edge import st_clamp_min
from diffusion_edf_tpu_torch.models.score_model import train_loss as t_train_loss
from diffusion_edf_tpu_torch.nn import attention as tattn
from diffusion_edf_tpu_torch.nn import layers as tlayers
from diffusion_edf_tpu_torch.nn.attention import GraphAttention as TGA
from diffusion_edf_tpu_torch.train import augment as taug
from diffusion_edf_tpu_torch.train import data as tdata
from diffusion_edf_tpu_torch.train import ranking as trank
from diffusion_edf_tpu_torch.train import synthetic as tsyn
from diffusion_edf_tpu_torch.train.factory import build_score_model as t_build
from diffusion_edf_tpu_torch.train.optim import Amsgrad
from diffusion_edf_tpu_torch.train.trainer import DiffusionEdfTrainer
from diffusion_edf_tpu_torch.weights import flat_arrays, init_params, load_flat_params, load_params_npz

from .test_torch_edge_kernel import SH, TINY, _ga_inputs
from .test_torch_tables import torch_to_jax_params
from .test_torch_train_geom import EXACT, jax_draws, npy, t

torch.set_num_threads(1)
TRAIN_CFG = dict(
    model_config_file="score_model_configs.yaml",
    rescale_factor=100.0,
    preprocess_config=[
        dict(name="downsample", kwargs=dict(voxel_size=0.01, coord_reduction="average")),
        dict(name="rescale", kwargs=dict(rescale_factor=100.0)),
    ],
    n_samples_x_ref=4,
    diffusion_configs=dict(t_augment=None, time_schedules=[[1.0, 0.15], [0.15, 0.01]]),
    optimizer_kwargs=dict(lr=3e-4, betas=[0.9, 0.98], eps=1e-9, weight_decay=1e-4, amsgrad=True),
)


def _model_cfg(ebm=False, drop=0.0):
    cfg = copy.deepcopy(ge._model_config(tiny=True))
    mk = cfg["model_kwargs"]
    mk["score_head_kwargs"]["key_tensor_field_kwargs"]["alpha_drop"] = drop
    mk["key_kwargs"]["feature_extractor_kwargs"]["alpha_drop"] = drop
    if ebm:  # as configs/panda_mug/pick_ebm: no time encoding on the edges
        mk["score_head_kwargs"].update(ebm=True, edge_time_encoding=False)
    return cfg


def _config_dir(root, ebm=False, drop=0.0, task="pick"):
    train = copy.deepcopy(TRAIN_CFG)
    if ebm:  # as configs/panda_mug/pick_ebm, with fewer negatives
        train["diffusion_configs"]["time_schedules"] = [[0.03, 0.03]]
        train["critic_rank_configs"] = dict(weight=1.0, n_negatives=8)
    d = root / f"cfg_{'ebm' if ebm else 'score'}_{drop}_{task}"
    d.mkdir(exist_ok=True)
    for name, c in (("train_configs.yaml", train), ("task_configs.yaml", dict(task_type=task, contact_radius=0.02)),
                    ("score_model_configs.yaml", _model_cfg(ebm, drop))):
        (d / name).write_text(yaml.safe_dump(c))
    return str(d)


def _demos(n=2, family="mug"):
    return tsyn.make_synthetic_dataset(n_demos=n, seed=0, family=family, n_scene=600, n_grasp=150)


def _trainer(root, ebm=False, drop=0.0, task="pick", log="run", **kw):
    return DiffusionEdfTrainer(_config_dir(root, ebm, drop, task), log_dir=str(root / log), n_scene_pad=512,
                               n_grasp_pad=160, device="cpu", **kw)


def _jfp(p):
    return JFP(x=jnp.asarray(npy(p.x)), f=jnp.asarray(npy(p.f)), mask=jnp.asarray(npy(p.mask)))


# --------------------------------------------------------------------------- #
# the kernels refuse autograd and dropout
# --------------------------------------------------------------------------- #
class _CudaLike:
    """Stands in for a CUDA message in ``GraphAttention._route``: the
    routing reads ``is_cuda`` of the message and ``requires_grad`` of every
    tensor."""

    is_cuda = True


def _ga(alpha_drop=0.1, proj_drop=0.0, seed=0):
    m = TGA(TINY, SH, TINY, fc_neurons=(8, 16), num_heads=2, alpha_drop=alpha_drop, proj_drop=proj_drop)
    return init_params(m, torch.Generator().manual_seed(seed))


def test_default_route_is_plain_under_autograd_or_dropout():
    m = _ga()
    assert not m.training  # built deterministic, as the JAX module's default
    msg = _CudaLike()
    with torch.no_grad():
        assert m._route(msg) == "kernel"
    assert m._route(msg) == "plain"  # grad on, and the parameters require grad
    for p in m.parameters():
        p.requires_grad_(False)
    assert m._route(msg) == "kernel"
    assert m._route(msg, torch.zeros(1, requires_grad=True)) == "plain"  # an input requires grad
    m.train()
    with torch.no_grad():
        assert m._route(msg) == "plain"  # dropout is on
        assert _ga(alpha_drop=0.0).train()._route(msg) == "kernel"  # train() without dropout
    m.eval()
    assert m._route(torch.zeros(1)) == "plain"  # a CPU message


@pytest.mark.parametrize("impl", ["kernel", "kernel_bf16", "fused"])
def test_explicit_kernel_refuses_autograd_and_dropout(impl):
    m = _ga()
    m.edge_impl = impl
    msg, attr, sc, mask, pre, post = (t(a) for a in _ga_inputs(TINY))
    with pytest.raises(RuntimeError, match="no backward"):
        m(msg, attr, sc, mask, edge_pre_attn_logit=pre, edge_post_attn=post)
    with torch.no_grad():
        m(msg, attr, sc, mask, edge_pre_attn_logit=pre, edge_post_attn=post)  # on the CPU: the plain version
        m.train()
        with pytest.raises(RuntimeError, match="no dropout"):
            m(msg, attr, sc, mask, edge_pre_attn_logit=pre, edge_post_attn=post)


def test_default_route_trains_through_the_plain_path():
    """``edge_impl=None`` under autograd gives the plain path's gradients."""
    msg, attr, sc, mask, pre, post = (t(a) for a in _ga_inputs(TINY))
    grads = []
    for impl in (None, "plain"):
        m = _ga(alpha_drop=0.0)
        m.edge_impl = impl
        m(msg, attr, sc, mask, edge_pre_attn_logit=pre, edge_post_attn=post).square().sum().backward()
        grads.append([p.grad.clone() for p in m.parameters()])
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


# --------------------------------------------------------------------------- #
# dropout
# --------------------------------------------------------------------------- #
@pytest.fixture
def port_keeps(monkeypatch):
    """``keeps(list)``: the port's dropouts take these keep masks in turn."""
    queue = []

    def fake(shape, rate, generator, device):
        keep = queue.pop(0)
        assert tuple(keep.shape) == tuple(shape)
        return keep

    monkeypatch.setattr(tattn, "keep_mask", fake)
    monkeypatch.setattr(tlayers, "keep_mask", fake)

    def keeps(masks):
        queue.extend(torch.as_tensor(np.asarray(k)) for k in masks)
        return queue

    return keeps


def test_equivariant_dropout_matches_jax(port_keeps):
    irreps = "8x0e+4x1e+2x2e"
    rng = np.random.default_rng(0)
    f = rng.normal(size=(50, Irreps(irreps).dim)).astype(np.float32)
    keep = rng.uniform(size=(50, Irreps(irreps).num_irreps)) < 0.75
    with jax_draws(bernoulli=[keep]):
        j = JDrop(irreps=Irreps(irreps), rate=0.25).apply({}, jnp.asarray(f), deterministic=False,
                                                          rngs={"dropout": jax.random.PRNGKey(0)})
    m = tlayers.EquivariantDropout(irreps, 0.25)
    np.testing.assert_array_equal(npy(m(t(f))), f)  # eval(): the identity
    queue = port_keeps([keep])
    out = npy(m.train()(t(f)))
    assert not queue
    np.testing.assert_allclose(out, np.asarray(j), rtol=EXACT, atol=EXACT)


def test_attention_dropout_matches_jax(port_keeps):
    """The attention weights dropped after the softmax (``alpha_drop``) and
    whole irreps of the output (``proj_drop``), against the flax module on
    the same keep masks, at tiny width to 2e-5."""
    m = _ga(alpha_drop=0.3, proj_drop=0.2, seed=1)
    ref = JGA(irreps_input=Irreps(TINY), irreps_edge_attr=Irreps(SH), irreps_output=Irreps(TINY), fc_neurons=(8, 16),
              num_heads=2, alpha_drop=0.3, proj_drop=0.2, message_component_major=True)
    msg, attr, sc, mask, pre, post = _ga_inputs(TINY)
    rng = np.random.default_rng(2)
    keep_alpha = rng.uniform(size=(mask.shape[0], 2, mask.shape[1])) < 0.7
    keep_proj = rng.uniform(size=(mask.shape[0], Irreps(TINY).num_irreps)) < 0.8
    with jax_draws(bernoulli=[keep_alpha, keep_proj]):
        j = ref.apply(torch_to_jax_params(m), *map(jnp.asarray, (msg, attr, sc, mask)), edge_pre_attn_logit=jnp.asarray(pre),
                      edge_post_attn=jnp.asarray(post), deterministic=False, rngs={"dropout": jax.random.PRNGKey(0)})
    port_keeps([keep_alpha, keep_proj])
    with torch.no_grad():
        out = m.train()(t(msg), t(attr), t(sc), t(mask), edge_pre_attn_logit=t(pre), edge_post_attn=t(post))
    np.testing.assert_allclose(npy(out), np.asarray(j), atol=2e-5)


def test_dropout_keep_rate_and_scale():
    """Drawn masks keep 1 - rate of the irreps (within 4 binomial standard
    deviations), whole irreps at a time, and keep the mean (1 / (1 - rate))."""
    irreps = Irreps("8x0e+4x1e+2x2e")
    g = torch.Generator().manual_seed(0)
    m = tlayers.EquivariantDropout(irreps, 0.1).train()
    m.dropout_generator = g
    out = npy(m(torch.ones(20000, irreps.dim)))
    kept = out != 0
    n = kept[:, :8].size
    assert abs(kept[:, :8].mean() - 0.9) < 4 * np.sqrt(0.09 / n)
    vec = kept[:, 8:20].reshape(20000, 4, 3)
    assert np.all(vec.all(-1) | ~vec.any(-1))  # a vector irrep goes whole
    assert abs(out.mean() - 1.0) < 0.01 and np.allclose(out[kept], 1 / 0.9)
    keep = tlayers.keep_mask((400, 50), 0.1, g, "cpu")
    assert keep.dtype == torch.bool and abs(float(keep.float().mean()) - 0.9) < 4 * np.sqrt(0.09 / keep.numel())


def test_st_clamp_min_has_the_identity_gradient():
    x = torch.tensor([1e-20, 1e-13, 5e-12, 0.5, 2.0], dtype=torch.float32, requires_grad=True)
    y = st_clamp_min(x, 1e-12)
    np.testing.assert_array_equal(npy(y), np.maximum(npy(x), 1e-12))
    (g,) = torch.autograd.grad((y * torch.arange(1.0, 6.0)).sum(), x)
    np.testing.assert_array_equal(npy(g), np.arange(1.0, 6.0))  # below the floor too


# --------------------------------------------------------------------------- #
# augmentation, ranking, loss
# --------------------------------------------------------------------------- #
def _clouds(rng, n=60):
    def cloud(nv):
        return TFP(x=t(rng.uniform(-10, 10, (n, 3)).astype(np.float32)), f=t(rng.uniform(0, 1, (n, 3)).astype(np.float32)),
                   mask=t(np.arange(n) < nv))
    return cloud(50), cloud(40)


@pytest.mark.parametrize("cfg", [
    taug.AugmentConfig(False, False, 0.0, 1.0, 0.0),
    taug.AugmentConfig(),
    taug.AugmentConfig(rotate_scene=True, rotate_grasp=True, jitter_std=0.5, point_keep=0.8, color_std=0.05),
], ids=["off", "default", "all"])
def test_augment_batch_given_the_draws_matches_jax(cfg):
    rng = np.random.default_rng(3)
    scene, grasp = _clouds(rng)
    T = t(np.concatenate([jso3.random_quaternions(jax.random.PRNGKey(1), 1), [[1.0, 2.0, 3.0]]], -1).astype(np.float32))
    draws = taug.augment_draws(scene, grasp, cfg, torch.Generator().manual_seed(0))
    s2, g2, T2 = taug.augment_batch_given(scene, grasp, T, cfg, draws)
    if not any(cfg[:2]) and not cfg.jitter_std and cfg.point_keep == 1.0 and not cfg.color_std:
        assert not draws
        for a, b in ((s2.x, scene.x), (g2.x, grasp.x), (s2.mask, scene.mask), (s2.f, scene.f)):
            np.testing.assert_array_equal(npy(a), npy(b))
        np.testing.assert_allclose(npy(T2), npy(T), atol=EXACT)
    jq = dict(normal=[npy(draws[k])[None] if k.startswith("rot") else npy(draws[k])
                      for k in ("rot_scene", "rot_grasp", "jitter_scene", "jitter_grasp", "color_scene", "color_grasp")
                      if k in draws],
              bernoulli=[npy(draws[k]) for k in ("keep_scene", "keep_grasp") if k in draws])
    with jax_draws(**{k: v for k, v in jq.items() if v}):
        js, jg, jT = jaug.augment_batch(jax.random.PRNGKey(0), _jfp(scene), _jfp(grasp), jnp.asarray(npy(T)),
                                        jaug.AugmentConfig(*cfg))
    for name, a, b in (("scene.x", s2.x, js.x), ("grasp.x", g2.x, jg.x), ("scene.f", s2.f, js.f),
                       ("grasp.f", g2.f, jg.f), ("T", T2, jT)):
        np.testing.assert_allclose(npy(a), np.asarray(b), rtol=EXACT, atol=1e-5, err_msg=name)
    np.testing.assert_array_equal(npy(s2.mask), np.asarray(js.mask))
    np.testing.assert_array_equal(npy(g2.mask), np.asarray(jg.mask))


def test_orbit_frame_matches_jax():
    """The symmetry-orbit transport: the target rotated about world z through
    the orbit centre (``_frame_about`` then ``multiply_se3``)."""
    rng = np.random.default_rng(4)
    T = np.concatenate([np.asarray(jso3.random_quaternions(jax.random.PRNGKey(2), 5)),
                        rng.uniform(-20, 20, (5, 3))], -1).astype(np.float32)
    c = np.float32([3.0, -7.0, 30.0])
    for theta in (0.0, 1.3, 5.9):
        qz = np.float32([np.cos(theta / 2), 0, 0, np.sin(theta / 2)])
        A_t, A_j = taug._frame_about(t(qz), t(c)), jaug._frame_about(jnp.asarray(qz), jnp.asarray(c))
        np.testing.assert_allclose(npy(A_t), np.asarray(A_j), rtol=EXACT, atol=1e-5)
        out = npy(taug.so3.multiply_se3(A_t[None], t(T)))
        np.testing.assert_allclose(out, np.asarray(jso3.multiply_se3(A_j[None], jnp.asarray(T))), rtol=EXACT, atol=1e-5)
        # the orbit's centre and every height stay put; the distance to the axis too
        np.testing.assert_allclose(out[:, 6], T[:, 6], atol=1e-5)
        np.testing.assert_allclose(np.linalg.norm(out[:, 4:6] - c[:2], axis=-1), np.linalg.norm(T[:, 4:6] - c[:2], axis=-1),
                                   rtol=1e-5)


def test_ranked_poses_and_rank_loss_match_jax():
    cfg = trank.RankConfig(n_negatives=16)
    T = np.concatenate([np.asarray(jso3.random_quaternions(jax.random.PRNGKey(3), 1))[0], [1.0, -2.0, 30.0]]).astype(np.float32)
    draws = trank.rank_draws(16, torch.Generator().manual_seed(0), torch.float32, "cpu")
    Ts, bad = trank.sample_ranked_poses_given(t(T), cfg, draws)
    with jax_draws(uniform=[npy(draws["u_trans"]), npy(draws["u_rot"])], normal=[npy(draws["dirs"]), npy(draws["axes"])]):
        jTs, jbad = jrank.sample_ranked_poses(jax.random.PRNGKey(0), jnp.asarray(T), jrank.RankConfig(*cfg))
    np.testing.assert_allclose(npy(Ts), np.asarray(jTs), rtol=EXACT, atol=1e-5)
    np.testing.assert_allclose(npy(bad), np.asarray(jbad), rtol=EXACT, atol=1e-5)
    E = np.random.default_rng(5).normal(size=17).astype(np.float32) * 0.3
    loss, acc = trank.rank_loss(t(E), bad, cfg)
    jl, ja = jrank.rank_loss(jnp.asarray(E), jbad, jrank.RankConfig(*cfg))
    np.testing.assert_allclose(float(loss), float(jl), rtol=EXACT)
    np.testing.assert_allclose(float(acc), float(ja), rtol=EXACT)


def test_train_loss_and_statistics_match_jax():
    rng = np.random.default_rng(6)
    a = [rng.normal(size=(40, 3)).astype(np.float32) for _ in range(4)]
    time = rng.uniform(0.01, 1.0, 40).astype(np.float32)
    loss, stats = t_train_loss(*map(t, a), t(time), 2.5, 15.0)
    jl, jstats = j_train_loss(*map(jnp.asarray, a), jnp.asarray(time), 2.5, 15.0)
    assert set(stats) == set(jstats)
    for k in stats:
        np.testing.assert_allclose(float(stats[k]), float(jstats[k]), rtol=EXACT, atol=EXACT, err_msg=k)


# --------------------------------------------------------------------------- #
# the optimizer
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("opt_kwargs", [
    dict(lr=3e-4, betas=[0.9, 0.98], eps=1e-9, weight_decay=1e-4, amsgrad=True),
    dict(lr=1e-3, betas=[0.9, 0.98], eps=1e-9, weight_decay=1e-4, grad_clip_norm=0.5, lr_min_factor=0.1),
], ids=["config_chain", "clip_and_cosine"])
def test_optimizer_matches_optax(opt_kwargs):
    rng = np.random.default_rng(7)
    shapes = {"a": (5, 4), "b": (7,), "c": (3, 2, 2)}
    params = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: (rng.normal(size=s) * (3.0 if i % 2 else 0.05)).astype(np.float32) for k, s in shapes.items()}
             for i in range(5)]
    tx = make_optimizer(dict(opt_kwargs), total_steps=5)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    state = tx.init(jp)
    tp = [t(params[k]) for k in shapes]
    opt = Amsgrad.from_config(tp, opt_kwargs, total_steps=5)
    for g in grads:
        upd, state = tx.update({k: jnp.asarray(v) for k, v in g.items()}, state, jp)
        jp = optax.apply_updates(jp, upd)
        opt.step([t(g[k]) for k in shapes])
        for k, p in zip(shapes, tp):
            np.testing.assert_allclose(npy(p), np.asarray(jp[k]), rtol=EXACT, atol=EXACT * np.abs(params[k]).max())
    # torch's AMSGrad keeps the maximum of the uncorrected moment: it parts from optax at once
    tq = [t(params[k]) for k in shapes]
    ref = torch.optim.Adam(tq, lr=opt_kwargs["lr"], betas=opt_kwargs["betas"], eps=1e-9, amsgrad=True)
    for g in grads[:2]:
        for p, k in zip(tq, shapes):
            p.grad = t(g[k])
        ref.step()
    assert max(float(np.abs(npy(a) - npy(b)).max()) for a, b in zip(tq, tp)) > 1e-6


# --------------------------------------------------------------------------- #
# the trainer
# --------------------------------------------------------------------------- #
def test_caches_follow_the_update(tmp_path):
    """A no_grad score after a train step equals a freshly loaded model
    holding the stepped weights: the step bumps the parameters' versions,
    so the derived dense matrices are rebuilt."""
    tr = _trainer(tmp_path)
    tr.init(_demos(1))
    b = tr.batches[0]
    Ts = b.T.expand(3, 7).clone()
    Ts[:, 4:] += torch.tensor([[0.0, 0.0, 0.0], [1.0, 0.0, 0.0], [0.0, -2.0, 1.0]])
    time = torch.tensor([0.1, 0.4, 0.8])

    def score(model):
        with torch.no_grad():
            return model.score(Ts, model.get_key_pcd_multiscale(b.scene), model.get_query_pcd(b.grasp), time)

    before = score(tr.model)  # fills the caches
    tr.step(b)
    tr.model.eval()
    after = score(tr.model)
    fresh = load_flat_params(t_build(tr.model_cfg["model_name"], tr.model_cfg["model_kwargs"]), flat_arrays(tr.model))
    again = score(fresh)
    for a, f, z in zip(after, again, before):
        torch.testing.assert_close(a, f, rtol=0, atol=0)
        assert float((a - z).abs().max()) > 0


def _jsonl(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def test_trainer_end_to_end(tmp_path):
    """Two epochs with dropout on; the log has the JAX logger's keys; save
    and restore are bit-equal and the next epoch equals that of the run that
    went on; export is read with exact keys by both packages, and the JAX
    model scores it as the port does."""
    demos = _demos(2)
    tr = _trainer(tmp_path, drop=0.1)
    tr.init(demos)
    assert tr.model.key_model.down.pool_layer_0.gnn.ga.alpha_drop == 0.1
    stats = [tr.train_epoch() for _ in range(2)]
    assert all(np.isfinite(v) for s in stats for v in s.values())
    rows = _jsonl(tmp_path / "run" / "metrics.jsonl")
    assert [r["step"] for r in rows] == [1, 2, 3, 4]
    _, jstats = j_train_loss(*(jnp.ones((2, 3)),) * 4, jnp.ones((2,)), 1.0, 1.0)
    assert set(rows[0]) == {"step", "time", "grad_norm"} | set(jstats)

    tr.record_pcd(0)
    with np.load(tmp_path / "run" / "custom_data" / "step_4" / "train_snapshot.npz") as z:
        assert z["diffused_poses"].shape == (tr.n_samples_x_ref, 7) and z["scene_x"].shape == (512, 3)
    path = tr.save()
    assert path.endswith("checkpoint/2.npz")
    saved = dict(np.load(path))
    cont = tr.train_epoch()
    cont_params = [p.detach().clone() for p in tr.params]

    tr2 = _trainer(tmp_path, drop=0.1, log="run2")
    tr2.init(demos)
    tr2.restore(path)
    again = tr2._state()
    assert set(again) == set(saved)
    for k in saved:
        np.testing.assert_array_equal(again[k], saved[k], err_msg=k)
    assert (tr2.epoch, tr2.steps) == (2, 4)
    assert tr2.train_epoch() == cont
    for a, b in zip(tr2.params, cont_params):
        torch.testing.assert_close(a, b, rtol=0, atol=0)

    out = tr.export(str(tmp_path / "export" / "tiny.npz"))
    cfg = tr.model_cfg
    port = load_params_npz(t_build(cfg["model_name"], cfg["model_kwargs"]), out)
    for a, b in zip(port.parameters(), tr.params):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    jmodel = j_build(cfg["model_name"], cfg["model_kwargs"])
    b = tr.batches[0]
    Ts = np.concatenate([npy(b.T), npy(b.T) + np.float32([0, 0, 0, 0, 1.0, -1.0, 0.5])])
    time = np.float32([0.2, 0.6])
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0), jnp.asarray(Ts), _jfp(b.scene), _jfp(b.grasp),
                            jnp.asarray(time))
    jparams = jagent.load_params_npz(out, shapes)  # exact keys and shapes, or it raises
    jang, jlin = jax.jit(jmodel.apply)(jparams, jnp.asarray(Ts), _jfp(b.scene), _jfp(b.grasp), jnp.asarray(time))
    with torch.no_grad():
        port.eval()
        tang, tlin = port(t(Ts), b.scene, b.grasp, t(time))
    np.testing.assert_allclose(npy(tang), np.asarray(jang), atol=1e-4)
    np.testing.assert_allclose(npy(tlin), np.asarray(jlin), atol=1e-4)


def test_trainer_orbit_branch_and_device(tmp_path):
    """Bowl pick demos record a z-orbit, mug pick demos none: a step rotates
    the target about world z through the orbit's centre only when one is
    recorded (and draws no angle otherwise).  The trainer refuses a CUDA
    device it does not have."""
    tr = _trainer(tmp_path)
    tr.init(_demos(1, family="bowl") + _demos(1))
    on, off = tr.batches
    assert on.sym_on and not off.sym_on
    state = tr.generator.get_state()
    np.testing.assert_array_equal(npy(tr.orbit_target(off)), npy(off.T))
    assert torch.equal(tr.generator.get_state(), state)
    T, c = npy(on.T)[0], npy(on.sym_center)
    moved = np.stack([npy(tr.orbit_target(on))[0] for _ in range(4)])
    np.testing.assert_allclose(moved[:, 6], T[6], atol=1e-4)  # heights stay
    np.testing.assert_allclose(np.linalg.norm(moved[:, 4:6] - c[:2], axis=-1), np.linalg.norm(T[4:6] - c[:2]), rtol=1e-5)
    assert np.ptp(moved[:, 4], axis=0) > 1e-2  # the angles differ
    # the rotation is about z: it leaves the target's rotated z axis' height unchanged
    z_axis = np.asarray(jso3.quaternion_apply(jnp.asarray(moved[:, :4]), jnp.float32([0, 0, 1])))
    np.testing.assert_allclose(z_axis[:, 2], np.asarray(jso3.quaternion_apply(jnp.asarray(T[:4]), jnp.float32([0, 0, 1])))[2],
                               atol=1e-5)
    tr_off = _trainer(tmp_path, log="run_off")
    tr_off.sym_orbit_augment = False
    tr_off.init(_demos(1, family="bowl"))
    assert not tr_off.batches[0].sym_on
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            DiffusionEdfTrainer(_config_dir(tmp_path), device="cuda")


# --------------------------------------------------------------------------- #
# data
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("family", ["mug", "bowl", "bottle"])
def test_synthetic_demos_bit_equal(family):
    for kw in (dict(), dict(diverse=True, clutter_heavy=True)):
        a = tsyn.make_synthetic_dataset(n_demos=2, seed=5, family=family, **kw)
        b = jsyn.make_synthetic_dataset(n_demos=2, seed=5, family=family, **kw)
        for sa, sb in zip(a, b):
            assert len(sa) == len(sb) == 2
            for x, y in zip(sa.steps, sb.steps):
                for arr_a, arr_b in ((x.scene_pcd.points, y.scene_pcd.points), (x.scene_pcd.colors, y.scene_pcd.colors),
                                     (x.grasp_pcd.points, y.grasp_pcd.points), (x.grasp_pcd.colors, y.grasp_pcd.colors),
                                     (x.target_poses, y.target_poses)):
                    np.testing.assert_array_equal(arr_a, arr_b)
                assert (x.name, x.symmetry) == (y.name, y.symmetry)


def test_demo_files_round_trip_both_ways(tmp_path):
    demo = tsyn.make_synthetic_dataset(n_demos=1, seed=2)[0]
    tdata.save_demo_sequence(demo, str(tmp_path / "a"))
    jdata.save_demo_sequence(jsyn.make_synthetic_dataset(n_demos=1, seed=2)[0], str(tmp_path / "b"))
    for d in ("a", "b"):
        x, y = tdata.load_demo_sequence(str(tmp_path / d)), jdata.load_demo_sequence(str(tmp_path / d))
        for sx, sy in zip(x.steps, y.steps):
            np.testing.assert_array_equal(sx.scene_pcd.points, sy.scene_pcd.points)
            np.testing.assert_array_equal(sx.target_poses, sy.target_poses)
            assert sx.name == sy.name == d
    (tmp_path / "data.yaml").write_text(yaml.safe_dump([{"path": "a"}, {"path": "b"}]))
    ds = tdata.DemoDataset(str(tmp_path))
    assert len(ds) == 2 and ds[1] is ds[1]
    np.testing.assert_array_equal(ds[0][1].grasp_pcd.colors, demo[1].grasp_pcd.colors)
