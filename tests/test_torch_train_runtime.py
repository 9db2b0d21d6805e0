"""The trainer's compiled step (``DiffusionEdfTrainer(use_runtime=True)``)
on the CPU, where each entry's program runs the step eagerly over the static
demo buffers that the card captures: two epochs bit-equal to the eager
trainer (``use_runtime=False``) on the tiny score model and the tiny
critic, dropout on and one demo with a symmetry orbit; one entry per demo
shape and orbit branch, none new in the second epoch; a resumed run equal
to an uninterrupted one; the caches of derived weights and the agent's
runtime entries rebuilt after an epoch; and ``Amsgrad``'s step count on the
device against optax over a cosine horizon that the updates cross.  The
captured step on the card is ``tests/test_torch_cuda.py``'s."""
import json

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from diffusion_edf_tpu.train.trainer import make_optimizer
from diffusion_edf_tpu_torch.agent import DiffusionEdfAgent, ModelBundle
from diffusion_edf_tpu_torch.data import stack_points
from diffusion_edf_tpu_torch.diffusion.diffuse import _draw_indices
from diffusion_edf_tpu_torch.train.data import PointCloud
from diffusion_edf_tpu_torch.train.factory import build_score_model as t_build
from diffusion_edf_tpu_torch.train.optim import Amsgrad
from diffusion_edf_tpu_torch.weights import flat_arrays, load_flat_params

from .test_torch_train import _demos, _trainer
from .test_torch_train_geom import EXACT, npy, t

torch.set_num_threads(1)


def _rows(tr):
    with open(f"{tr.log_dir}/metrics.jsonl") as f:
        return [{k: v for k, v in json.loads(line).items() if k != "time"} for line in f]


def _state(tr):
    return {k: v for k, v in tr._state().items() if k != "__meta__"}


def _assert_same_state(a, b):
    sa, sb = _state(a), _state(b)
    assert sa.keys() == sb.keys()
    for k in sa:
        np.testing.assert_array_equal(sa[k], sb[k], err_msg=k)


def _orbit_demos():
    return _demos(2) + _demos(1, family="bowl")  # the bowl demo records a z-orbit


@pytest.mark.parametrize("ebm,t_augment", [(False, None), (True, None), (False, 0.05)],
                         ids=["score", "critic", "score_t_augment"])
def test_runtime_epochs_equal_the_eager_trainer(tmp_path, ebm, t_augment):
    """Two epochs of three demos (one with an orbit), dropout on: every
    logged statistic, the parameters, the EMA, the optimizer state and the
    generator's state bit-equal to ``use_runtime=False``; one entry per
    (shape, orbit branch), none new in the second epoch."""
    runs = {}
    for use_runtime in (False, True):
        tr = _trainer(tmp_path, ebm=ebm, drop=0.1, log=f"run_{use_runtime}", use_runtime=use_runtime)
        tr.t_augment = t_augment
        tr.init(_orbit_demos())
        assert [b.sym_on for b in tr.batches] == [False, False, True]
        tr.train_epoch()
        entries = tr.cache_size()
        last = tr.train_epoch()
        assert tr.cache_size() == entries == (2 if use_runtime else 0)
        runs[use_runtime] = tr, last
    (eager, e_last), (rt, r_last) = runs[False], runs[True]
    assert _rows(rt) == _rows(eager) and r_last == e_last
    assert len(_rows(rt)) == 6 and all(np.isfinite(v) for r in _rows(rt) for v in r.values())
    _assert_same_state(rt, eager)
    assert int(rt.optimizer.count) == 6 and rt.optimizer.count.device == rt.params[0].device


def test_step_returns_the_statistics_and_counts_entries(tmp_path):
    """``step`` returns floats with the eager step's keys and values; a
    demo of another padded shape makes a second entry."""
    tr = _trainer(tmp_path, log="rt")
    ref = _trainer(tmp_path, log="eager", use_runtime=False)
    for x in (tr, ref):
        x.init(_demos(2))
    a, b = tr.step(tr.batches[0]), ref.step(ref.batches[0])
    assert a == b and all(isinstance(v, float) for v in a.values()) and "grad_norm" in a
    assert tr.cache_size() == 1
    tr.n_scene_pad = ref.n_scene_pad = 600
    small = _demos(1)
    tr.prepare_batches(small)
    ref.prepare_batches(small)
    assert tr.step(tr.batches[0]) == ref.step(ref.batches[0])
    assert tr.cache_size() == 2
    _assert_same_state(tr, ref)


def test_resume_continues_as_the_uninterrupted_run(tmp_path):
    """Save after epoch 1, restore into a fresh runtime trainer: its epoch 2
    (logs, parameters, EMA, optimizer state, generator) equals the epoch 2
    of the trainer that went on, whose entries the restore leaves."""
    demos = _orbit_demos()
    tr = _trainer(tmp_path, drop=0.1, log="run")
    tr.init(demos)
    tr.train_epoch()
    path = tr.save()
    tr.train_epoch()
    tr2 = _trainer(tmp_path, drop=0.1, log="run2")
    tr2.init(demos)
    tr2.train_epoch()  # entries made and stepped before the restore
    entries = tr2.cache_size()
    tr2.restore(path)
    tr2.train_epoch()
    assert tr2.cache_size() == entries == 2
    assert _rows(tr2)[-3:] == _rows(tr)[-3:]
    _assert_same_state(tr2, tr)


def test_caches_and_agent_entries_follow_a_runtime_epoch(tmp_path):
    """After an epoch through the runtime, a no-grad score equals that of a
    freshly loaded model holding the trained weights (the derived dense
    matrices were rebuilt), and an agent over the trainer's model drops the
    entries it had made before the epoch."""
    tr = _trainer(tmp_path)
    tr.init(_demos(2))
    b = tr.batches[0]
    Ts = b.T.expand(3, 7).clone()
    Ts[:, 4:] += torch.tensor([[0.0, 0.0, 0.0], [1.0, 0.0, 0.0], [0.0, -2.0, 1.0]])
    time = torch.tensor([0.1, 0.4, 0.8])

    def score(model):
        with torch.no_grad():
            key_ms = [stack_points([p]) for p in model.get_key_pcd_multiscale(b.scene)]
            return model.score(Ts[None], key_ms, stack_points([model.get_query_pcd(b.grasp)]), time[None])

    tr.model.eval()
    before = score(tr.model)  # fills the caches
    agent = DiffusionEdfAgent([ModelBundle(tr.model, tr.ang_mult, tr.lin_mult, 512, 160)], [], [])
    rt = agent._runtimes[0]
    rng = np.random.default_rng(0)
    cloud = PointCloud(rng.uniform(-5, 5, (100, 3)).astype(np.float32), rng.uniform(0, 1, (100, 3)))
    rt.extract([(cloud, cloud)])
    kept = rt.entries
    rt.extract([(cloud, cloud)])
    assert rt.entries is kept and rt.cache_sizes()["extract_key"] == 1
    tr.train_epoch()
    assert tr.cache_size() == 1
    tr.model.eval()
    after = score(tr.model)
    fresh = load_flat_params(t_build(tr.model_cfg["model_name"], tr.model_cfg["model_kwargs"]), flat_arrays(tr.model))
    again = score(fresh)
    for a, f, z in zip(after, again, before):
        torch.testing.assert_close(a, f, rtol=0, atol=0)
        assert float((a - z).abs().max()) > 0
    rt.extract([(cloud, cloud)])
    assert rt.entries is not kept and rt.cache_sizes()["extract_key"] == 1


def test_moved_parameters_drop_the_entries(tmp_path):
    """A parameter rebound to new storage (``.data =``, as ``.double()`` and
    ``.to()`` do) drops every entry; an in-place write keeps them."""
    tr = _trainer(tmp_path)
    tr.init(_demos(1))
    tr.step(tr.batches[0])
    (entry,) = tr._entries.values()
    with torch.no_grad():
        tr.params[0].mul_(1.0)
    tr.step(tr.batches[0])
    assert list(tr._entries.values()) == [entry]
    p = tr.params[0]
    p.data = p.data.clone()
    tr.step(tr.batches[0])
    (new,) = tr._entries.values()
    assert new is not entry


def test_one_draw_index_is_multinomials():
    """``_draw_indices`` draws what ``torch.multinomial`` draws from the same
    generator state, one sample or several, and leaves the generator in the
    same state."""
    w = torch.rand(300, generator=torch.Generator().manual_seed(0))
    w[::4] = 0.0
    for n in (1, 5):
        for seed in range(5):
            g1, g2 = torch.Generator().manual_seed(seed), torch.Generator().manual_seed(seed)
            a = torch.multinomial(w, n, replacement=True, generator=g1)
            b = _draw_indices(w, n, g2)
            assert torch.equal(a, b) and torch.equal(g1.get_state(), g2.get_state())


def test_device_count_matches_optax_over_a_cosine_horizon():
    """Seven updates over a four-step cosine horizon with clipping and
    weight decay: every parameter within 1e-6 of optax's chain after each
    update; the count an int64 scalar on the parameters' device, the
    learning rate after the horizon ``lr * lr_min_factor``."""
    opt_kwargs = dict(lr=1e-3, betas=[0.9, 0.98], eps=1e-9, weight_decay=1e-4, grad_clip_norm=0.5,
                      lr_min_factor=0.1)
    rng = np.random.default_rng(3)
    shapes = {"a": (5, 4), "b": (7,), "c": (3, 2, 2)}
    params = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: (rng.normal(size=s) * (3.0 if i % 2 else 0.05)).astype(np.float32) for k, s in shapes.items()}
             for i in range(7)]
    tx = make_optimizer(dict(opt_kwargs), total_steps=4)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    state = tx.init(jp)
    tp = [t(params[k]) for k in shapes]
    opt = Amsgrad.from_config(tp, opt_kwargs, total_steps=4)
    assert opt.count.dtype == torch.int64 and opt.count.shape == () and opt.count.device == tp[0].device
    for g in grads:
        upd, state = tx.update({k: jnp.asarray(v) for k, v in g.items()}, state, jp)
        jp = optax.apply_updates(jp, upd)
        opt.step([t(g[k]) for k in shapes])
        for k, p in zip(shapes, tp):
            np.testing.assert_allclose(npy(p), np.asarray(jp[k]), rtol=EXACT, atol=EXACT * np.abs(params[k]).max())
    assert int(opt.count) == 7
    assert float(opt.lr_at(opt.count)) == pytest.approx(1e-4, rel=1e-12)
    assert float(opt.lr_at(torch.tensor(2))) == pytest.approx(1e-3 * (0.9 * 0.5 * (1 + np.cos(np.pi / 2)) + 0.1))
