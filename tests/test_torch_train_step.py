"""One whole train step of the port against the JAX trainer's ``loss_fn``
(``train/trainer.py:304-341``) under ``jax.value_and_grad``, at tiny widths
on the CPU, on the same diffused poses, times and targets (drawn by the
port's trainer) and the same weights, dropout off:

* the score model: the loss and its statistics within 2e-5 relative, the
  gradient of every flax key within 1e-4 of that key's max |grad|;
* the EBM critic, whose score is the gradient of its energy (``ebm_score``)
  and whose loss adds the ranking loss of its energies: the gradient is
  second order, and both packages' float32 gradients sit up to 4e-4 (the
  port) and 2e-4 (JAX) of a key's max |grad| from the port run in float64
  on this draw, the losses 3.9e-5 and 1.8e-5 relative; so the loss is held
  to 1e-4 relative and each gradient to 1e-3 (measured worst: 2.1e-5 and
  2.7e-4, printed by the test).

The JAX gradient is jitted: it compiles in about 30 s (60 s for the
critic), where running it eagerly takes several times as long."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffusion_edf_tpu.models.score_model import train_loss as j_train_loss
from diffusion_edf_tpu.train import ranking as jrank
from diffusion_edf_tpu.train.factory import build_score_model as j_build
from diffusion_edf_tpu_torch.nn.attention import GraphAttention
from diffusion_edf_tpu_torch.weights import flat_arrays

from .test_torch_tables import torch_to_jax_params
from .test_torch_train import _demos, _jfp, _trainer
from .test_torch_train_geom import npy

torch.set_num_threads(1)
TOLERANCES = {False: (2e-5, 1e-4), True: (1e-4, 1e-3)}  # ebm -> (loss relative, gradient of its key's max)


def _jax_value_and_grad(tr, inputs, ebm):
    """``jax.value_and_grad`` of the JAX trainer's ``loss_fn``
    (``train/trainer.py:304-341``) on the port's drawn inputs and weights."""
    cfg = tr.model_cfg
    jmodel = j_build(cfg["model_name"], cfg["model_kwargs"])
    params = torch_to_jax_params(tr.model)
    scene, grasp = _jfp(inputs.scene), _jfp(inputs.grasp)
    Ts, times, tgt_ang, tgt_lin = (jnp.asarray(npy(x)) for x in (inputs.Ts, inputs.times, inputs.tgt_ang, inputs.tgt_lin))
    rngs = {"dropout": jax.random.PRNGKey(0)}
    if not ebm:
        def loss_fn(p):
            ang, lin = jmodel.apply(p, Ts, scene, grasp, times, deterministic=False, rngs=rngs)
            return j_train_loss(ang, lin, tgt_ang, tgt_lin, times, tr.ang_mult, tr.lin_mult)
    else:
        Ts_rank, badness = jnp.asarray(npy(inputs.Ts_rank)), jnp.asarray(npy(inputs.badness))
        rank_cfg = jrank.RankConfig(*tr.rank_cfg)

        def fwd(m, Ts, scene, grasp, times, Ts_rank):
            key_ms = m.get_key_pcd_multiscale(scene, deterministic=False)
            query = m.get_query_pcd(grasp, deterministic=False)
            ang, lin = m.score(Ts, key_ms, query, times, deterministic=False)
            E = m.energy(Ts_rank, key_ms, query, jnp.ones((Ts_rank.shape[0],), Ts_rank.dtype), deterministic=False)
            return ang, lin, E

        def loss_fn(p):
            ang, lin, E = jmodel.apply(p, Ts, scene, grasp, times, Ts_rank, method=fwd, rngs=rngs)
            loss, stats = j_train_loss(ang, lin, tgt_ang, tgt_lin, times, tr.ang_mult, tr.lin_mult)
            rloss, racc = jrank.rank_loss(E, badness, rank_cfg)
            loss = loss + rank_cfg.weight * rloss
            stats.update({"loss/train": loss, "rank/loss": rloss, "rank/pair_acc": racc, "rank/e_target": E[0],
                          "rank/e_spread": E.max() - E.min()})
            return loss, stats

    (loss, stats), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params)
    flat = {}

    def walk(node, prefix):
        for k, v in node.items():
            walk(v, f"{prefix}/{k}") if isinstance(v, dict) else flat.__setitem__(f"{prefix}/{k}"[1:], np.asarray(v))

    walk(grads, "")
    return float(loss), {k: float(v) for k, v in stats.items()}, flat


@pytest.mark.parametrize("ebm", [False, True], ids=["score_model", "ebm_critic"])
def test_one_step_matches_jax_value_and_grad(tmp_path, ebm):
    """The loss, its statistics and the gradient of every flax key, at the
    tolerances of the module docstring; the step's pair accuracy and the
    worst errors are printed."""
    loss_rtol, grad_tol = TOLERANCES[ebm]
    tr = _trainer(tmp_path, ebm=ebm)
    tr.init(_demos(1))
    inputs = tr.draw_step(tr.batches[0])
    tr.model.train()
    # rows whose slots are all masked (padded points, queries out of a scale's radius) reach the
    # attentions: the softmax floor and the other double-backward guards keep the gradients finite
    masked_rows = []
    hooks = [m.register_forward_pre_hook(lambda m, a: masked_rows.append(int((~a[3]).all(-1).sum())))
             for m in tr.model.modules() if isinstance(m, GraphAttention)]
    try:
        loss, stats, grads = tr.loss_and_grads(inputs)
    finally:
        for h in hooks:
            h.remove()
    assert sum(masked_rows) > 0
    assert np.isfinite(float(loss.detach())) and all(bool(torch.isfinite(g).all()) for g in grads)
    jloss, jstats, jgrads = _jax_value_and_grad(tr, inputs, ebm)
    assert set(stats) == set(jstats)
    np.testing.assert_allclose(float(loss.detach()), jloss, rtol=loss_rtol)
    for k in stats:
        np.testing.assert_allclose(float(stats[k].detach()), jstats[k], rtol=loss_rtol, atol=1e-6, err_msg=k)
    tgrads = flat_arrays(tr.model, grads)
    assert set(tgrads) == set(jgrads)
    worst = 0.0
    for k, g in jgrads.items():
        scale = float(np.abs(g).max())
        err = float(np.abs(tgrads[k] - g).max())
        assert np.all(np.isfinite(tgrads[k])), k
        worst = max(worst, err / scale if scale > 0 else err)
        assert err <= grad_tol * scale + 1e-12, (k, err, scale)
    print(f"{'critic' if ebm else 'score model'}: loss {float(loss.detach()):.7g} vs {jloss:.7g} "
          f"({abs(float(loss.detach()) - jloss) / abs(jloss):.2g} relative); worst gradient error {worst:.3g} of its key's "
          f"max |grad|{'; rank/pair_acc %.3f' % stats['rank/pair_acc'] if ebm else ''}")


