"""The port's data-parallel train step (``parallel/sharded.py::
make_sharded_train_step``) on two gloo ranks on the CPU, at tiny widths,
dropout off, for the score model and the EBM critic: on the first draw,
which every rank makes alike, the loss and its statistics equal one
process's (2e-6 relative) and the summed gradient is one process's (1e-5 of
each flax key's max |grad|; float32 sums in another order), and both are
held to the JAX trainer's ``jax.value_and_grad`` at the tolerances of
``tests/test_torch_train_step.py``.  Then one whole step on the same draw:
its loss and the gradients it hands the update are one process's at the
same tolerances, the parameters and EMA after it equal one process's
update (``apply_grads``) of those gradients, and both ranks hold the same
parameters.  Each step goes through the trainer's runtime (one program a
demo shape, which the card captures); the critic case also runs two
data-parallel epochs through the runtime and eagerly (``use_runtime=False``)
from the same state, equal bit for bit.

With dropout on (the score model), every rank draws every mask from the
trainer's generator, the per-pose rows' masks at the whole batch's shape,
so the step is one process's step with the same generator seed: the same
gates, and the runtime's epochs against eager ones bit for bit."""
import numpy as np
import pytest
import torch

from diffusion_edf_tpu_torch.weights import flat_arrays

from . import torch_ranks
from .test_torch_train import _demos, _trainer
from .test_torch_train_step import TOLERANCES, _jax_value_and_grad

torch.set_num_threads(1)


@pytest.mark.parametrize("ebm, drop", [(False, 0.0), (True, 0.0), (False, 0.1)],
                         ids=["score_model", "ebm_critic", "score_model_dropout"])
def test_data_parallel_step(tmp_path, ebm, drop):
    tr = _trainer(tmp_path, ebm=ebm, drop=drop)
    tr.init(_demos(1))
    inputs = tr.draw_step(tr.batches[0])
    tr.model.train()
    loss, stats, grads = tr.loss_and_grads(inputs)
    epochs = 2 if ebm or drop else 0
    outs = torch_ranks.spawn("train", 2, tmp_path, cfg_dir=tr.configs_root_dir, demos=_demos(1), epochs=epochs)
    one = flat_arrays(tr.model, grads)
    for o in outs:
        for k in ("Ts", "times", "tgt_ang", "tgt_lin") + (("Ts_rank",) if ebm else ()):
            np.testing.assert_array_equal(getattr(o["inputs"], k).numpy(), getattr(inputs, k).numpy(), err_msg=k)
        np.testing.assert_allclose(o["loss"], float(loss.detach()), rtol=2e-6)
        for k, v in stats.items():
            np.testing.assert_allclose(o["stats"][k], float(v.detach()), rtol=2e-6, atol=1e-7, err_msg=k)
        for k, g in one.items():
            assert np.abs(o["grads"][k] - g).max() <= 1e-5 * np.abs(g).max() + 1e-12, k
    for o in outs:  # the step itself
        np.testing.assert_allclose(o["step_stats"]["loss/train"], float(loss.detach()), rtol=2e-6)
        for k, g in flat_arrays(tr.model, o["step_grads"]).items():
            assert np.abs(g - one[k]).max() <= 1e-5 * np.abs(one[k]).max() + 1e-12, k
    for k, p in outs[0]["params"].items():
        np.testing.assert_array_equal(outs[1]["params"][k], p, err_msg=k)
    for o in outs if epochs else ():  # the runtime's epochs against eager epochs from the same state
        run, ref = o["epochs_runtime"], o["epochs_eager"]
        assert run["stats"] == ref["stats"] and run["count"] == ref["count"] == epochs
        assert run["entries"] == 1 and ref["entries"] == 0
        for name in ("params", "ema"):
            for k, v in ref[name].items():
                np.testing.assert_array_equal(run[name][k], v, err_msg=f"{name} {k}")
        for name, tensors in ref["opt"].items():
            for a, b in zip(run["opt"][name], tensors, strict=True):
                np.testing.assert_array_equal(a.numpy(), b.numpy(), err_msg=name)
    if drop:  # the JAX step draws other masks
        return

    loss_rtol, grad_tol = TOLERANCES[ebm]
    jloss, _, jgrads = _jax_value_and_grad(tr, inputs, ebm)
    np.testing.assert_allclose(outs[0]["loss"], jloss, rtol=loss_rtol)
    for k, g in jgrads.items():
        assert np.abs(outs[0]["grads"][k] - g).max() <= grad_tol * np.abs(g).max() + 1e-12, k
    tr.apply_grads(outs[0]["step_grads"])  # after the JAX comparison, which reads the parameters
    for name, mine in (("params", flat_arrays(tr.model)), ("ema", flat_arrays(tr.model, tr.ema))):
        for k, v in mine.items():
            np.testing.assert_allclose(outs[0][name][k], v, rtol=1e-6, atol=1e-9, err_msg=f"{name} {k}")
