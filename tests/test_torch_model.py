"""A tiny MultiscaleScoreModel (the tiny configuration of
``__graft_entry__.py``) in the port and in the JAX package on the same
parameters: key clouds, query cloud and score agree to 1e-4.  The slow case
runs the shipped full-width pick_lowres checkpoint."""
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as ge
from diffusion_edf_tpu.models.data import FeaturedPoints as JFP
from diffusion_edf_tpu.train.factory import build_score_model as j_build
from diffusion_edf_tpu_torch.data import FeaturedPoints as TFP
from diffusion_edf_tpu_torch.train.factory import build_score_model as t_build
from diffusion_edf_tpu_torch.weights import init_params, load_params_npz

from .test_torch_tables import one_request, t, torch_to_jax_params

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parents[1]
ATOL = 1e-4


def _inputs(n_scene, n_valid, n_poses, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-20, 20, size=(n_scene, 3)).astype(np.float32)
    f = rng.uniform(0, 1, size=(n_scene, 3)).astype(np.float32)
    mask = np.arange(n_scene) < n_valid
    x[~mask] = 1e6
    q = rng.normal(size=(n_poses, 4))
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    Ts = np.concatenate([q, rng.uniform(-10, 10, size=(n_poses, 3))], -1).astype(np.float32)
    time = np.linspace(0.05, 0.9, n_poses).astype(np.float32)
    return x, f, mask, Ts, time


def _compare(tmodel, jmodel, params, x, f, mask, Ts, time, atol):
    jscene = JFP(x=jnp.asarray(x), f=jnp.asarray(f), mask=jnp.asarray(mask))
    tscene = TFP(x=t(x), f=t(f), mask=torch.as_tensor(mask))
    jkm = jax.jit(lambda p, s: jmodel.apply(p, s, method=jmodel.get_key_pcd_multiscale))(params, jscene)
    jq = jax.jit(lambda p, s: jmodel.apply(p, s, method=jmodel.get_query_pcd))(params, jscene)
    with torch.no_grad():
        tkm = tmodel.get_key_pcd_multiscale(tscene)
        tq = tmodel.get_query_pcd(tscene)
        tang, tlin = (s[0] for s in tmodel.score(*one_request(Ts, tkm, tq, time)))
    assert len(jkm) == len(tkm)
    for a, b in zip(jkm, tkm):
        np.testing.assert_array_equal(np.asarray(a.mask), b.mask.numpy())
        np.testing.assert_allclose(np.asarray(a.x), b.x.numpy(), atol=atol)
        np.testing.assert_allclose(np.asarray(a.f), b.f.numpy(), atol=atol)
    for name in ("x", "f", "w"):
        np.testing.assert_allclose(np.asarray(getattr(jq, name)), getattr(tq, name).detach().numpy(), atol=atol)
    jang, jlin = jax.jit(lambda p, T, km, q, tt: jmodel.apply(p, T, km, q, tt, method=jmodel.score))(
        params, jnp.asarray(Ts), jkm, jq, jnp.asarray(time))
    np.testing.assert_allclose(np.asarray(jang), tang.numpy(), atol=atol)
    np.testing.assert_allclose(np.asarray(jlin), tlin.numpy(), atol=atol)


@pytest.mark.parametrize("n_valid", [64, 50])
def test_tiny_model_matches_jax(n_valid):
    cfg = ge._model_config(tiny=True)
    tmodel = init_params(t_build(cfg["model_name"], cfg["model_kwargs"]), torch.Generator().manual_seed(1))
    jmodel = j_build(cfg["model_name"], cfg["model_kwargs"])
    _compare(tmodel, jmodel, torch_to_jax_params(tmodel), *_inputs(64, n_valid, 3), atol=ATOL)


@pytest.mark.slow
def test_full_width_checkpoint_score_matches_jax():
    """Shipped pick_lowres checkpoint at full width: 3e-4."""
    from diffusion_edf_tpu.train.trainer import load_configs

    _, _, cfg = load_configs(str(ROOT / "diffusion_edf_tpu" / "configs" / "panda_mug" / "pick_lowres"))
    tmodel = load_params_npz(t_build(cfg["model_name"], cfg["model_kwargs"]),
                             str(ROOT / "checkpoints" / "panda_mug" / "pick_lowres.npz"))
    jmodel = j_build(cfg["model_name"], cfg["model_kwargs"])
    for seed in (0, 1):
        _compare(tmodel, jmodel, torch_to_jax_params(tmodel), *_inputs(256, 240, 4, seed=seed), atol=3e-4)
