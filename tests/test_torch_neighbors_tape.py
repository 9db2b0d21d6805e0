"""The port's degree tape, ``radius_graph`` and ``native.radius_count``
against the JAX package's, on the CPU at tiny sizes.

The tape of one whole model pass (extractor, query model, one score) is
recorded in both packages on the same weights and clouds; the JAX pass is
traced under ``jax.jit`` and returns its records' arrays, as the JAX tool
does (eagerly it takes a minute here), and the port's records hold concrete
tensors.  The call sites' tags
come in the same order and every summary field is equal: the counts are
integers, the in-radius test is exact away from the radius, and the seeded
clouds put no point on it."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import diffusion_edf_tpu.native as jax_native
from diffusion_edf_tpu.models.data import FeaturedPoints as JFP
from diffusion_edf_tpu.ops import neighbors as jnb
from diffusion_edf_tpu.train.factory import build_score_model as j_build
from diffusion_edf_tpu_torch import native
from diffusion_edf_tpu_torch.data import FeaturedPoints as TFP
from diffusion_edf_tpu_torch.ops import neighbors as tnb
from diffusion_edf_tpu_torch.train.factory import build_score_model as t_build
from diffusion_edf_tpu_torch.weights import init_params

from .test_torch_native import _jax_native_loaded
from .test_torch_tables import one_request, torch_to_jax_params
from .test_torch_train import _model_cfg

torch.set_num_threads(1)
SUMMARY_KEYS = ("tag", "r", "k", "n_dst", "max_degree", "frac_truncated")


def _dense_scene(n=96, n_valid=80, n_poses=3, seed=0):
    """A cloud dense enough that the tiny model's caps clip some
    neighbourhoods, and poses that put the query points in it."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(-4, 4, (n, 3)).astype(np.float32)
    f = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    mask = np.arange(n) < n_valid
    x[~mask] = 1e6
    # near-identity rotations that bring the tiny model's keypoints (z = 10.5) into the cloud
    q = np.array([1.0, 0, 0, 0]) + rng.normal(0, 0.05, (n_poses, 4))
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    Ts = np.concatenate([q, rng.uniform(-1, 1, (n_poses, 3)) - [0, 0, 10.5]], -1).astype(np.float32)
    return x, f, mask, Ts, np.linspace(0.1, 0.9, n_poses).astype(np.float32)


def test_model_degree_tape_matches_jax():
    cfg = _model_cfg()
    tmodel = init_params(t_build(cfg["model_name"], cfg["model_kwargs"]), torch.Generator().manual_seed(3))
    jmodel, params = j_build(cfg["model_name"], cfg["model_kwargs"]), torch_to_jax_params(tmodel)
    x, f, mask, Ts, time = _dense_scene()
    with jnb.record_degree_tape() as jtape:
        def fn(p, s, T, tt):
            km = jmodel.apply(p, s, method=jmodel.get_key_pcd_multiscale)
            q = jmodel.apply(p, s, method=jmodel.get_query_pcd)
            jmodel.apply(p, T, km, q, tt, method=jmodel.score)
            return ([r.degree for r in jtape],
                    [jnp.ones_like(r.degree, bool) if r.dst_mask is None else r.dst_mask for r in jtape])

        js = JFP(x=jnp.asarray(x), f=jnp.asarray(f), mask=jnp.asarray(mask))
        degrees, masks = jax.jit(fn)(params, js, jnp.asarray(Ts), jnp.asarray(time))
    jsum = jnb.summarize_degree_tape(jtape, degrees, masks)
    with tnb.record_degree_tape() as ttape, torch.no_grad():
        ts = TFP(x=torch.as_tensor(x), f=torch.as_tensor(f), mask=torch.as_tensor(mask))
        km, q = tmodel.get_key_pcd_multiscale(ts), tmodel.get_query_pcd(ts)
        tmodel.score(*one_request(Ts, km, q, time))
    tsum = tnb.summarize_degree_tape(ttape)
    assert [s["tag"] for s in tsum] == [s["tag"] for s in jsum]
    assert {s["tag"].split("/")[0] for s in tsum} == {"extractor", "radius_edge"}
    for a, b in zip(tsum, jsum):
        assert {k: a[k] for k in SUMMARY_KEYS} == {k: b[k] for k in SUMMARY_KEYS}
        np.testing.assert_allclose(a["mean_degree"], b["mean_degree"], rtol=1e-12)
    assert any(s["frac_truncated"] > 0 for s in tsum) and any(s["frac_truncated"] == 0 for s in tsum)
    assert tsum[-1]["tag"] == "radius_edge/parser_0" and tsum[-1]["max_degree"] > 0
    # outside the block nothing is recorded, and an empty tape summarises to nothing
    with torch.no_grad():
        tmodel.get_key_pcd_multiscale(ts)
    assert len(ttape) == len(tsum) and tnb.summarize_degree_tape([]) == []


def test_record_of_one_search_matches_jax_with_a_destination_mask():
    rng = np.random.default_rng(1)
    src, dst = rng.uniform(-2, 2, (60, 3)).astype(np.float32), rng.uniform(-2, 2, (25, 3)).astype(np.float32)
    src_mask, dst_mask = rng.uniform(size=60) < 0.8, rng.uniform(size=25) < 0.7
    with jnb.record_degree_tape() as jtape:
        jnb.radius_neighbors(jnp.asarray(src), jnp.asarray(dst), 1.5, 4, src_mask=jnp.asarray(src_mask),
                             dst_mask=jnp.asarray(dst_mask), tag="unit")
    with tnb.record_degree_tape() as ttape:
        tnb.radius_neighbors(torch.as_tensor(src), torch.as_tensor(dst), 1.5, 4, src_mask=torch.as_tensor(src_mask),
                             dst_mask=torch.as_tensor(dst_mask), tag="unit")
    np.testing.assert_array_equal(ttape[0].degree.numpy(), np.asarray(jtape[0].degree))
    (a,), (b,) = tnb.summarize_degree_tape(ttape), jnb.summarize_degree_tape(jtape, [jtape[0].degree])
    assert a == b and a["n_dst"] == int(dst_mask.sum()) and 0 < a["frac_truncated"] < 1


@pytest.mark.parametrize("with_mask", [False, True])
def test_radius_graph_matches_jax(with_mask):
    rng = np.random.default_rng(2)
    x = rng.uniform(-3, 3, (70, 3)).astype(np.float32)
    mask = rng.uniform(size=70) < 0.75 if with_mask else None
    jidx, jvalid = jnb.radius_graph(jnp.asarray(x), 2.0, 6, mask=None if mask is None else jnp.asarray(mask))
    tidx, tvalid = tnb.radius_graph(torch.as_tensor(x), 2.0, 6, mask=None if mask is None else torch.as_tensor(mask))
    jidx, jvalid, tidx, tvalid = np.asarray(jidx), np.asarray(jvalid), tidx.numpy(), tvalid.numpy()
    np.testing.assert_array_equal(tvalid.sum(-1), jvalid.sum(-1))
    for i in range(70):  # neighbourhoods as sets: tied slots may come in another order
        assert set(tidx[i][tvalid[i]]) == set(jidx[i][jvalid[i]])
        assert i not in set(tidx[i][tvalid[i]])  # no self-loop
    assert tvalid.any() and (~tvalid).any()


def test_native_radius_count_matches_jax(monkeypatch):
    assert _jax_native_loaded(monkeypatch), "the JAX package's native library did not build or load"
    rng = np.random.default_rng(3)
    src = rng.uniform(-1, 1, (3000, 3)).astype(np.float32)
    dst = rng.uniform(-1.2, 1.2, (500, 3)).astype(np.float32)
    out, ref = native.radius_count(src, dst, 0.25), jax_native.radius_count(src, dst, 0.25)
    assert out is not None and out.dtype == np.int32
    np.testing.assert_array_equal(out, ref)
    brute = (((dst[:, None] - src[None]) ** 2).sum(-1) <= 0.25 ** 2).sum(-1)
    np.testing.assert_array_equal(out, brute)
    assert out.max() > 10 and out.min() == 0
