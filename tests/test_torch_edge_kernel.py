"""The fused edge segment: the port's plain core against the JAX package's
``edge_core_reference`` and its Pallas kernel (interpret mode), and the
port's ``GraphAttention`` (both ``edge_impl`` values) against the flax module
on shared parameters, at tiny width to 2e-5.  The CUDA kernel itself is
compared with the plain core in ``test_torch_cuda.py``, on a machine with a
GPU."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffusion_edf_tpu.geom.irreps import Irreps
from diffusion_edf_tpu.geom.sh import spherical_harmonics
from diffusion_edf_tpu.nn import edge_kernel as jek
from diffusion_edf_tpu.nn.attention import GraphAttention as JGA
from diffusion_edf_tpu_torch.nn import edge_kernel as tek
from diffusion_edf_tpu_torch.nn.attention import GraphAttention as TGA
from diffusion_edf_tpu_torch.nn.tp import im_perm
from diffusion_edf_tpu_torch.weights import init_params

from .test_torch_tables import t, torch_to_jax_params

torch.set_num_threads(1)
SH = "1x0e+1x1e+1x2e"
TINY = "8x0e+4x1e+2x2e"


def _ga_inputs(irreps, Nd=12, K=8, S=8, seed=0):
    """Seeded attention inputs; the message is i-major, as the port takes it."""
    rng = np.random.default_rng(seed)
    message = rng.normal(size=(Nd, K, Irreps(irreps).dim)).astype(np.float32)[..., list(im_perm(Irreps(irreps)))]
    attr = np.asarray(spherical_harmonics(SH, jnp.asarray(rng.normal(size=(Nd, K, 3)).astype(np.float32))))
    scalars = rng.normal(size=(Nd, K, S)).astype(np.float32)
    mask = rng.uniform(size=(Nd, K)) < 0.8
    mask[:, 0] = True
    mask[-1] = False  # one all-masked row: the softmax floor of 0.5 engages
    pre = -rng.uniform(size=(Nd, K)).astype(np.float32)
    post = rng.uniform(size=(Nd, K)).astype(np.float32)
    return message, attr, scalars, mask, pre, post


def _ga_pair(irreps, heads, component_major, seed=0):
    """A seeded port GraphAttention and the flax module reading the message
    i-major (``component_major``) or canonical, with the same params."""
    m = TGA(irreps, SH, irreps, fc_neurons=(8, 16), num_heads=heads)
    init_params(m, torch.Generator().manual_seed(seed))
    ref = JGA(irreps_input=Irreps(irreps), irreps_edge_attr=Irreps(SH), irreps_output=Irreps(irreps),
              fc_neurons=(8, 16), num_heads=heads, alpha_drop=0.0, message_component_major=component_major)
    return m, ref, torch_to_jax_params(m)


def _edge_case(irreps, heads, rows, seed=0):
    """A torch GraphAttention's folded weights and seeded edge inputs."""
    m, _, _ = _ga_pair(irreps, heads, True, seed)
    rng = np.random.default_rng(seed + 1)
    x1 = rng.normal(size=(rows, Irreps(irreps).dim)).astype(np.float32)
    attr = np.asarray(spherical_harmonics(SH, jnp.asarray(rng.normal(size=(rows, 3)).astype(np.float32))))
    es = rng.normal(size=(rows, 8)).astype(np.float32)
    return m, x1, attr, es


@pytest.mark.parametrize("rows", [37, 256])
def test_plain_core_matches_jax_reference_and_pallas(rows):
    m, x1, attr, es = _edge_case(TINY, 2, rows)
    (W_av, b_av, Dmat, W2, b2), (spec, arrays) = m._kernel_weights()
    logits, val = tek.edge_core_plain(m.plan, t(x1), t(attr), t(es), (W_av, b_av, Dmat, W2, b2), (spec, arrays))
    # JAX side: the same plan, weight folding and packed radial MLP from numpy
    W_can, b_can = (a.detach().numpy() for a in m.sep_alpha_value.materialize())
    w_tp2, W_lin2, b_lin2 = (a.detach().numpy() for a in m.sep_value.materialize())
    jplan = jek.build_edge_plan(m.plan.prog1, m.plan.prog2, m.irreps_mid, m.H, m.mul_alpha, m.irreps_attn)
    jweights = jek.prepare_weights(jplan, jnp.asarray(W_can), jnp.asarray(b_can), jnp.asarray(Dmat.detach().numpy()),
                                   jnp.asarray(w_tp2), jnp.asarray(W_lin2), jnp.asarray(b_lin2))
    for a, b in zip(jweights, (W_av, b_av, Dmat, W2, b2)):
        np.testing.assert_allclose(np.asarray(a), b.detach().numpy(), atol=1e-6)
    jrad = (spec, [jnp.asarray(a.detach().numpy()) for a in arrays])
    for kw in (dict(mode="xla"), dict(mode="pallas", interpret=True)):
        jl, jv = jek.edge_kernel_call(jplan, jnp.asarray(x1), jnp.asarray(attr), jnp.asarray(es), jweights,
                                      rad=jrad, **kw)
        np.testing.assert_allclose(np.asarray(jl), logits.detach().numpy(), atol=2e-5)
        np.testing.assert_allclose(np.asarray(jv), val.detach().numpy(), atol=2e-5)
    # on CPU tensors the wrapper takes the plain version and counts no launch
    before = tek.launches
    l2, v2 = tek.edge_kernel(m.plan, t(x1), t(attr), t(es), (W_av, b_av, Dmat, W2, b2), (spec, arrays))
    assert tek.launches == before
    torch.testing.assert_close(l2, logits, rtol=0, atol=0)
    torch.testing.assert_close(v2, val, rtol=0, atol=0)


@pytest.mark.parametrize("edge_impl", ["plain", "kernel"])
@pytest.mark.parametrize("component_major", [False, True])
def test_graph_attention_matches_flax(edge_impl, component_major):
    m, ref, params = _ga_pair(TINY, 2, component_major)
    m.edge_impl = edge_impl
    msg, attr, sc, mask, pre, post = _ga_inputs(TINY)
    msg_j = msg if component_major else msg[..., np.argsort(im_perm(Irreps(TINY)))]
    out_j = ref.apply(params, *map(jnp.asarray, (msg_j, attr, sc, mask)), edge_pre_attn_logit=jnp.asarray(pre),
                      edge_post_attn=jnp.asarray(post))
    with torch.no_grad():
        out_t = m(t(msg), t(attr), t(sc), torch.as_tensor(mask), edge_pre_attn_logit=t(pre), edge_post_attn=t(post))
    np.testing.assert_allclose(np.asarray(out_j), out_t.numpy(), atol=2e-5)


def test_masked_softmax_floor():
    """An all-masked row gets alpha = 0 (denominator floored at 0.5, not an
    eps), so its attention output is the projection of zeros."""
    m, _, _ = _ga_pair(TINY, 2, True)
    msg, attr, sc, mask, pre, post = _ga_inputs(TINY)
    with torch.no_grad():
        out = m(t(msg), t(attr), t(sc), torch.as_tensor(mask), edge_pre_attn_logit=t(pre))
        zero = m.proj(torch.zeros(1, m.irreps_attn.dim))
    assert torch.isfinite(out).all()
    torch.testing.assert_close(out[-1:], zero)
