"""The fused attention core: the port's ``GraphAttention`` on
``edge_impl="fused"`` (on the CPU the kernel's plain version) against the flax
module on ``fused_core="pallas_interpret"`` (the Pallas kernel in interpret
mode) and ``fused_core="xla"`` on shared parameters, and against the port's
own ``"plain"`` path.  Tiny width to 2e-5, the tolerance of the JAX package's
fused-attention tests: the implementations sum over the K slots in different
orders.  The CUDA kernel itself is compared with the plain version in
``test_torch_cuda.py``, on a machine with a GPU."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffusion_edf_tpu.geom.irreps import Irreps
from diffusion_edf_tpu.nn.attention import GraphAttention as JGA
from diffusion_edf_tpu_torch.nn import fused_attention as tfa
from diffusion_edf_tpu_torch.nn.attention import GraphAttention as TGA
from diffusion_edf_tpu_torch.nn.attention import _head_of_col
from diffusion_edf_tpu_torch.weights import init_params

from .test_torch_edge_kernel import SH, TINY, _ga_inputs
from .test_torch_tables import t, torch_to_jax_params

torch.set_num_threads(1)
FLAGSHIP = "64x0e+32x1e+16x2e"


def _outputs(irreps, heads, fc, K, use_pre, use_post, Nd=12, modes=("pallas_interpret", "xla")):
    """Port outputs for "fused" and "plain" and the flax outputs for ``modes``,
    on the same seeded inputs (one row has every slot masked)."""
    m = TGA(irreps, SH, irreps, fc_neurons=fc, num_heads=heads)
    init_params(m, torch.Generator().manual_seed(0))
    params = torch_to_jax_params(m)
    msg, attr, sc, mask, pre, post = _ga_inputs(irreps, Nd=Nd, K=K, S=fc[0])
    assert not mask[-1].any() and mask[:-1].any(axis=1).all()
    kw_t = dict(edge_pre_attn_logit=t(pre) if use_pre else None, edge_post_attn=t(post) if use_post else None)
    kw_j = dict(edge_pre_attn_logit=jnp.asarray(pre) if use_pre else None,
                edge_post_attn=jnp.asarray(post) if use_post else None)
    out = {}
    with torch.no_grad():
        for impl in ("fused", "plain"):
            m.edge_impl = impl
            out[impl] = m(t(msg), t(attr), t(sc), torch.as_tensor(mask), **kw_t).numpy()
        out["zero_row"] = m.proj(torch.zeros(1, m.irreps_attn.dim)).numpy()
    for mode in modes:
        ref = JGA(irreps_input=Irreps(irreps), irreps_edge_attr=Irreps(SH), irreps_output=Irreps(irreps),
                  fc_neurons=fc, num_heads=heads, alpha_drop=0.0, message_component_major=True, fused_core=mode)
        out[mode] = np.asarray(ref.apply(params, *map(jnp.asarray, (msg, attr, sc, mask)), **kw_j))
    return out


@pytest.mark.parametrize("K,use_pre,use_post", [(8, True, True), (8, False, False), (11, True, False), (11, False, True)])
def test_fused_matches_flax_fused_cores(K, use_pre, use_post):
    """K = 11 is no multiple of the Pallas kernel's 8-row blocks nor of the
    CUDA kernel's 64-slot tiles."""
    out = _outputs(TINY, 2, (8, 16), K, use_pre, use_post)
    for mode in ("pallas_interpret", "xla", "plain"):
        np.testing.assert_allclose(out["fused"], out[mode], atol=2e-5, err_msg=mode)
    # the all-masked row: alpha = 0, so the output is the projection of zeros
    assert np.isfinite(out["fused"]).all()
    np.testing.assert_allclose(out["fused"][-1:], out["zero_row"], atol=1e-6)


def test_fused_wrapper_on_cpu_is_the_plain_version():
    """On CPU tensors the wrapper runs the plain version and counts no launch."""
    m = init_params(TGA(TINY, SH, TINY, fc_neurons=(8, 16), num_heads=2), torch.Generator().manual_seed(1))
    msg, attr, sc, mask, pre, post = _ga_inputs(TINY, K=5)
    weights, rad = m._kernel_weights()
    hoc = _head_of_col(m.irreps_head, m.H, m.irreps_attn.dim)
    assert len(hoc) == m.irreps_attn.dim and set(hoc) == {0, 1}
    args = (m.plan, hoc, t(msg), t(attr), t(sc), torch.as_tensor(mask), t(pre), t(post), weights, rad)
    before = tfa.launches
    with torch.no_grad():
        a = tfa.fused_attention(*args)
        b = tfa.fused_attention_plain(*args)
    assert tfa.launches == before
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert a.shape == (12, m.irreps_attn.dim)


@pytest.mark.slow
def test_fused_matches_flax_at_reference_width():
    """The flagship's tensor-field width: 3e-4, the JAX package's
    reference-width tolerance."""
    out = _outputs(FLAGSHIP, 4, (128, 128, 64), 20, True, True, Nd=6, modes=("xla",))
    np.testing.assert_allclose(out["fused"], out["xla"], atol=3e-4)
    np.testing.assert_allclose(out["fused"], out["plain"], atol=3e-4)
