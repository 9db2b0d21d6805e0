"""The fused edge segment: the port's plain core against the JAX package's
``edge_core_reference`` and its Pallas kernel (interpret mode), with and
without a mask of the rows to compute, and the port's ``GraphAttention``
(both ``edge_impl`` values) against the flax module on shared parameters, at
tiny width to 2e-5; the plain core's mixed bfloat16 mode against the JAX
package's transposed kernel on a bfloat16 message.  The CUDA kernel itself
is compared with the plain core in ``test_torch_cuda.py``, on a machine with
a GPU."""
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


def _jax_operands(m, weights, rad):
    """The JAX side of a port GraphAttention's folded operands: the same
    plan, weight folding and packed radial MLP, from numpy."""
    W_can, b_can = (a.detach().numpy() for a in m.sep_alpha_value.materialize())
    w_tp2, W_lin2, b_lin2 = (a.detach().numpy() for a in m.sep_value.materialize())
    jplan = jek.build_edge_plan(m.plan.prog1, m.plan.prog2, m.irreps_mid, m.H, m.mul_alpha, m.irreps_attn)
    jweights = jek.prepare_weights(jplan, jnp.asarray(W_can), jnp.asarray(b_can), jnp.asarray(weights[2].detach().numpy()),
                                   jnp.asarray(w_tp2), jnp.asarray(W_lin2), jnp.asarray(b_lin2))
    spec, arrays = rad
    return jplan, jweights, (spec, [jnp.asarray(a.detach().numpy()) for a in arrays])


@pytest.mark.parametrize("rows", [37, 256])
def test_plain_core_matches_jax_reference_and_pallas(rows):
    m, x1, attr, es = _edge_case(TINY, 2, rows)
    (W_av, b_av, Dmat, W2, b2), (spec, arrays) = m._kernel_weights()
    logits, val = tek.edge_core_plain(m.plan, t(x1), t(attr), t(es), (W_av, b_av, Dmat, W2, b2), (spec, arrays))
    jplan, jweights, jrad = _jax_operands(m, (W_av, b_av, Dmat, W2, b2), (spec, arrays))
    for a, b in zip(jweights, (W_av, b_av, Dmat, W2, b2)):
        np.testing.assert_allclose(np.asarray(a), b.detach().numpy(), atol=1e-6)
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


def _row_mask(pattern, rows, group=8, seed=2):
    """A (rows,) mask of the rows to compute; ``one_a_group``: one row kept in
    every group of ``group`` consecutive rows (one slot a destination row)."""
    if pattern == "none_masked":
        return np.ones(rows, bool)
    if pattern == "all_masked":
        return np.zeros(rows, bool)
    if pattern == "sparse":
        m = np.random.default_rng(seed).uniform(size=rows) < 0.1
        m[3] = True
        return m
    m = np.zeros(rows, bool)
    m[(np.arange(0, rows, group) + 5) % rows] = True
    return m


@pytest.mark.parametrize("pattern", ["none_masked", "all_masked", "sparse", "one_a_group"])
def test_plain_core_mask_matches_jax_at_kept_rows(pattern):
    """With a mask, the kept rows are the JAX kernel's rows (xla and Pallas
    interpret mode, 2e-5) and the dropped rows exactly 0 in logits and val;
    the CPU wrapper is the plain version and counts no launch."""
    rows = 40
    m, x1, attr, es = _edge_case(TINY, 2, rows)
    weights, rad = m._kernel_weights()
    mask = _row_mask(pattern, rows)
    with torch.no_grad():
        logits, val = tek.edge_core_plain(m.plan, t(x1), t(attr), t(es), weights, rad, mask=torch.as_tensor(mask))
        before = tek.launches
        l2, v2 = tek.edge_kernel(m.plan, t(x1), t(attr), t(es), weights, rad, mask=torch.as_tensor(mask))
    assert tek.launches == before
    torch.testing.assert_close(l2, logits, rtol=0, atol=0)
    torch.testing.assert_close(v2, val, rtol=0, atol=0)
    assert logits.shape == (rows, m.H) and val.shape == (rows, m.plan.attn_dim)
    drop = ~torch.as_tensor(mask)
    assert float(logits[drop].abs().sum()) == 0.0 and float(val[drop].abs().sum()) == 0.0
    jplan, jweights, jrad = _jax_operands(m, weights, rad)
    for kw in (dict(mode="xla"), dict(mode="pallas", interpret=True)):
        jl, jv = jek.edge_kernel_call(jplan, jnp.asarray(x1), jnp.asarray(attr), jnp.asarray(es), jweights,
                                      rad=jrad, **kw)
        np.testing.assert_allclose(np.asarray(jl)[mask], logits.numpy()[mask], atol=2e-5)
        np.testing.assert_allclose(np.asarray(jv)[mask], val.numpy()[mask], atol=2e-5)


def test_mask_checks():
    """A mask in the mixed bfloat16 mode raises ``ValueError`` (its kernel
    computes every row); so does a mask of the wrong dtype or shape."""
    rows = 16
    m, x1, attr, es = _edge_case(TINY, 2, rows)
    weights, rad = m._kernel_weights()
    mask = torch.ones(rows, dtype=torch.bool)
    with pytest.raises(ValueError, match="mixed"):
        tek.edge_kernel(m.plan, t(x1).to(torch.bfloat16), t(attr), t(es), tek.weights_bf16(weights), rad, mask=mask)
    for bad in (mask.to(torch.int32), mask[:-1], mask.reshape(4, 4)):
        with pytest.raises(ValueError, match="mask"):
            tek.edge_kernel(m.plan, t(x1), t(attr), t(es), weights, rad, mask=bad)


@pytest.mark.parametrize("rows", [37, 256])
def test_plain_core_bf16_matches_jax_transposed_kernel(rows):
    """Mixed mode (bfloat16 message and ``W_av``) against the JAX transposed
    kernel in interpret mode: logits within 1e-4, val within one bfloat16
    unit (2^-8) of max|val|.  Both round at the same places; a float32 sum
    taken in another order can still move a bfloat16 rounding by one unit.
    Seen on the CPU: logits 3e-7, val identical.  Logits come back float32,
    val bfloat16, and any other mix of dtypes raises."""
    m, x1, attr, es = _edge_case(TINY, 2, rows)
    weights, rad = m._kernel_weights()
    xb = t(x1).to(torch.bfloat16)
    wb = tek.weights_bf16(weights)
    assert wb[0].dtype == torch.bfloat16 and all(w.dtype == torch.float32 for w in wb[1:])
    with torch.no_grad():
        logits, val = tek.edge_kernel(m.plan, xb, t(attr), t(es), wb, rad)
    assert logits.dtype == torch.float32 and val.dtype == torch.bfloat16
    jplan, jweights, jrad = _jax_operands(m, weights, rad)
    jl, jv = jek.edge_kernel_call(jplan, jnp.asarray(x1).astype(jnp.bfloat16), jnp.asarray(attr), jnp.asarray(es),
                                  jweights, mode="pallas_t", interpret=True, rad=jrad)
    assert jl.dtype == jnp.float32 and jv.dtype == jnp.bfloat16
    val32, jv32 = val.float().numpy(), np.asarray(jv.astype(jnp.float32))
    err_l = float(np.abs(np.asarray(jl) - logits.numpy()).max())
    err_v = float(np.abs(jv32 - val32).max()) / float(np.abs(jv32).max())
    print(f"bf16 plain vs JAX transposed kernel: logits {err_l:.3g}, val {err_v:.3g} of max|val|")
    assert err_l <= 1e-4 and err_v <= 2.0 ** -8
    # the mixed result is close to, and not the same as, the float32 result
    with torch.no_grad():
        _, v32 = tek.edge_core_plain(m.plan, t(x1), t(attr), t(es), weights, rad)
    assert 0 < float((v32 - val.float()).abs().max()) <= 5e-2 * float(v32.abs().max())
    for bad in ((xb, t(attr), t(es), weights), (t(x1), t(attr), t(es), wb),
                (xb, t(attr).to(torch.bfloat16), t(es), wb), (t(x1).double(), t(attr), t(es), weights)):
        with pytest.raises(TypeError):
            tek.edge_kernel(m.plan, *bad, rad)


@pytest.mark.parametrize("edge_impl", ["plain", "kernel"])
@pytest.mark.parametrize("component_major", [False, True])
def test_graph_attention_matches_flax(edge_impl, component_major):
    """Against the flax module, with one destination row whose slots are all
    masked (``_ga_inputs``' last): on ``"kernel"`` the edge segment gets the
    mask and returns zeros for every slot of that row, whose output is then
    the projection of zeros."""
    m, ref, params = _ga_pair(TINY, 2, component_major)
    m.edge_impl = edge_impl
    msg, attr, sc, mask, pre, post = _ga_inputs(TINY)
    assert not mask[-1].any()
    msg_j = msg if component_major else msg[..., np.argsort(im_perm(Irreps(TINY)))]
    out_j = ref.apply(params, *map(jnp.asarray, (msg_j, attr, sc, mask)), edge_pre_attn_logit=jnp.asarray(pre),
                      edge_post_attn=jnp.asarray(post))
    with torch.no_grad():
        out_t = m(t(msg), t(attr), t(sc), torch.as_tensor(mask), edge_pre_attn_logit=t(pre), edge_post_attn=t(post))
        zero = m.proj(torch.zeros(1, m.irreps_attn.dim))
    np.testing.assert_allclose(np.asarray(out_j), out_t.numpy(), atol=2e-5)
    torch.testing.assert_close(out_t[-1:], zero, rtol=0, atol=1e-6)
    if edge_impl == "kernel":  # what the segment returns for the all-masked row
        weights, rad = m._kernel_weights()
        flat = lambda a: t(a).reshape(-1, a.shape[-1])
        with torch.no_grad():
            logits, val = tek.edge_kernel(m.plan, flat(msg), flat(attr), flat(sc), weights, rad,
                                          mask=torch.as_tensor(mask).reshape(-1))
        k = mask.shape[1]
        assert float(logits[-k:].abs().sum()) == 0.0 and float(val[-k:].abs().sum()) == 0.0


def test_graph_attention_bf16_matches_flax_bf16():
    """``edge_impl="kernel_bf16"`` against the flax module on
    ``fused_core="edge_t_bf16_interpret"``: within 2e-2 of the output's
    largest entry (bfloat16 keeps 8 bits), and the output stays float32."""
    m, _, params = _ga_pair(TINY, 2, True)
    ref = JGA(irreps_input=Irreps(TINY), irreps_edge_attr=Irreps(SH), irreps_output=Irreps(TINY), fc_neurons=(8, 16),
              num_heads=2, alpha_drop=0.0, message_component_major=True, fused_core="edge_t_bf16_interpret")
    m.edge_impl = "kernel_bf16"
    msg, attr, sc, mask, pre, post = _ga_inputs(TINY)
    out_j = np.asarray(ref.apply(params, *map(jnp.asarray, (msg, attr, sc, mask)), edge_pre_attn_logit=jnp.asarray(pre),
                                 edge_post_attn=jnp.asarray(post)))
    with torch.no_grad():
        out_t = m(t(msg), t(attr), t(sc), torch.as_tensor(mask), edge_pre_attn_logit=t(pre), edge_post_attn=t(post))
    assert out_t.dtype == torch.float32
    assert float(np.abs(out_j - out_t.numpy()).max()) <= 2e-2 * float(np.abs(out_j).max())


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
