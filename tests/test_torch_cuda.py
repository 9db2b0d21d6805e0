"""The hand-written CUDA kernels (the edge kernel in float32 and in its mixed
bfloat16 mode, and the fused attention kernel) against their plain PyTorch
versions on the card.  This file imports neither jax nor the JAX package, so
it runs on a GPU machine without them:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Without a CUDA device every case skips."""
import pytest
import torch

from diffusion_edf_tpu_torch.geom.sh import spherical_harmonics
from diffusion_edf_tpu_torch.nn import edge_kernel as tek
from diffusion_edf_tpu_torch.nn import fused_attention as tfa
from diffusion_edf_tpu_torch.nn.attention import _head_of_col
from diffusion_edf_tpu_torch.nn.attention import GraphAttention
from diffusion_edf_tpu_torch.weights import init_params

SH = "1x0e+1x1e+1x2e"


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: a CUDA kernel has no CPU mode")


def _ga(irreps, heads, fc, seed=0):
    m = GraphAttention(irreps, SH, irreps, fc_neurons=fc, num_heads=heads)
    return init_params(m, torch.Generator().manual_seed(seed)).cuda()


@pytest.mark.cuda
@pytest.mark.parametrize("irreps,heads,fc,rows", [
    ("8x0e+4x1e+2x2e", 2, (8, 16), 77),
    ("32x0e+16x1e+8x2e", 4, (32, 16, 16), 1000),
    ("64x0e+32x1e+16x2e", 4, (128, 128, 64), 1000),
])
def test_edge_kernel_matches_plain(irreps, heads, fc, rows):
    _need_cuda()
    m = _ga(irreps, heads, fc)
    g = torch.Generator(device="cuda").manual_seed(1)
    x1 = torch.randn(rows, m.plan.dim_in, generator=g, device="cuda")
    attr = spherical_harmonics(SH, torch.randn(rows, 3, generator=g, device="cuda"), eps=1e-4)
    es = torch.randn(rows, fc[0], generator=g, device="cuda")
    with torch.no_grad():
        weights, rad = m._kernel_weights()
        before = tek.launches
        kl, kv = tek.edge_kernel(m.plan, x1, attr, es, weights, rad)
        torch.cuda.synchronize()
        assert tek.launches == before + 1
        pl, pv = tek.edge_core_plain(m.plan, x1, attr, es, weights, rad)
    torch.testing.assert_close(kl, pl, rtol=0, atol=3e-4)
    torch.testing.assert_close(kv, pv, rtol=0, atol=3e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("irreps,heads,fc,rows", [
    ("8x0e+4x1e+2x2e", 2, (8, 16), 77),
    ("32x0e+16x1e+8x2e", 4, (32, 16, 16), 1000),
    ("64x0e+32x1e+16x2e", 4, (128, 128, 64), 1000),
])
def test_edge_kernel_bf16_matches_plain(irreps, heads, fc, rows):
    """Mixed bfloat16 mode: logits within 2e-2, val within 2e-2 of max|val|
    (a float32 sum taken in another order can move a bfloat16 rounding by one
    unit, 2^-8 relative); logits come back float32, val bfloat16; any other
    mix of dtypes raises."""
    _need_cuda()
    m = _ga(irreps, heads, fc)
    g = torch.Generator(device="cuda").manual_seed(1)
    x1 = torch.randn(rows, m.plan.dim_in, generator=g, device="cuda")
    attr = spherical_harmonics(SH, torch.randn(rows, 3, generator=g, device="cuda"), eps=1e-4)
    es = torch.randn(rows, fc[0], generator=g, device="cuda")
    with torch.no_grad():
        weights, rad = m._kernel_weights()
        wb = tek.weights_bf16(weights)
        xb = x1.to(torch.bfloat16)
        before = tek.launches_bf16, tek.launches
        kl, kv = tek.edge_kernel(m.plan, xb, attr, es, wb, rad)
        torch.cuda.synchronize()
        assert (tek.launches_bf16, tek.launches) == (before[0] + 1, before[1])
        pl, pv = tek.edge_core_plain(m.plan, xb, attr, es, wb, rad)
        with pytest.raises(TypeError):
            tek.edge_kernel(m.plan, xb, attr, es, weights, rad)
        with pytest.raises(TypeError):
            tek.edge_kernel(m.plan, x1, attr.to(torch.bfloat16), es, weights, rad)
    assert kl.dtype == pl.dtype == torch.float32 and kv.dtype == pv.dtype == torch.bfloat16
    torch.testing.assert_close(kl, pl, rtol=0, atol=2e-2)
    scale = float(pv.float().abs().max())
    assert float((kv.float() - pv.float()).abs().max()) <= 2e-2 * scale


def _attention_inputs(m, nd, k, S, seed, masked_rows=(0,)):
    g = torch.Generator(device="cuda").manual_seed(seed)
    msg = torch.randn(nd, k, m.plan.dim_in, generator=g, device="cuda")
    attr = spherical_harmonics(SH, torch.randn(nd, k, 3, generator=g, device="cuda"), eps=1e-4)
    sc = torch.randn(nd, k, S, generator=g, device="cuda")
    mask = torch.rand(nd, k, generator=g, device="cuda") < 0.8
    mask[list(masked_rows)] = False  # rows with every slot masked
    pre = -torch.rand(nd, k, generator=g, device="cuda")
    post = torch.rand(nd, k, generator=g, device="cuda")
    return msg, attr, sc, mask, pre, post


@pytest.mark.cuda
@pytest.mark.parametrize("use_pre,use_post", [(True, True), (False, False)])
@pytest.mark.parametrize("irreps,heads,fc,nd,k", [
    ("8x0e+4x1e+2x2e", 2, (8, 16), 12, 11),  # one ragged tile
    ("64x0e+32x1e+16x2e", 4, (128, 128, 64), 64, 117),  # few rows: the K tiles go to several blocks
    ("32x0e+16x1e+8x2e", 4, (32, 16, 16), 300, 64),  # many rows: one block a row
    ("32x0e+16x1e+8x2e", 4, (32, 16, 16), 5, 4),
])
def test_fused_attention_matches_plain(irreps, heads, fc, nd, k, use_pre, use_post):
    _need_cuda()
    m = _ga(irreps, heads, fc)
    msg, attr, sc, mask, pre, post = _attention_inputs(m, nd, k, fc[0], seed=3, masked_rows=(0, nd - 1))
    hoc = _head_of_col(m.irreps_head, m.H, m.irreps_attn.dim)
    with torch.no_grad():
        weights, rad = m._kernel_weights()
        args = (m.plan, hoc, msg, attr, sc, mask, pre if use_pre else None, post if use_post else None, weights, rad)
        before = tfa.launches
        out = tfa.fused_attention(*args)
        torch.cuda.synchronize()
        assert tfa.launches == before + 1
        ref = tfa.fused_attention_plain(*args)
    assert torch.isfinite(out).all()
    assert float(out[0].abs().max()) == 0.0 and float(out[-1].abs().max()) == 0.0  # all-masked rows give exactly 0
    torch.testing.assert_close(out, ref, rtol=0, atol=3e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("impl,atol", [("kernel", 3e-4), ("fused", 3e-4), ("kernel_bf16", 5e-2)])
def test_graph_attention_impl_matches_plain(impl, atol):
    _need_cuda()
    m = _ga("32x0e+16x1e+8x2e", 4, (32, 16, 16))
    msg, attr, sc, mask, pre, post = _attention_inputs(m, 40, 24, 32, seed=2)
    outs = []
    with torch.no_grad():
        for edge_impl in (impl, "plain"):
            m.edge_impl = edge_impl
            outs.append(m(msg, attr, sc, mask, edge_pre_attn_logit=pre, edge_post_attn=post))
    torch.testing.assert_close(outs[0], outs[1], rtol=0, atol=atol)
