"""The hand-written CUDA edge kernel against its plain PyTorch version on the
card.  This file imports neither jax nor the JAX package, so it runs on a GPU
machine without them:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Without a CUDA device every case skips."""
import pytest
import torch

from diffusion_edf_tpu_torch.geom.sh import spherical_harmonics
from diffusion_edf_tpu_torch.nn import edge_kernel as tek
from diffusion_edf_tpu_torch.nn.attention import GraphAttention
from diffusion_edf_tpu_torch.weights import init_params

SH = "1x0e+1x1e+1x2e"


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the edge kernel has no CPU mode")


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
def test_graph_attention_kernel_matches_plain():
    _need_cuda()
    m = _ga("32x0e+16x1e+8x2e", 4, (32, 16, 16))
    g = torch.Generator(device="cuda").manual_seed(2)
    nd, k = 40, 24
    msg = torch.randn(nd, k, m.plan.dim_in, generator=g, device="cuda")
    attr = spherical_harmonics(SH, torch.randn(nd, k, 3, generator=g, device="cuda"), eps=1e-4)
    sc = torch.randn(nd, k, 32, generator=g, device="cuda")
    mask = torch.rand(nd, k, generator=g, device="cuda") < 0.8
    outs = []
    with torch.no_grad():
        for impl in ("kernel", "plain"):
            m.edge_impl = impl
            outs.append(m(msg, attr, sc, mask))
    torch.testing.assert_close(outs[0], outs[1], rtol=0, atol=3e-4)
