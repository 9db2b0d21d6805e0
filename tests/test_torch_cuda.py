"""The hand-written CUDA kernels (the edge kernel in float32, unmasked and at
masks of the rows to compute, and in its mixed bfloat16 mode, and the fused
attention kernel) against their plain PyTorch versions on the card, and
their refusal of autograd (they have no backward); the transpose of the
tensor product's and the linear layers' gathers against index_select's
own backward and the plain CSR sum, in a CUDA graph and in a train step; the agent's and the trainer's captured CUDA
graphs against their eager runs; the recorder's spans under the profiler,
which leave device time alone.  This file imports neither jax nor the JAX
package, so it runs on a GPU machine without them:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Without a CUDA device every case skips."""
import os

import numpy as np
import pytest
import torch

from diffusion_edf_tpu_torch.geom.sh import spherical_harmonics
from diffusion_edf_tpu_torch.nn import edge_kernel as tek
from diffusion_edf_tpu_torch.nn import fused_attention as tfa
from diffusion_edf_tpu_torch.nn.attention import _head_of_col
from diffusion_edf_tpu_torch.nn.attention import GraphAttention
from diffusion_edf_tpu_torch.weights import init_params

SH = "1x0e+1x1e+1x2e"
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = os.path.join(ROOT, "diffusion_edf_tpu_torch", "configs", "panda_mug")
CHECKPOINTS = os.path.join(ROOT, "checkpoints", "panda_mug")


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
    ("64x0e+32x1e+16x2e", 4, (64, 32, 32), 52 * 192),  # the place models' keypoint fields
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


PATTERNS = ["all_valid", "all_masked", "one_a_row", "whole_tiles", "straddle"]


def _pattern_mask(mask, pattern):
    """Masks that stress the compaction of the valid slots into tiles of 64,
    from a random (Nd, K) mask: every slot, none, one a row, a count that
    fills its tiles exactly, and rows whose slots lie across tile boundaries
    (one of them over several tiles)."""
    nd, k = mask.shape
    mask = mask.clone()
    if pattern == "all_valid":
        mask[:] = True
    elif pattern == "all_masked":
        mask[:] = False
    elif pattern == "one_a_row":
        mask[:] = False
        mask[torch.arange(nd), (7 * torch.arange(nd)) % k] = True
    elif pattern == "whole_tiles":
        flat = mask.reshape(-1)
        keep = max(64, int(flat.sum()) // 64 * 64)
        assert int(flat.sum()) >= keep
        mask = (flat & (torch.cumsum(flat, 0) <= keep)).reshape(nd, k)
        assert int(mask.sum()) % 64 == 0
    else:
        mask[:] = False
        mask[:, : min(k, 40)] = True
        mask[1] = True
        mask[2] = False
    return mask


@pytest.mark.cuda
@pytest.mark.parametrize("pattern", PATTERNS)
@pytest.mark.parametrize("irreps,heads,fc,nd,k", [
    ("8x0e+4x1e+2x2e", 2, (8, 16), 12, 11),
    ("32x0e+16x1e+8x2e", 4, (32, 16, 16), 70, 50),
    ("64x0e+32x1e+16x2e", 4, (128, 128, 64), 64, 117),
    ("64x0e+32x1e+16x2e", 4, (64, 32, 32), 52, 192),  # keypoint fields: 52 query points, 4 scales of 48
    ("64x0e+32x1e+16x2e", 4, (128, 128, 64), 32 * 52, 117),  # place key field: 32 seeds x 52 keypoints
])
def test_edge_kernel_mask_patterns(irreps, heads, fc, nd, k, pattern):
    """The float32 edge kernel given a mask of the rows to compute (without
    one: ``test_edge_kernel_matches_plain``): kept rows within 3e-4 of the
    plain version, dropped rows exactly 0 in logits and val whatever their
    inputs (NaN here: they are never read), one launch a call."""
    _need_cuda()
    m = _ga(irreps, heads, fc)
    msg, attr, sc, mask, _, _ = _attention_inputs(m, nd, k, fc[0], seed=5)
    rows = nd * k
    x1, attr, es = msg.reshape(rows, -1), attr.reshape(rows, -1), sc.reshape(rows, -1)
    keep = _pattern_mask(mask, pattern).reshape(-1)
    x1 = torch.where(keep[:, None], x1, torch.full_like(x1, float("nan")))
    with torch.no_grad():
        weights, rad = m._kernel_weights()
        before = tek.launches
        kl, kv = tek.edge_kernel(m.plan, x1, attr, es, weights, rad, mask=keep)
        torch.cuda.synchronize()
        assert tek.launches == before + 1
        pl, pv = tek.edge_core_plain(m.plan, torch.nan_to_num(x1), attr, es, weights, rad, mask=keep)
    assert float(kl[~keep].abs().sum()) == 0.0 and float(kv[~keep].abs().sum()) == 0.0
    torch.testing.assert_close(kl, pl, rtol=0, atol=3e-4)
    torch.testing.assert_close(kv, pv, rtol=0, atol=3e-4)


@pytest.mark.cuda
def test_edge_kernel_refuses_other_widths():
    """A width with no instantiation raises, with no fallback."""
    _need_cuda()
    m = _ga("16x0e+8x1e+4x2e", 2, (8, 16))
    rows = 70
    g = torch.Generator(device="cuda").manual_seed(1)
    x1 = torch.randn(rows, m.plan.dim_in, generator=g, device="cuda")
    attr = spherical_harmonics(SH, torch.randn(rows, 3, generator=g, device="cuda"), eps=1e-4)
    es = torch.randn(rows, 8, generator=g, device="cuda")
    before = tek.launches
    with torch.no_grad():  # the width, not autograd, is what is refused here
        weights, rad = m._kernel_weights()
        with pytest.raises(ValueError):
            tek.edge_kernel(m.plan, x1, attr, es, weights, rad)
        with pytest.raises(ValueError):
            tek.edge_kernel(m.plan, x1, attr, es, weights, rad, mask=torch.ones(rows, dtype=torch.bool, device="cuda"))
    assert tek.launches == before


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
    ("64x0e+32x1e+16x2e", 4, (128, 128, 64), 64, 117),  # rows of up to 117 valid slots: each spans tiles
    ("32x0e+16x1e+8x2e", 4, (32, 16, 16), 300, 64),  # many rows, pieces of 8 lanes
    ("32x0e+16x1e+8x2e", 4, (32, 16, 16), 5, 4),
    ("64x0e+32x1e+16x2e", 4, (64, 32, 32), 52, 192),  # the place models' keypoint fields
    ("64x0e+32x1e+16x2e", 4, (128, 128, 64), 32 * 52, 117),  # place key field, 194,688 slots
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
@pytest.mark.parametrize("pattern", PATTERNS)
@pytest.mark.parametrize("irreps,heads,fc,nd,k", [
    ("8x0e+4x1e+2x2e", 2, (8, 16), 12, 11),
    ("32x0e+16x1e+8x2e", 4, (32, 16, 16), 70, 50),  # pieces of 8 lanes; K no multiple of 64
    ("64x0e+32x1e+16x2e", 4, (128, 128, 64), 64, 117),
    ("64x0e+32x1e+16x2e", 4, (64, 32, 32), 52, 192),  # keypoint fields
])
def test_fused_attention_mask_patterns(irreps, heads, fc, nd, k, pattern):
    """Masks that stress the compaction of the valid slots into tiles of 64:
    every slot, none, one a row, a count that fills its tiles exactly, and
    rows whose slots lie across tile boundaries (one of them over several
    tiles).  Rows without a valid slot come out exactly 0."""
    _need_cuda()
    m = _ga(irreps, heads, fc)
    msg, attr, sc, mask, pre, post = _attention_inputs(m, nd, k, fc[0], seed=4)
    mask = _pattern_mask(mask, pattern)
    hoc = _head_of_col(m.irreps_head, m.H, m.irreps_attn.dim)
    with torch.no_grad():
        weights, rad = m._kernel_weights()
        args = (m.plan, hoc, msg, attr, sc, mask, pre, post, weights, rad)
        out = tfa.fused_attention(*args)
        torch.cuda.synchronize()
        ref = tfa.fused_attention_plain(*args)
    assert torch.isfinite(out).all()
    empty = ~mask.any(dim=1)
    if bool(empty.any()):
        assert float(out[empty].abs().max()) == 0.0
    torch.testing.assert_close(out, ref, rtol=0, atol=3e-4)


@pytest.mark.cuda
def test_tensor_core_kernels_hold_warpgroup_products():
    """The built libraries' SASS holds HGMMA in each kernel's own function:
    both folded products run on the tensor cores, in the float32 edge kernel
    as in the mixed one and the fused attention kernel."""
    _need_cuda()
    from diffusion_edf_tpu_torch.nn import cuda_build

    cuda_build.build_all()
    for name, fn in (("edge_kernel", "edge_kernel_f32"), ("edge_kernel", "edge_kernel_mixed"),
                     ("fused_attention", "attention_kernel")):
        assert cuda_build.sass_count(name, "HGMMA", fn) > 0, (name, fn)


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


@pytest.mark.cuda
def test_kernels_refuse_autograd():
    """A kernel call that autograd would record raises before it launches,
    for an input or a weight that requires grad; under ``torch.no_grad()``
    the same call launches."""
    _need_cuda()
    m = _ga("32x0e+16x1e+8x2e", 4, (32, 16, 16))
    msg, attr, sc, mask, pre, post = _attention_inputs(m, 40, 24, 32, seed=5)
    hoc = _head_of_col(m.irreps_head, m.H, m.irreps_attn.dim)
    flat = [a.reshape(40 * 24, -1) for a in (msg, attr, sc)]
    weights, rad = m._kernel_weights()  # grad on: the folded weights require grad
    with torch.no_grad():
        weights_ng, rad_ng = m._kernel_weights()
    before = (tek.launches, tek.launches_bf16, tfa.launches)
    with pytest.raises(RuntimeError, match="no backward"):
        tek.edge_kernel(m.plan, *flat, weights, rad, mask=mask.reshape(-1))
    with pytest.raises(RuntimeError, match="no backward"):
        tek.edge_kernel(m.plan, flat[0].clone().requires_grad_(True), *flat[1:], weights_ng, rad_ng)
    with pytest.raises(RuntimeError, match="no backward"):
        tfa.fused_attention(m.plan, hoc, msg, attr, sc, mask, pre, post, weights, rad)
    with pytest.raises(RuntimeError, match="no backward"):
        tfa.fused_attention(m.plan, hoc, msg.clone().requires_grad_(True), attr, sc, mask, pre, post, weights_ng, rad_ng)
    torch.cuda.synchronize()
    assert (tek.launches, tek.launches_bf16, tfa.launches) == before
    with torch.no_grad():
        tek.edge_kernel(m.plan, *flat, weights, rad, mask=mask.reshape(-1))
        tfa.fused_attention(m.plan, hoc, msg, attr, sc, mask, pre, post, weights, rad)
    torch.cuda.synchronize()
    assert (tek.launches, tfa.launches) == (before[0] + 1, before[2] + 1)


@pytest.mark.cuda
def test_graph_attention_routes_autograd_and_dropout_to_plain():
    """``edge_impl=None`` on CUDA: the kernel under ``torch.no_grad()`` in
    eval() mode; the plain path, with no launch, while autograd records or
    dropout is on, with the plain path's gradients (to 1e-5 of their
    largest: the card's atomic adds in the gathers' backward sum in any
    order); an explicit kernel ``edge_impl`` raises then."""
    _need_cuda()
    m = _ga("32x0e+16x1e+8x2e", 4, (32, 16, 16))
    msg, attr, sc, mask, pre, post = _attention_inputs(m, 40, 24, 32, seed=6)

    def run():
        return m(msg, attr, sc, mask, edge_pre_attn_logit=pre, edge_post_attn=post)

    before = tek.launches
    with torch.no_grad():
        run()
    torch.cuda.synchronize()
    assert tek.launches == before + 1
    before = (tek.launches, tek.launches_bf16, tfa.launches)
    run().square().sum().backward()
    grads = [p.grad.clone() for p in m.parameters()]
    m.train()
    with torch.no_grad():
        run()
    m.eval()
    torch.cuda.synchronize()
    assert (tek.launches, tek.launches_bf16, tfa.launches) == before
    m.zero_grad()
    m.edge_impl = "plain"
    run().square().sum().backward()
    for a, p in zip(grads, m.parameters()):
        torch.testing.assert_close(a, p.grad, rtol=0, atol=1e-5 * float(a.abs().max()))
    for impl in ("kernel", "kernel_bf16", "fused"):
        m.edge_impl = impl
        with pytest.raises(RuntimeError, match="no backward"):
            run()
    assert (tek.launches, tek.launches_bf16, tfa.launches) == before


# ---- the agent's sampling runtime: captured CUDA graphs against the eager rollout ----

TINY_IRREPS = "8x0e+4x1e+2x2e"
TINY_MODEL = dict(  # the tiny pick model of the CPU parity tests (__graft_entry__._model_config(tiny=True))
    model_name="MultiscaleScoreModel",
    model_kwargs=dict(
        score_head_kwargs=dict(
            max_time=1.0, time_emb_mlp=[32, 32, 16], ang_mult=2.5, lin_mult=15.0,
            edge_time_encoding=True, query_time_encoding=False,
            key_tensor_field_kwargs=dict(
                irreps_output=TINY_IRREPS, irreps_sh=SH, num_heads=2, fc_neurons=[-1, 16, 16], length_emb_dim=16,
                r_cluster_multiscale=[5.0, None], k_multiscale=[8, 64], n_layers=1, irreps_mlp_mid=2,
                cutoff_method="edge_attn", r_mincut_nonscalar_sh=0.3, length_enc_max_r=100.0, alpha_drop=0.0),
        ),
        key_kwargs=dict(feature_extractor_name="UnetFeatureExtractor", feature_extractor_kwargs=dict(
            irreps_input="3x0e", irreps_output=TINY_IRREPS, irreps_emb=[TINY_IRREPS, TINY_IRREPS],
            irreps_edge_attr=[SH] * 2, num_heads=[2, 2], fc_neurons=[[16, 16]] * 2, n_layers=[1, 1],
            pool_ratio=[0.25, 0.25], radius=[3.0, None], n_layers_midstream=1, k_pool=[8, 8], k_self=[8, 8],
            k_up=[6, 6], irreps_mlp_mid=2, alpha_drop=0.0)),
        query_model="StaticKeypointModel",
        query_kwargs=dict(irreps_output=TINY_IRREPS, keypoint_coords=[[0.5, 0.5, 10.5], [-0.5, -0.5, 10.5]]),
    ),
)
TINY_PREPROCESS = [dict(name="downsample", kwargs=dict(voxel_size=0.01, coord_reduction="average")),
                   dict(name="rescale", kwargs=dict(rescale_factor=100.0))]
TINY_UNPROCESS = [dict(name="rescale", kwargs=dict(rescale_factor=0.01))]
TINY_DIFF = dict(N_steps_list=[[4, 3]], timesteps_list=[[0.04, 0.02]], temperatures_list=[[1.0, 0.0]],
                 diffusion_schedules_list=[[[1.0, 0.15], [0.15, 0.02]]], log_t_schedule=True,
                 time_exponent_temp=1.0, time_exponent_alpha=0.5)


def _tiny_agent(tmp_path, edge_impl=None, use_runtime=True):
    import yaml

    from diffusion_edf_tpu_torch.agent import DiffusionEdfAgent, load_model_bundle

    d = tmp_path / "tiny"
    if not d.exists():
        d.mkdir()
        (d / "train_configs.yaml").write_text(yaml.safe_dump(dict(model_config_file="score_model_configs.yaml")))
        (d / "task_configs.yaml").write_text(yaml.safe_dump(dict(task_type="pick")))
        (d / "score_model_configs.yaml").write_text(yaml.safe_dump(TINY_MODEL))
    b = load_model_bundle(str(d), device="cuda", n_scene_pad=256, n_grasp_pad=96, init_seed=3, edge_impl=edge_impl)
    return DiffusionEdfAgent([b], TINY_PREPROCESS, TINY_UNPROCESS, preprocess_seed=0, use_runtime=use_runtime)


def _tiny_request():
    import numpy as np

    from diffusion_edf_tpu_torch.train.data import PointCloud

    rng = np.random.default_rng(0)
    scene = PointCloud(rng.uniform(-0.12, 0.12, (220, 3)).astype(np.float32), rng.uniform(0, 1, (220, 3)))
    grasp = PointCloud((rng.uniform(-0.05, 0.05, (60, 3)) + [0, 0, 0.1]).astype(np.float32),
                       rng.uniform(0, 1, (60, 3)))
    q = rng.normal(size=(5, 4))
    Ts = np.concatenate([q / np.linalg.norm(q, axis=-1, keepdims=True),
                         rng.uniform([-0.03, -0.03, 0.07], [0.03, 0.03, 0.11], (5, 3))], -1)
    return scene, grasp, Ts.astype(np.float32)


def _gen(seed):
    return torch.Generator(device="cuda").manual_seed(seed)


@pytest.mark.cuda
@pytest.mark.parametrize("edge_impl", ["kernel", "fused", "plain"])
def test_captured_rollout_equals_eager(tmp_path, edge_impl):
    """The tiny model's rollout through the runtime's captured graphs
    (first call: eager first steps and captures; second call: replays only)
    against the same agent run eagerly, noise on and a temperature-0
    segment: final poses within 1e-5, and every kernel launch counted as the
    eager run counts it."""
    _need_cuda()
    import numpy as np

    from diffusion_edf_tpu_torch.graphs import launch_counts

    scene, grasp, Ts = _tiny_request()
    runs = {}
    for use_runtime in (False, True):
        agent = _tiny_agent(tmp_path, edge_impl, use_runtime)
        for call in range(2):
            before = launch_counts()
            traj = agent.sample(scene, grasp, Ts, generator=_gen(1), **TINY_DIFF)[0]
            torch.cuda.synchronize()
            runs[use_runtime, call] = traj, tuple(a - b for a, b in zip(launch_counts(), before))
    (entry,) = agent._runtimes[0].entries["rollout"].values()
    assert len(entry.steps) == 2 and all(p.graph is not None for p in entry.steps.values())  # noise, temperature 0
    eager, launched = runs[False, 0]
    assert np.abs(eager[-1] - eager[0]).max() > 1e-3  # the poses moved
    for call in range(2):
        traj, n = runs[True, call]
        assert np.abs(traj - eager).max() <= 1e-5
        assert n == launched
    assert (launched[0] > 0) == (edge_impl == "kernel") and (launched[2] > 0) == (edge_impl == "fused")


@pytest.mark.cuda
def test_capture_meeting_a_host_sync_raises(tmp_path):
    """A score that reads a value on the host cannot be captured: the
    sample raises, and neither carries on eagerly nor counts the capture's
    launches (those of the extraction's first pass and of the rollout's
    first step stay, as the eager agent counts them for a one-step
    request)."""
    _need_cuda()
    from diffusion_edf_tpu_torch.graphs import launch_counts

    scene, grasp, Ts = _tiny_request()
    one_step = dict(TINY_DIFF, N_steps_list=[[1]], timesteps_list=[[0.04]], temperatures_list=[[1.0]],
                    diffusion_schedules_list=[[[1.0, 0.15]]])
    before = launch_counts()
    _tiny_agent(tmp_path, "kernel", use_runtime=False).sample(scene, grasp, Ts, generator=_gen(1), **one_step)
    torch.cuda.synchronize()
    expected = launch_counts()[0] - before[0]

    agent = _tiny_agent(tmp_path, "kernel")
    model = agent.models[0].model
    score = model.score

    def syncing_score(*args):
        ang, lin = score(*args)
        return ang * float(ang.abs().max() >= 0), lin

    model.score = syncing_score
    before = launch_counts()
    with pytest.raises(RuntimeError):
        agent.sample(scene, grasp, Ts, generator=_gen(1), **TINY_DIFF)
    torch.cuda.synchronize()
    assert expected > 0 and launch_counts()[0] - before[0] == expected
    assert torch.ones(1, device="cuda").sum().item() == 1.0  # the device still works


# ---- the trainer's compiled step: captured CUDA graphs against eager steps ----

def _tiny_trainer(tmp_path, ebm, use_runtime, label, lr=3e-4):
    import copy

    import yaml

    from diffusion_edf_tpu_torch.train.synthetic import make_synthetic_dataset
    from diffusion_edf_tpu_torch.train.trainer import DiffusionEdfTrainer

    d = tmp_path / f"train_{ebm}_{lr}"
    if not d.exists():
        d.mkdir()
        model = copy.deepcopy(TINY_MODEL)
        mk = model["model_kwargs"]
        mk["score_head_kwargs"]["key_tensor_field_kwargs"]["alpha_drop"] = 0.1
        mk["key_kwargs"]["feature_extractor_kwargs"]["alpha_drop"] = 0.1
        train = dict(model_config_file="score_model_configs.yaml", rescale_factor=100.0,
                     preprocess_config=TINY_PREPROCESS, n_samples_x_ref=4, optimizer_kwargs=dict(lr=lr),
                     diffusion_configs=dict(time_schedules=[[1.0, 0.15], [0.15, 0.01]]))
        if ebm:  # as configs/panda_mug/pick_ebm, with fewer negatives
            mk["score_head_kwargs"].update(ebm=True, edge_time_encoding=False)
            train.update(critic_rank_configs=dict(weight=1.0, n_negatives=8),
                         diffusion_configs=dict(time_schedules=[[0.03, 0.03]]))
        task = dict(task_type="pick", contact_radius=0.02)
        for name, c in (("train_configs.yaml", train), ("task_configs.yaml", task), ("score_model_configs.yaml", model)):
            (d / name).write_text(yaml.safe_dump(c))
    tr = DiffusionEdfTrainer(str(d), log_dir=str(tmp_path / f"log_{ebm}_{label}"), n_scene_pad=512, n_grasp_pad=160,
                             device="cuda", use_runtime=use_runtime)
    demos = (make_synthetic_dataset(n_demos=2, seed=0, n_scene=600, n_grasp=150)
             + make_synthetic_dataset(n_demos=1, seed=0, family="bowl", n_scene=600, n_grasp=150))  # one orbit
    tr.init(demos)
    return tr


@pytest.mark.cuda
@pytest.mark.parametrize("ebm", [False, True], ids=["score", "critic"])
def test_captured_train_steps_equal_eager(tmp_path, ebm):
    """Two epochs of three demos (one with an orbit), dropout on, through the
    trainer's captured graphs (the trainer's generator registered with them)
    against three eager runs, ``chip_smoke.py``'s 10f gate: the captured
    run's losses (largest difference) and its parameters, EMA and optimizer
    state (norm of the difference) no farther from the nearest eager run
    than twice the eager runs' largest difference (the card's backward sums
    in no fixed order) or 1e-4 of the largest loss and 1e-2 of the norm of
    the state's change; the generator left in the eager state; two entries,
    both captured, none new in epoch 2."""
    _need_cuda()
    import json

    runs = []
    for label, use_runtime in enumerate((False, False, False, True)):
        tr = _tiny_trainer(tmp_path, ebm, use_runtime, label)
        if label == 0:
            start = torch.cat([t.detach().double().reshape(-1).cpu() for t in (*tr._written(), *tr.ema)])
        tr.train_epoch()
        entries = tr.cache_size()
        tr.train_epoch()
        if use_runtime:
            assert entries == tr.cache_size() == 2
            assert all(e.program.graph is not None for e in tr._entries.values())
        with open(f"{tr.log_dir}/metrics.jsonl") as f:
            losses = torch.tensor([json.loads(line)["loss/train"] for line in f], dtype=torch.float64)
        state = torch.cat([t.detach().double().reshape(-1).cpu() for t in (*tr._written(), *tr.ema)])
        runs.append((losses, state, tr.generator.get_state()))
    *eager, captured = runs
    floors = (1e-4 * float(eager[0][0].abs().max()), 1e-2 * float((eager[0][1] - start).norm()))
    for i, diff in ((0, lambda a, b: float((a - b).abs().max())), (1, lambda a, b: float((a - b).norm()))):
        spread = max(diff(a[i], b[i]) for j, a in enumerate(eager) for b in eager[j + 1:])
        assert min(diff(captured[i], e[i]) for e in eager) <= max(2 * spread, floors[i])
    assert torch.equal(captured[2], eager[0][2])
    assert len(captured[0]) == 6 and torch.isfinite(captured[0]).all()


@pytest.mark.cuda
def test_replay_bumps_versions_and_caches_follow(tmp_path):
    """A replayed step bumps the version counters of what it wrote (the
    parameters, the EMA, the optimizer state) with no launch, so a no-grad
    score on K1 after it, whose derived weights were cached before it,
    equals a freshly loaded model's on the trained weights."""
    _need_cuda()
    from diffusion_edf_tpu_torch.data import stack_points
    from diffusion_edf_tpu_torch.graphs import launch_counts
    from diffusion_edf_tpu_torch.train.factory import build_score_model
    from diffusion_edf_tpu_torch.weights import flat_arrays, load_flat_params

    tr = _tiny_trainer(tmp_path, False, True, "bump", lr=1e-2)
    b = tr.batches[0]
    Ts = b.T.expand(3, 7).clone()
    Ts[:, 4:] += torch.tensor([[0.0, 0.0, 0.0], [1.0, 0.0, 0.0], [0.0, -2.0, 1.0]], device="cuda")
    time = torch.tensor([[0.1, 0.4, 0.8]], device="cuda")

    def score(model):
        with torch.no_grad():
            key_ms = [stack_points([p]) for p in model.get_key_pcd_multiscale(b.scene)]
            return model.score(Ts[None], key_ms, stack_points([model.get_query_pcd(b.grasp)]), time)

    tr.step(b)  # captures
    tr.model.eval()
    before = score(tr.model)  # caches the derived weights of these parameters
    versions = [t._version for t in tr._written()]
    launched = launch_counts()
    for _ in range(3):
        tr.step(b)  # replays
    assert launch_counts() == launched
    assert all(t._version > v for t, v in zip(tr._written(), versions))
    tr.model.eval()
    after = score(tr.model)
    fresh = load_flat_params(build_score_model(tr.model_cfg["model_name"], tr.model_cfg["model_kwargs"]),
                             flat_arrays(tr.model)).cuda().eval()
    again = score(fresh)
    for a, f, z in zip(after, again, before):
        scale = float(f.abs().max())
        torch.testing.assert_close(a, f, rtol=0, atol=1e-5 * scale)
        assert float((a - z).abs().max()) > 1e-3 * scale


@pytest.mark.cuda
def test_spans_under_the_profiler_leave_device_time_alone():
    """Under the profiler a span of host work is a host range only, and a
    span that encloses device work opens no range: no device event bears a
    span's name (a ``record_function`` range over kernels has a device twin,
    which a reading of device events counts as busy time)."""
    _need_cuda()
    from torch.profiler import ProfilerActivity, profile

    from diffusion_edf_tpu_torch.utils.profiling import span

    x = torch.ones(1 << 20, device="cuda")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with span("probe.host"):
            host = sum(range(1000))
        with span("probe.device", device_work=True):
            y = (x * 2).sum()
            torch.cuda.synchronize()
    assert host == 499500 and float(y) == 2 * (1 << 20)
    events = prof.events()
    assert [e.device_type for e in events if e.name == "probe.host"] == [torch.autograd.DeviceType.CPU]
    assert not [e for e in events if e.name == "probe.device"]
    assert any(e.device_type == torch.autograd.DeviceType.CUDA for e in events)  # the kernels are traced


# ---- the transpose of apply_dtp_cm's constant-table gathers (csrc/gather.cu) ----

GATHER_CASES = [  # (in1 irreps, table, rows): the pick train step's shapes, and the coefficient table
    ("32x0e+16x1e+8x2e", "X", 26240),  # (26240, 3920) -> 120
    ("64x0e+32x1e+16x2e", "X", 4680),  # (4680, 7840) -> 240
    ("32x0e+16x1e+8x2e", "W", 16400),  # (16400, 784) -> 240
    ("32x0e+16x1e+8x2e", "C", 2048),  # (2048, 3920) -> 130, the zero column's segment empty
]


def _gather_table(irreps, which):
    from diffusion_edf_tpu_torch.nn import tp

    prog = tp.dtp_instructions(tp.Irreps(irreps), tp.Irreps(SH), tp.Irreps(irreps))
    return dict(zip("XCW", tp.cm_tables(prog, False, torch.zeros(0, device="cuda"))))[which]


def _kept(table):
    kept = torch.zeros(table.idx.shape[0], dtype=torch.bool, device=table.idx.device)
    kept[table.lanes.long()] = True
    return kept


@pytest.mark.cuda
@pytest.mark.parametrize("irreps,which,rows", GATHER_CASES)
def test_gather_kernel_matches_index_add(irreps, which, rows):
    """The kernel against index_select's own backward (zeros + index_add_)
    of the gradient as apply_dtp_cm hands it (0 at the positions the table
    leaves out), both within float32 rounding of the float64 sum: per
    column, (terms + 1) units of 2^-24 of the sum of |terms|.  The kernel
    sums the kept positions only, and a second launch is bit-equal."""
    _need_cuda()
    from diffusion_edf_tpu_torch.nn import gather

    table = _gather_table(irreps, which)
    g = torch.randn(rows, table.idx.shape[0], generator=torch.Generator(device="cuda").manual_seed(0), device="cuda")
    before = gather.launches
    out = gather.gather_last_t(g, table)  # the left-out positions hold noise here: not summed
    again = gather.gather_last_t(g, table)
    assert gather.launches - before == 2
    assert torch.equal(out, again)
    g = g * _kept(table)
    zeros = torch.zeros(rows, table.width, dtype=torch.float64, device="cuda")
    ref = torch.zeros(rows, table.width, device="cuda").index_add_(-1, table.idx, g)
    exact = zeros.clone().index_add_(-1, table.idx, g.double())
    tol = (table.ptr[1:] - table.ptr[:-1] + 1).double() * 2.0**-24 * zeros.index_add_(-1, table.idx, g.double().abs())
    assert bool(((out.double() - exact).abs() <= tol).all())
    assert bool(((ref.double() - exact).abs() <= tol).all())
    if which == "C":
        assert torch.equal(out[:, -1], torch.zeros_like(out[:, -1]))


@pytest.mark.cuda
def test_gather_kernel_replays_in_a_cuda_graph():
    """A launch captured in a CUDA graph and replayed on new contents of its
    static input equals the eager launch on the same contents, bit for
    bit; the capture counts one launch and the replays none."""
    _need_cuda()
    from diffusion_edf_tpu_torch.nn import gather

    table = _gather_table("32x0e+16x1e+8x2e", "X")
    gen = torch.Generator(device="cuda").manual_seed(1)
    static = torch.randn(777, table.idx.shape[0], generator=gen, device="cuda")
    gather.gather_last_t(static, table)  # built and launched once outside the capture
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    graph = torch.cuda.CUDAGraph()
    before = gather.launches
    with torch.cuda.stream(side), torch.cuda.graph(graph):
        out = gather.gather_last_t(static, table)
    assert gather.launches - before == 1
    for _ in range(2):
        static.copy_(torch.randn(static.shape, generator=gen, device="cuda"))
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, gather.gather_last_t(static, table))
    assert gather.launches - before == 3  # the two eager launches of the loop


@pytest.mark.cuda
@pytest.mark.parametrize("ebm", [False, True], ids=["score", "critic"])
def test_train_step_launches_the_gather_kernel(tmp_path, ebm):
    """An eager train step on the card launches the kernel at least once for
    every apply_dtp_cm call (the backward of each call's gathers, and for
    the critic the second order); the key field's extraction under no_grad
    on the plain path calls apply_dtp_cm and launches nothing."""
    _need_cuda()
    from diffusion_edf_tpu_torch.nn import gather, tp_modules

    calls = [0]
    original = tp_modules.apply_dtp_cm

    def counted(*args, **kwargs):
        calls[0] += 1
        return original(*args, **kwargs)

    tr = _tiny_trainer(tmp_path, ebm, False, "gather")
    b = tr.batches[0]
    tp_modules.apply_dtp_cm = counted
    try:
        before = gather.launches
        tr.step(b)
        torch.cuda.synchronize()
        assert calls[0] > 0 and gather.launches - before >= calls[0]
        calls[0], before = 0, gather.launches
        tr.model.set_edge_impl("plain")
        with torch.no_grad():
            tr.model.get_key_pcd_multiscale(b.scene)
        assert calls[0] > 0 and gather.launches == before
    finally:
        tp_modules.apply_dtp_cm = original


# ---- csrc/gather.cu on long rows and few rows: IrrepsLinear's weight assembly ----

# pick_lowres's largest IrrepsLinear (the attention's sep_alpha_value): one row of 551,936 positions into 28,673
# columns, 52,224 of the positions kept
LINEAR_ALPHA_VALUE = ("64x0e+32x0e+16x0e+64x1e+32x1e+32x1e+32x1e+16x1e+16x1e+64x2e+32x2e+32x2e+16x2e+16x2e+16x2e",
                      "64x0e+112x0e+32x1e+16x2e")


def _long_row_case(case, dtype):
    """``(table, rows)`` of a gather with long rows or few of them: the
    largest linear layer's weight table, one row; one random row of 64 KB
    and one element (random columns, seven positions in ten reading the
    last, left out); three rows of apply_dtp_cm's X table."""
    from diffusion_edf_tpu_torch.nn import gather
    from diffusion_edf_tpu_torch.nn.layers import IrrepsLinear

    like = torch.zeros(0, dtype=dtype, device="cuda")
    if case == "linear":
        return IrrepsLinear(*LINEAR_ALPHA_VALUE).gather_tables(False, like)[0], 1
    if case == "few_rows":
        return _gather_table("32x0e+16x1e+8x2e", "X"), 3
    P = 64 * 1024 // like.element_size() + 1
    rng = np.random.default_rng(7)
    idx = np.where(rng.random(P) < 0.7, 3000, rng.integers(0, 3000, size=P))
    return gather.gather_table(("test_long_row", P), lambda: idx, 3001, like, lambda: idx != 3000), 1


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("case", ["linear", "random_row", "few_rows"])
def test_gather_kernel_on_long_rows_matches_plain(case, dtype):
    """The kernel and ``gather_last_t_plain`` against the float64 sum of the
    kept positions, each within (terms + 1) units of the dtype's rounding
    of the sum of |terms| in every column (for float64, the reference's own
    rounding); an empty segment (the left-out zero column, where the table
    has one) exactly 0; two launches bit-equal, both counted."""
    _need_cuda()
    from diffusion_edf_tpu_torch.nn import gather

    table, rows = _long_row_case(case, dtype)
    g = torch.randn(rows, table.idx.shape[0], generator=torch.Generator(device="cuda").manual_seed(0), device="cuda",
                    dtype=dtype)
    before = gather.launches
    out = gather.gather_last_t(g, table)  # g is not 0 where left out: the kernel must not read there
    again = gather.gather_last_t(g, table)
    assert gather.launches - before == 2
    assert torch.equal(out, again)
    plain = gather.gather_last_t_plain(g, table)
    kept = g * _kept(table)
    exact = torch.zeros(rows, table.width, dtype=torch.float64, device="cuda").index_add_(-1, table.idx, kept.double())
    unit = 2.0**-24 if dtype == torch.float32 else 2.0**-52
    tol = (table.ptr[1:] - table.ptr[:-1] + 1).double() * unit * torch.zeros_like(exact).index_add_(
        -1, table.idx, kept.double().abs())
    for got in (out, plain):
        assert bool(((got.double() - exact).abs() <= tol).all())
    empty = table.ptr[1:] == table.ptr[:-1]
    assert bool(empty[-1]) == (case != "few_rows") and bool((out[:, empty] == 0).all())


@pytest.mark.cuda
def test_captured_linear_gradients_replay_bit_equal():
    """Every weight and bias gather of ``pick_lowres``'s linear layers (in
    their permuted layouts, as the train step runs them), forward and
    backward on fixed gradients of ``W`` and ``bias``, captured in one CUDA
    graph: two replays give bit-equal parameter gradients, the capture
    launches the kernel once for each gather of a parameter
    (245), and the gradients are within float32 rounding of the exact
    sum.  The whole train step is not bit-reproducible (the neighbour
    gather's ``index_add_`` sums in no fixed order), so the gradients of
    ``W`` are held fixed here."""
    _need_cuda()
    from diffusion_edf_tpu_torch.nn import gather
    from diffusion_edf_tpu_torch.nn.layers import IrrepsLinear
    from diffusion_edf_tpu_torch.train.factory import build_score_model
    from diffusion_edf_tpu_torch.train.trainer import load_configs

    cfg = load_configs(os.path.join(CONFIGS, "pick_lowres"))[2]
    model = init_params(build_score_model(cfg["model_name"], cfg["model_kwargs"]), torch.Generator().manual_seed(0))
    layers = [m for m in model.cuda().modules() if isinstance(m, IrrepsLinear) and (m.w_names or m.b_names)]
    gen = torch.Generator(device="cuda").manual_seed(2)
    cotangents = [(torch.randn(m.irreps_in.dim, m.irreps_out.dim, generator=gen, device="cuda"),
                   torch.randn(m.irreps_out.dim, generator=gen, device="cuda")) for m in layers]

    def step():
        out = []
        for m, (gW, gb) in zip(layers, cotangents):
            W, bias = m._gather(True)
            outs, cots = zip(*[(t, c) for t, c in ((W, gW), (bias, gb)) if t.requires_grad])
            out += torch.autograd.grad(outs, list(m.parameters()), cots)
        return out

    step()  # tables built, kernels loaded
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    graph = torch.cuda.CUDAGraph()
    before = gather.launches
    with torch.cuda.stream(side), torch.cuda.graph(graph):
        grads = step()
    n_gathers = sum(bool(m.w_names) + bool(m.b_names) for m in layers)
    assert n_gathers == 245 and gather.launches - before == n_gathers
    graph.replay()
    first = [g.clone() for g in grads]
    graph.replay()
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(first, grads))
    named = iter(first)
    for m, (gW, gb) in zip(layers, cotangents):  # against index_select's backward, in float64
        got = {name: next(named) for name, _ in m.named_parameters()}
        for table, cot, parts in zip(m.gather_tables(True, gW), (gW, gb),
                                     ([(n, float(np.sqrt(k))) for n, k in m.w_names.values()],
                                      [(n, 1.0) for n in m.b_names.values()])):
            if not parts:
                continue
            kept = cot.reshape(-1) * _kept(table)
            exact = torch.zeros(table.width, dtype=torch.float64, device="cuda").index_add_(0, table.idx, kept.double())
            tol = (table.ptr[1:] - table.ptr[:-1] + 1).double() * 2.0**-23 * torch.zeros_like(exact).index_add_(
                0, table.idx, kept.double().abs())
            flat = torch.cat([got[n].reshape(-1) * scale for n, scale in parts])  # the params' scale undone
            assert bool(((flat.double() - exact[:-1]).abs() <= tol[:-1]).all())


@pytest.mark.cuda
def test_eager_train_step_gathers_linear_gradients_on_the_kernel(tmp_path):
    """One eager ``pick_lowres`` train step launches the kernel at least
    once for each of its linear layers' weight and bias gathers (131 and
    114; the launches on a 1-D gradient over a ``partial`` table, which no
    ``apply_dtp_cm`` gather has): ``IrrepsLinear``'s gradient comes from
    ``csrc/gather.cu``."""
    _need_cuda()
    from diffusion_edf_tpu_torch.nn import gather
    from diffusion_edf_tpu_torch.nn.layers import IrrepsLinear
    from diffusion_edf_tpu_torch.train.synthetic import make_synthetic_dataset
    from diffusion_edf_tpu_torch.train.trainer import DiffusionEdfTrainer

    tr = DiffusionEdfTrainer(os.path.join(CONFIGS, "pick_lowres"), log_dir=str(tmp_path / "log"), device="cuda",
                             seed=0, use_runtime=False)
    tr.init(make_synthetic_dataset(n_demos=1, seed=0), checkpoint=os.path.join(CHECKPOINTS, "pick_lowres.npz"))
    layers = [m for m in tr.model.modules() if isinstance(m, IrrepsLinear)]
    n_gathers = sum(bool(m.w_names) + bool(m.b_names) for m in layers)
    linear = [0]
    original = gather._launch

    def counted(g, table):
        linear[0] += g.dim() == 1 and table.partial
        return original(g, table)

    gather._launch = counted
    try:
        tr.step(tr.batches[0])
        torch.cuda.synchronize()
    finally:
        gather._launch = original
    assert n_gathers == 245 and linear[0] >= n_gathers


# ---- the sapien pick cascade (benchmark/configs/sapien_pick.json) through the runtime against eager ----


@pytest.mark.cuda
def test_sapien_cascade_replays_equal_eager_on_two_scenes(tmp_path):
    """The benchmark's sapien pick cascade at its published widths (a short
    schedule, 8 seeds): two requests on different scenes through the
    runtime (the first builds and captures every entry, the second replays
    them) against the same models run eagerly, to the bit, with equal K1
    launches, K1 launched on every lowres step, and the second scene's own
    keypoint weights in the graphs' key cloud.  A graph that kept the
    warm-up's keypoints or weights would answer the second scene with the
    first one's."""
    _need_cuda()
    import json
    import os

    import numpy as np

    from benchmark.harness import port, traffic
    from diffusion_edf_tpu_torch.agent import DiffusionEdfAgent
    from diffusion_edf_tpu_torch.graphs import launch_counts

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(root, "benchmark", "configs", "sapien_pick.json")) as f:
        cfg = json.load(f)
    dc = dict(cfg["diffusion_configs"], N_steps_list=[[6, 4], [4, 4]])
    with open(os.path.join(root, "benchmark", "traffic", "sapien_pick_serve.json")) as f:
        mix = dict(json.load(f), seeds_per_request=8)
    agent = port.build_agent(cfg, str(tmp_path), root, "cuda")
    prep = cfg["preprocess"]
    eager = DiffusionEdfAgent(agent.models, prep["preprocess_config"], prep["unprocess_config"], use_runtime=False)
    weights, sizes = [], None
    for k in range(2):
        scene, grasp, Ts = traffic.request(mix, 2**31 + 7, 0, k)
        runs = {}
        for a in (agent, eager):
            before = launch_counts()
            traj, _, _, info = a.sample(scene, grasp, Ts, generator=_gen(11 + k), **dc)
            torch.cuda.synchronize()
            runs[a is agent] = traj, tuple(x - y for x, y in zip(launch_counts(), before)), info
        (traj, launched, info), (etraj, elaunched, einfo) = runs[True], runs[False]
        assert np.array_equal(traj, etraj) and np.abs(traj[-1] - traj[0]).max() > 1e-3
        assert launched == elaunched and launched[0] >= sum(dc["N_steps_list"][0])
        assert info["key_points"] == einfo["key_points"] and info["key_points"][0] > 0
        (entry,) = agent._runtimes[0].entries["extract_key"].values()
        key = entry.program.out[0]
        weights.append(key.w[key.mask].cpu())
        if k == 0:
            sizes = [rt.cache_sizes() for rt in agent._runtimes]
    assert [rt.cache_sizes() for rt in agent._runtimes] == sizes  # the second request replayed only
    assert float(weights[0].max() - weights[0].min()) > 0.05  # seeded weights that spread
    assert not torch.equal(weights[0], weights[1])
