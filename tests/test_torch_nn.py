"""Port vs JAX package on the geometry and NN primitives at tiny widths:
the same seeded numpy inputs and the same parameters go through both, and
the outputs agree to 2e-5."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffusion_edf_tpu.geom import sh as jsh
from diffusion_edf_tpu.geom import so3 as jso3
from diffusion_edf_tpu.geom import wigner as jwig
from diffusion_edf_tpu.geom.irreps import Irreps
from diffusion_edf_tpu.nn import layers as jl
from diffusion_edf_tpu.nn import radial as jr
from diffusion_edf_tpu.nn import tp as jtp
from diffusion_edf_tpu.nn import tp_modules as jtm
from diffusion_edf_tpu.nn.blocks import FeedForwardNetwork as JFFN
from diffusion_edf_tpu.ops import neighbors as jnb
from diffusion_edf_tpu.train import data as jdata
from diffusion_edf_tpu_torch.geom import sh as tsh
from diffusion_edf_tpu_torch.geom import so3 as tso3
from diffusion_edf_tpu_torch.geom import wigner as twig
from diffusion_edf_tpu_torch.geom.irreps import Irreps as TIrreps
from diffusion_edf_tpu_torch.nn import layers as tl
from diffusion_edf_tpu_torch.nn import radial as tr
from diffusion_edf_tpu_torch.nn import tp as ttp
from diffusion_edf_tpu_torch.nn import tp_modules as ttm
from diffusion_edf_tpu_torch.nn.blocks import FeedForwardNetwork as TFFN
from diffusion_edf_tpu_torch.nn.tp import cm_input_perm, im_perm
from diffusion_edf_tpu_torch.ops import neighbors as tnb
from diffusion_edf_tpu_torch.train import data as tdata
from diffusion_edf_tpu_torch.weights import init_params

from .test_torch_tables import t, torch_to_jax_params

torch.set_num_threads(1)
ATOL = 2e-5
SH = "1x0e+1x1e+1x2e"


def _rng(seed=0):
    return np.random.default_rng(seed)


def _quats(rng, n):
    q = rng.normal(size=(n, 4))
    return (q / np.linalg.norm(q, axis=-1, keepdims=True)).astype(np.float32)


def _close(a, b, atol=ATOL):
    np.testing.assert_allclose(np.asarray(a), b.detach().cpu().numpy() if torch.is_tensor(b) else b, atol=atol)


def _pair(torch_module, flax_module, seed=0):
    """Seeded torch params, shared with the flax module: returns (torch
    module, flax apply fn)."""
    init_params(torch_module, torch.Generator().manual_seed(seed))
    params = torch_to_jax_params(torch_module)
    return torch_module, lambda *a, **kw: flax_module.apply(params, *a, **kw)


# ---- geometry ---------------------------------------------------------------
@pytest.mark.parametrize("irreps", [2, 3, SH, "1x0e+1x2e"])
def test_spherical_harmonics(irreps):
    v = _rng().normal(size=(20, 3)).astype(np.float32)
    _close(jsh.spherical_harmonics(irreps, jnp.asarray(v), eps=1e-4), tsh.spherical_harmonics(irreps, t(v), eps=1e-4))


@pytest.mark.parametrize("irreps", ["8x0e+4x1e+2x2e", "2x0e+1x1e+3x2e+1x3e"])
def test_rotate_irreps(irreps):
    rng = _rng(1)
    f = rng.normal(size=(5, Irreps(irreps).dim)).astype(np.float32)
    q = _quats(rng, 3)
    _close(jwig.rotate_irreps(Irreps(irreps), jnp.asarray(f), jnp.asarray(q)),
           twig.rotate_irreps(irreps, t(f), t(q)))


def test_so3_ops():
    rng = _rng(2)
    q, p = _quats(rng, 4), rng.normal(size=(4, 3)).astype(np.float32)
    Ts = np.concatenate([q, rng.normal(size=(4, 3)).astype(np.float32)], -1)
    pts = rng.normal(size=(6, 3)).astype(np.float32)
    _close(jso3.quaternion_apply(jnp.asarray(q), jnp.asarray(p)), tso3.quaternion_apply(t(q), t(p)))
    _close(jso3.quaternion_invert(jnp.asarray(q)), tso3.quaternion_invert(t(q)))
    _close(jso3.quaternion_to_matrix(jnp.asarray(q)), tso3.quaternion_to_matrix(t(q)))
    _close(jso3.normalize_quaternion(jnp.asarray(2 * q)), tso3.normalize_quaternion(t(2 * q)))
    _close(jso3.transform_points(jnp.asarray(pts), jnp.asarray(Ts)), tso3.transform_points(t(pts), t(Ts)))


# ---- radial -----------------------------------------------------------------
@pytest.mark.parametrize("ch", [(8, 16, 24), (16, 8, 8, 30)])
def test_radial_profile(ch):
    x = _rng(3).normal(size=(10, ch[0])).astype(np.float32)
    m, ref = _pair(tr.RadialProfile(ch), jr.RadialProfile(ch_list=ch))
    _close(ref(jnp.asarray(x)), m(t(x)))


def test_radial_bases():
    d = _rng(4).uniform(0, 6, size=(7, 5)).astype(np.float32)
    m, ref = _pair(tr.GaussianRadialBasisFiniteCutoff(16, 0.99 * 5.0),
                   jr.GaussianRadialBasisFiniteCutoff(num_basis=16, cutoff=0.99 * 5.0))
    _close(ref(jnp.asarray(d)), m(t(d)))
    m, ref = _pair(tr.GaussianRadialBasis(16, 5.0), jr.GaussianRadialBasis(dim=16, max_val=5.0))
    _close(ref(jnp.asarray(d)), m(t(d)))
    ref = jr.SinusoidalPositionEmbeddings(dim=16, max_val=100.0, n=1000.0)
    _close(ref(jnp.asarray(d)), tr.SinusoidalPositionEmbeddings(16, 100.0, n=1000.0)(t(d)), atol=1e-4)


# ---- layers -----------------------------------------------------------------
@pytest.mark.parametrize("irreps_in,irreps_out,perm", [
    ("8x0e+4x1e+2x2e", "6x0e+3x1e+1x2e", None),
    ("8x0e+4x1e+2x2e", "4x0e+2x1e+2x2e+1x1o", "out"),
    ("2x0e+3x1e+8x2e", "1x0e+6x2e", "in"),
])
def test_irreps_linear(irreps_in, irreps_out, perm):
    rng = _rng(5)
    ii, io = Irreps(irreps_in), Irreps(irreps_out)
    kw = {}
    if perm == "out":
        kw["output_perm"] = im_perm(io)
    if perm == "in":
        kw["input_perm"] = tuple(int(i) for i in rng.permutation(ii.dim))
    f = rng.normal(size=(9, ii.dim)).astype(np.float32)
    m, ref = _pair(tl.IrrepsLinear(ii, io, **kw), jl.IrrepsLinear(ii, io, **kw))
    _close(ref(jnp.asarray(f)), m(t(f)))
    if perm is None:  # the JAX layer materializes canonical layouts only
        W, b = m.materialize()
        Wj, bj = ref(None, materialize=True)
        _close(Wj, W)
        _close(bj, b)


@pytest.mark.parametrize("component_major", [False, True])
def test_gate(component_major):
    irreps = Irreps("8x0e+4x1e+2x2e")
    f = _rng(6).normal(size=(7, jl.GateFromIrreps.input_irreps(irreps).dim)).astype(np.float32)
    ref = jl.GateFromIrreps(irreps_out=irreps, component_major=component_major)
    _close(ref.apply({}, jnp.asarray(f)), tl.GateFromIrreps(irreps, component_major=component_major)(t(f)))


def test_equivariant_layer_norm():
    irreps = Irreps("8x0e+4x1e+2x2e")
    f = _rng(7).normal(size=(7, irreps.dim)).astype(np.float32)
    m, ref = _pair(tl.EquivariantLayerNorm(irreps), jl.EquivariantLayerNorm(irreps=irreps))
    with torch.no_grad():
        m.weight.uniform_(0.5, 1.5), m.bias.uniform_(-1, 1)
    ref = jl.EquivariantLayerNorm(irreps=irreps)
    params = torch_to_jax_params(m)
    _close(ref.apply(params, jnp.asarray(f)), m(t(f)))


def test_feed_forward():
    irreps = Irreps("8x0e+4x1e+2x2e")
    mid = Irreps("16x0e+8x1e+4x2e")
    f = _rng(8).normal(size=(7, irreps.dim)).astype(np.float32)
    m, ref = _pair(TFFN(irreps, irreps, mid), JFFN(irreps_in=irreps, irreps_out=irreps, irreps_mlp_mid=mid))
    _close(ref(jnp.asarray(f)), m(t(f)))


# ---- tensor products --------------------------------------------------------
@pytest.mark.parametrize("cm,x_cm", [(False, False), (True, False), (True, True)])
def test_depthwise_tp(cm, x_cm):
    rng = _rng(9)
    irreps = Irreps("8x0e+4x1e+2x2e")
    m = ttm.DepthwiseTP(irreps, SH, irreps)
    x = rng.normal(size=(11, irreps.dim)).astype(np.float32)
    attr = np.asarray(jsh.spherical_harmonics(SH, jnp.asarray(rng.normal(size=(11, 3)).astype(np.float32))))
    w = rng.normal(size=(11, m.weight_numel)).astype(np.float32)
    if x_cm:
        x = x[:, list(im_perm(irreps))]
    ref = jtm.DepthwiseTP(irreps_in=irreps, irreps_edge=Irreps(SH), irreps_out_target=irreps)
    out_j = ref.apply({}, jnp.asarray(x), jnp.asarray(attr), jnp.asarray(w), component_major=cm,
                      x_component_major=x_cm)
    _close(out_j, m(t(x), t(attr), t(w), component_major=cm, x_component_major=x_cm))
    if cm:  # the component-major lanes are a permutation of the canonical output
        can = m(t(x if not x_cm else x[:, np.argsort(im_perm(irreps))]), t(attr), t(w))
        _close(can[:, list(cm_input_perm(m.program))], m(t(x), t(attr), t(w), component_major=True,
                                                          x_component_major=x_cm))


def test_apply_fctp():
    rng = _rng(13)
    ins, edge, out = "4x0e+2x1e+1x2e", "2x0e+1x1e", "3x0e+2x1e"
    prog_j = jtp.fctp_instructions(Irreps(ins), Irreps(edge), Irreps(out))
    prog_t = ttp.fctp_instructions(TIrreps(ins), TIrreps(edge), TIrreps(out))
    x1 = rng.normal(size=(7, Irreps(ins).dim)).astype(np.float32)
    x2 = rng.normal(size=(7, Irreps(edge).dim)).astype(np.float32)
    w = rng.normal(size=(prog_j.weight_numel,)).astype(np.float32)
    _close(jtp.apply_fctp(prog_j, jnp.asarray(x1), jnp.asarray(x2), jnp.asarray(w)),
           ttp.apply_fctp(prog_t, t(x1), t(x2), t(w)))


@pytest.mark.parametrize("kind", ["value", "prescore"])
def test_separable_fctp(kind):
    rng = _rng(10)
    irreps = Irreps("8x0e+4x1e+2x2e")
    if kind == "value":  # the attention value path: i-major input, no activation
        args = dict(irreps_in=irreps, irreps_edge=Irreps(SH), irreps_out=irreps)
        x_cm = True
    else:  # the score head's twin TPs: edge irreps with mul > 1, gated
        args = dict(irreps_in=irreps, irreps_edge=Irreps("4x0e+2x1e+1x2e"), irreps_out=Irreps("1x0e+3x1e"),
                    use_activation=True)
        x_cm = False
    m, fn = _pair(ttm.SeparableFCTP(**args, x_component_major=x_cm),
                  jtm.SeparableFCTP(**args, internal_weights=True, x_component_major=x_cm))
    x = rng.normal(size=(9, irreps.dim)).astype(np.float32)
    e = rng.normal(size=(9, Irreps(args["irreps_edge"]).dim)).astype(np.float32)
    _close(fn(jnp.asarray(x), jnp.asarray(e)), m(t(x), t(e)))


# ---- neighbourhoods ---------------------------------------------------------
def _cloud(seed, n, n_valid):
    rng = _rng(seed)
    x = rng.uniform(-6, 6, size=(n, 3)).astype(np.float32)
    mask = np.zeros(n, bool)
    mask[:n_valid] = True
    x[n_valid:] = 1e6
    return x, mask


@pytest.mark.parametrize("mode", ["plain", "exclude_idx", "exclude_owner", "diagonal"])
def test_radius_neighbors(mode):
    src, smask = _cloud(11, 40, 33)
    dst, dmask = (src, smask) if mode == "diagonal" else _cloud(12, 15, 12)
    kw = {}
    if mode == "exclude_idx":
        kw["exclude_src_idx"] = np.arange(15) * 2
    if mode == "exclude_owner":
        kw["exclude_src_owner"] = np.arange(40) % 15
    if mode == "diagonal":
        kw["exclude_diagonal"] = True
    jidx, jval = jnb.radius_neighbors(jnp.asarray(src), jnp.asarray(dst), 4.0, 8, src_mask=jnp.asarray(smask),
                                      dst_mask=jnp.asarray(dmask),
                                      **{k: (jnp.asarray(v) if k != "exclude_diagonal" else v) for k, v in kw.items()})
    tidx, tval = tnb.radius_neighbors(t(src), t(dst), 4.0, 8, src_mask=torch.as_tensor(smask),
                                      dst_mask=torch.as_tensor(dmask),
                                      **{k: (torch.as_tensor(v) if k != "exclude_diagonal" else v)
                                         for k, v in kw.items()})
    jidx, jval, tidx, tval = map(np.asarray, (jidx, jval, tidx, tval))
    np.testing.assert_array_equal(jval.sum(-1), tval.sum(-1))
    for i in range(dst.shape[0]):  # compare neighbourhoods as sets, not slot order
        assert set(jidx[i][jval[i]]) == set(tidx[i][tval[i]])
    assert np.all(tidx[~tval] == 0)


def test_dense_neighbors():
    smask, dmask = np.arange(9) < 7, np.arange(4) < 3
    jidx, jval = jnb.dense_neighbors(9, 4, jnp.asarray(smask), jnp.asarray(dmask))
    tidx, tval = tnb.dense_neighbors(9, 4, torch.as_tensor(smask), torch.as_tensor(dmask))
    np.testing.assert_array_equal(np.asarray(jidx), tidx.numpy())
    np.testing.assert_array_equal(np.asarray(jval), tval.numpy())


@pytest.mark.parametrize("n_valid,m", [(30, 8), (5, 8)])
def test_farthest_point_sampling(n_valid, m):
    x, mask = _cloud(13, 30, n_valid)
    mask = np.roll(mask, 3)  # first valid point is not index 0
    jidx, jval = jnb.farthest_point_sampling(jnp.asarray(x), m, mask=jnp.asarray(mask))
    tidx, tval = tnb.farthest_point_sampling(t(x), m, mask=torch.as_tensor(mask))
    np.testing.assert_array_equal(np.asarray(jval), tval.numpy())
    jidx, tidx = np.asarray(jidx), tidx.numpy()
    np.testing.assert_array_equal(jidx[np.asarray(jval)], tidx[tval.numpy()])


# ---- host preprocessing -----------------------------------------------------
PREPROCESS = [
    dict(name="downsample", kwargs=dict(voxel_size=0.01, coord_reduction="average")),
    dict(name="randomize_hsl", kwargs=dict(hrange=0.05, srange=0.1, lrange=0.4, prob=0.75)),
    dict(name="pos_jitter", kwargs=dict(std=0.003, prob=0.9)),
    dict(name="color_jitter", kwargs=dict(std=0.03, prob=0.9)),
    dict(name="rescale", kwargs=dict(rescale_factor=100.0)),
]


def test_preprocess_and_pad():
    """Same seed -> same jitter draws; the voxel order of both paths is the
    sorted voxel key, so clouds compare point by point."""
    rng = _rng(14)
    pts = rng.uniform(-0.1, 0.1, size=(300, 3)).astype(np.float32)
    cols = rng.uniform(0, 1, size=(300, 3)).astype(np.float32)
    z = np.zeros((1, 7))
    jd = jdata.compose_proc_fn(PREPROCESS, seed=3)(
        jdata.TargetPoseDemo(jdata.PointCloud(pts, cols), jdata.PointCloud(pts[:50], cols[:50]), z))
    td = tdata.compose_proc_fn(PREPROCESS, seed=3)(
        tdata.TargetPoseDemo(tdata.PointCloud(pts, cols), tdata.PointCloud(pts[:50], cols[:50]), z))
    for a, b in ((jd.scene_pcd, td.scene_pcd), (jd.grasp_pcd, td.grasp_pcd)):
        np.testing.assert_allclose(a.points, b.points, atol=1e-4)
        np.testing.assert_allclose(a.colors, b.colors, atol=1e-5)
    jp, tp_ = jdata.pad_pointcloud(jd.scene_pcd, 320), tdata.pad_pointcloud(td.scene_pcd, 320)
    np.testing.assert_array_equal(np.asarray(jp.mask), tp_.mask.numpy())
    np.testing.assert_allclose(np.asarray(jp.x), tp_.x.numpy(), atol=1e-4)
