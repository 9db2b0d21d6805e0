"""The geometry and the diffusion that training draws from, in the port
against the JAX package: SO(3) / SE(3) algebra and the IGSO(3) density and
score (to 1e-6, the truncated series to 1e-5), the IGSO(3) angle sampler
against the float64 density's CDF (Kolmogorov-Smirnov), neighbour counts
and contact-point sampling, and the diffusion of a target pose.

The frameworks' random streams never agree, so every sampler is compared
given its draws: the port's ``*_given`` function on the draws of its
``*_draws`` function against the JAX function itself, run eagerly with
``jax.random`` patched to hand it the same numbers (:func:`jax_draws`)."""
import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffusion_edf_tpu.diffusion import diffuse as jd
from diffusion_edf_tpu.geom import igso3 as jig
from diffusion_edf_tpu.geom import so3 as jso3
from diffusion_edf_tpu.models.data import FeaturedPoints as JFP
from diffusion_edf_tpu.ops import neighbors as jnb
from diffusion_edf_tpu_torch.data import FeaturedPoints as TFP
from diffusion_edf_tpu_torch.diffusion import diffuse as td
from diffusion_edf_tpu_torch.geom import igso3 as tig
from diffusion_edf_tpu_torch.geom import so3 as tso3
from diffusion_edf_tpu_torch.ops import neighbors as tnb

torch.set_num_threads(1)
EXACT = 1e-6  # float32 arithmetic in the same order, up to the libraries' last bits
SERIES = 1e-5  # the 101-term character sums, relative to their scale


@contextlib.contextmanager
def jax_draws(**queues):
    """Within the block, ``jax.random.<name>(...)`` returns the next array of
    ``queues[name]`` (checked against the shape asked for) instead of a
    draw: the JAX samplers run on given numbers."""
    queues = {k: [np.asarray(a) for a in v] for k, v in queues.items()}
    saved = {}

    def fake(name):
        def draw(key, *args, **kw):
            if name in ("uniform", "normal"):
                shape = kw.get("shape", args[0] if args else ())
            elif name == "categorical":
                shape = kw.get("shape")
            else:  # bernoulli(key, p, shape)
                shape = kw.get("shape", args[1] if len(args) > 1 else None)
            arr = queues[name].pop(0)
            assert tuple(arr.shape) == tuple(shape), (name, arr.shape, shape)
            return jnp.asarray(arr)
        return draw

    for name in queues:
        saved[name] = getattr(jax.random, name)
        setattr(jax.random, name, fake(name))
    try:
        yield
    finally:
        for name, fn in saved.items():
            setattr(jax.random, name, fn)
    assert not any(queues.values()), "the JAX code drew fewer numbers than were given"


def t(x):
    return torch.as_tensor(np.array(x))


def npy(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _small_scales(n):
    """Rotation angles for the series branches (below 1e-4) and above 0.3.
    Between the two, both packages form ``1 - cos(theta)`` in float32 and
    cancel it against a term of the same size (the coefficients of the SE(3)
    maps): a unit in the last place of the library's cosine moves the result
    far beyond 1e-6 there, so the two cannot be held to each other."""
    return np.concatenate([np.logspace(-9, -4.5, n - n // 2), np.logspace(-0.5, 0.4, n // 2)])[:, None]


def _quats(rng, n, small=False):
    q = rng.normal(size=(n, 4))
    if small:  # rotations near the identity
        q[:, 0] = np.abs(q[:, 0]) + 1.0
        q[:, 1:] *= _small_scales(n) / (2 * np.linalg.norm(q[:, 1:], axis=-1, keepdims=True) / q[:, :1])
    return (q / np.linalg.norm(q, axis=-1, keepdims=True)).astype(np.float32)


def _poses(rng, n):
    return np.concatenate([_quats(rng, n), rng.uniform(-10, 10, (n, 3)).astype(np.float32)], -1)


UNARY = ["standardize_quaternion", "quaternion_invert", "normalize_quaternion", "quaternion_to_matrix",
         "quaternion_to_axis_angle", "se3_invert", "se3_log_map"]


@pytest.mark.parametrize("name", UNARY)
@pytest.mark.parametrize("small", [False, True])
def test_so3_unary_matches_jax(name, small):
    rng = np.random.default_rng(0)
    q = _quats(rng, 64, small)
    x = np.concatenate([q, rng.uniform(-10, 10, (64, 3)).astype(np.float32)], -1) if name.startswith("se3") else q
    if name == "standardize_quaternion":
        x = x * np.where(rng.uniform(size=(64, 1)) < 0.5, -1, 1).astype(np.float32)
    np.testing.assert_allclose(npy(getattr(tso3, name)(t(x))), np.asarray(getattr(jso3, name)(jnp.asarray(x))),
                               rtol=EXACT, atol=EXACT * 10)


@pytest.mark.parametrize("small", [False, True])
def test_so3_maps_match_jax(small):
    rng = np.random.default_rng(1)
    n = 64
    w = rng.normal(size=(n, 3))
    if small:
        w *= _small_scales(n) / np.linalg.norm(w, axis=-1, keepdims=True)
    w = w.astype(np.float32)
    twist = np.concatenate([rng.uniform(-5, 5, (n, 3)).astype(np.float32), w], -1)
    for name, x in (("axis_angle_to_quaternion", w), ("se3_exp_map", twist)):
        np.testing.assert_allclose(npy(getattr(tso3, name)(t(x))), np.asarray(getattr(jso3, name)(jnp.asarray(x))),
                                   rtol=EXACT, atol=EXACT * 10, err_msg=name)
    R = np.asarray(jso3.quaternion_to_matrix(jnp.asarray(_quats(rng, n, small))))
    np.testing.assert_allclose(npy(tso3.matrix_to_quaternion(t(R))), np.asarray(jso3.matrix_to_quaternion(R)),
                               rtol=EXACT, atol=EXACT * 10)


def test_so3_products_match_jax():
    rng = np.random.default_rng(2)
    a, b = _quats(rng, 50), _quats(rng, 50)
    for name in ("quaternion_raw_multiply", "quaternion_multiply"):
        np.testing.assert_allclose(npy(getattr(tso3, name)(t(a), t(b))), np.asarray(getattr(jso3, name)(a, b)),
                                   rtol=EXACT, atol=EXACT)
    T1, T2 = _poses(rng, 50), _poses(rng, 50)
    np.testing.assert_allclose(npy(tso3.multiply_se3(t(T1), t(T2))), np.asarray(jso3.multiply_se3(T1, T2)),
                               rtol=EXACT, atol=EXACT * 10)
    np.testing.assert_allclose(npy(tso3.multiply_se3(t(T1[:1]), t(T2))), np.asarray(jso3.multiply_se3(T1[:1], T2)),
                               rtol=EXACT, atol=EXACT * 10)
    np.testing.assert_allclose(npy(tso3.se3_from_quat_trans(t(a), t(T1[:, 4:]))),
                               np.asarray(jso3.se3_from_quat_trans(a, T1[:, 4:])))
    # exp and log invert each other
    T = _poses(rng, 50)
    expect = np.concatenate([npy(tso3.standardize_quaternion(t(T[:, :4]))), T[:, 4:]], -1)
    np.testing.assert_allclose(npy(tso3.se3_exp_map(tso3.se3_log_map(t(T)))), expect, atol=2e-5)


def test_random_quaternions_are_unit_and_uniform():
    q = npy(tso3.random_quaternions(20000, torch.Generator().manual_seed(0)))
    assert q.shape == (20000, 4) and np.all(q[:, 0] >= 0)
    np.testing.assert_allclose(np.linalg.norm(q, axis=-1), 1.0, atol=1e-6)
    # uniform on SO(3): the rotation angle has density (1 - cos w) / pi, mean pi/2 + 2/pi
    angle = 2 * np.arccos(np.clip(q[:, 0], -1, 1))
    assert abs(angle.mean() - (np.pi / 2 + 2 / np.pi)) < 0.02


@pytest.mark.parametrize("eps", [0.01, 0.15, 1.0, 3.125])
def test_igso3_density_and_score_match_jax(eps):
    rng = np.random.default_rng(3)
    omg = np.linspace(1e-3, np.pi - 1e-3, 257).astype(np.float32)
    jdens = np.asarray(jig.igso3_angle_density(jnp.asarray(omg), eps))
    np.testing.assert_allclose(npy(tig.igso3_angle_density(t(omg), eps)), jdens, rtol=SERIES, atol=SERIES * jdens.max())
    q = _quats(rng, 128)
    q[:, 1:] *= np.linspace(0.05, 1.0, 128)[:, None].astype(np.float32)  # angles from small to large
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    # where the density is above 1e-3 of its peak: in the far tail the float32
    # sum of terms up to ~10 cancels to values below its own rounding (1e-6),
    # in both packages; the sampled angles lie in the bulk
    dens64 = jig.igso3_angle_density_np(2 * np.arccos(np.clip(q[:, 0], -1, 1)), eps, lmax=100)
    bulk = dens64 > 1e-3 * jig.igso3_angle_density_np(np.array([1e-4]), eps, lmax=100)[0]
    assert bulk.sum() >= 16
    jscore = np.asarray(jig.igso3_score(jnp.asarray(q), eps))[bulk]
    tscore = npy(tig.igso3_score(t(q), eps))[bulk]
    np.testing.assert_allclose(tscore, jscore, rtol=SERIES, atol=SERIES * np.abs(jscore).max())
    # the copied float64 oracles
    np.testing.assert_array_equal(tig.igso3_score_np(q, eps), jig.igso3_score_np(q, eps))
    np.testing.assert_array_equal(tig.igso3_angle_density_np(omg, eps), jig.igso3_angle_density_np(omg, eps))


def test_interp_matches_jnp_interp():
    xp = np.array([0.0, 0.0, 0.1, 0.1, 0.4, 0.9, 1.0, 1.0], np.float32)  # flat pieces and repeats
    fp = np.array([0.0, 0.1, 0.2, 0.3, 0.5, 0.7, 0.8, 0.9], np.float32)
    x = np.linspace(-0.2, 1.2, 301).astype(np.float32)
    np.testing.assert_allclose(npy(tig.interp(t(x), t(xp), t(fp))), np.asarray(jnp.interp(x, xp, fp)), rtol=0, atol=1e-7)


@pytest.mark.parametrize("eps", [0.01, 0.15, 1.0])
def test_igso3_angle_sampler_follows_the_float64_cdf(eps):
    """Kolmogorov-Smirnov distance of 20,000 sampled angles to the CDF of the
    float64 density times the Haar measure (trapezoids on 20,001 points):
    1.63 / sqrt(n) = 0.0115 is the 1 % critical value; the sampler's
    1024-point grid adds a little, so the bound is 0.015."""
    n = 20000
    q = tig.sample_igso3(eps, n, generator=torch.Generator().manual_seed(4))
    angle = np.sort(2 * np.arccos(np.clip(npy(q)[:, 0], -1.0, 1.0)))
    grid = np.linspace(0.0, np.pi, 20001)
    pdf = tig.igso3_angle_density_np(grid, eps, lmax=max(100, tig.determine_lmax(eps))) * (1 - np.cos(grid)) / np.pi
    cdf = np.concatenate([[0.0], np.cumsum(0.5 * (pdf[1:] + pdf[:-1]) * np.diff(grid))])
    cdf /= cdf[-1]
    F = np.interp(angle, grid, cdf)
    emp_hi, emp_lo = np.arange(1, n + 1) / n, np.arange(n) / n
    ks = max(np.max(emp_hi - F), np.max(F - emp_lo))
    print(f"IGSO(3) eps={eps}: KS distance {ks:.4f} (bound 0.015)")
    assert ks < 0.015


def _clouds(rng, n_src=80, n_dst=40, n_src_valid=70, n_dst_valid=33, scale=3.0):
    src = rng.uniform(-scale, scale, (n_src, 3)).astype(np.float32)
    dst = rng.uniform(-scale, scale, (n_dst, 3)).astype(np.float32)
    return src, dst, np.arange(n_src) < n_src_valid, np.arange(n_dst) < n_dst_valid


def test_count_within_radius_matches_jax():
    src, dst, sm, dm = _clouds(np.random.default_rng(5))
    for masks in ((None, None), (sm, dm)):
        j = np.asarray(jnb.count_within_radius(src, dst, 1.5, src_mask=masks[0], dst_mask=masks[1]))
        tt = npy(tnb.count_within_radius(t(src), t(dst), 1.5, *[None if m is None else t(m) for m in masks]))
        np.testing.assert_array_equal(tt, j)
        assert j.sum() > 0


def test_sample_reference_points_follows_the_counts():
    """Frequencies of 40,000 draws against the JAX package's neighbour-count
    weights (each frequency within 4 binomial standard deviations and 1e-3),
    and uniform over the valid points when nothing is in contact."""
    src, dst, sm, dm = _clouds(np.random.default_rng(6))
    counts = np.asarray(jnb.count_within_radius(src, dst, 1.5, src_mask=sm, dst_mask=dm)).astype(np.float64)
    g = torch.Generator().manual_seed(0)
    n = 40000
    for r, p in ((1.5, counts / counts.sum()), (1e-3, dm / dm.sum())):  # at r = 1e-3 no point is in contact
        x_ref, _ = td.sample_reference_points(t(src), t(dst), r, n, t(sm), t(dm), generator=g)
        idx = np.argmin(np.abs(npy(x_ref)[:, None, :] - dst[None]).sum(-1), axis=1)
        freq = np.bincount(idx, minlength=len(dst)) / n
        tol = 4 * np.sqrt(p * (1 - p) / n) + 1e-3
        assert np.all(np.abs(freq - p) <= tol), np.abs(freq - p).max()
        assert freq[~dm].sum() == 0.0
    w, _ = td.reference_point_weights(t(src), t(dst), 1e-3, t(sm), t(dm))
    np.testing.assert_array_equal(npy(w), dm.astype(np.float32))


def test_random_time_given_the_draw_matches_jax():
    u = np.array([0.0, 0.37, 0.999], np.float32)
    for t_min, t_max in ((0.15, 1.0), (0.01, 0.15), (0.03, 0.03)):
        for ui in u:
            with jax_draws(uniform=[ui[None]]):
                j = np.asarray(jd.random_time(jax.random.PRNGKey(0), t_min, t_max))
            np.testing.assert_allclose(npy(td.time_from_uniform(t(ui[None]), t_min, t_max)), j, rtol=EXACT)
    draws = [npy(td.random_time(0.01, 0.15, torch.Generator().manual_seed(i))) for i in range(200)]
    assert 0.01 <= min(draws) and max(draws) < 0.15


def _diffusion_draws(n, seed):
    d = tig.se3_gaussian_draws(n, torch.Generator().manual_seed(seed), torch.float32, "cpu")
    # JAX draws the translation, then the angle's uniform, then the axis
    return d, dict(normal=[npy(d["x"]), npy(d["axis"])], uniform=[npy(d["u"])])


@pytest.mark.parametrize("time", [0.01, 0.15, 0.6])
def test_diffuse_T_target_given_the_draws_matches_jax(time):
    rng = np.random.default_rng(7)
    T0 = _poses(rng, 1)
    x_ref = rng.uniform(-3, 3, (6, 3)).astype(np.float32)
    draws, jq = _diffusion_draws(6, seed=int(time * 100))
    with jax_draws(**jq):
        jout = jd.diffuse_T_target(jax.random.PRNGKey(0), jnp.asarray(T0), jnp.asarray(x_ref),
                                   jnp.asarray([time], jnp.float32), lin_mult=15.0, ang_mult=2.5)
    tout = td.diffuse_T_target_given(t(T0), t(x_ref), t(np.float32([time])), draws, lin_mult=15.0, ang_mult=2.5)
    _compare_diffusion(tout, jout)


def _compare_diffusion(tout, jout):
    (T, dT, tin, (a, l), (ar, lr)), (jT, jdT, jtin, (ja, jl), (jar, jlr)) = tout, jout
    for name, x, y in (("T", T, jT), ("delta_T", dT, jdT), ("time", tin, jtin), ("ang", a, ja), ("lin", l, jl),
                       ("ang_ref", ar, jar), ("lin_ref", lr, jlr)):
        y = np.asarray(y)
        np.testing.assert_allclose(npy(x), y, rtol=SERIES, atol=SERIES * max(1.0, np.abs(y).max()), err_msg=name)


def test_biequiv_diffusion_given_the_draws_matches_jax():
    """Contact points drawn from the grasp points near the scene moved into
    the grasp frame, then the diffusion about them."""
    rng = np.random.default_rng(8)
    grasp_x = rng.uniform(-2, 2, (40, 3)).astype(np.float32)
    T0 = _poses(rng, 1)
    T0[:, 4:] = 0.5
    # a scene that touches the grasp cloud once moved by T0
    scene_x = np.asarray(jso3.transform_points(jnp.asarray(grasp_x[:25] + 0.3), jnp.asarray(T0)))[0]
    scene_x = np.concatenate([scene_x, rng.uniform(20, 30, (15, 3)).astype(np.float32)])
    sm, gm = np.arange(40) < 38, np.arange(40) < 36
    tscene, tgrasp = TFP(x=t(scene_x), f=torch.zeros(40, 3), mask=t(sm)), TFP(x=t(grasp_x), f=torch.zeros(40, 3), mask=t(gm))
    jscene = JFP(x=jnp.asarray(scene_x), f=jnp.zeros((40, 3)), mask=jnp.asarray(sm))
    jgrasp = JFP(x=jnp.asarray(grasp_x), f=jnp.zeros((40, 3)), mask=jnp.asarray(gm))
    draws = td.biequiv_draws(t(T0), tscene, tgrasp, 10, 1.0, generator=torch.Generator().manual_seed(3))
    idx = npy(draws["ref_idx"])
    w, _ = td.reference_point_weights(td._scene_in_grasp_frame(t(T0), tscene.x), tgrasp.x, 1.0, tscene.mask, tgrasp.mask)
    assert npy(w)[idx].min() > 0 and npy(w).sum() > 0  # every drawn point is in contact
    with jax_draws(categorical=[idx], normal=[npy(draws["x"]), npy(draws["axis"])], uniform=[npy(draws["u"])]):
        jout = jd.biequiv_diffusion(jax.random.PRNGKey(0), jnp.asarray(T0), jnp.asarray([0.2], jnp.float32),
                                    jscene, jgrasp, ang_mult=2.5, lin_mult=15.0, n_samples_x_ref=10,
                                    contact_radius=1.0)
    tout = td.biequiv_diffusion_given(t(T0), t(np.float32([0.2])), tgrasp, draws, ang_mult=2.5, lin_mult=15.0)
    _compare_diffusion(tout, jout)


def test_samplers_are_their_given_functions_on_their_draws():
    """Each sampler is its ``*_given`` function on the numbers its draw
    function takes from the same generator state."""
    from diffusion_edf_tpu_torch.train import augment as taug
    from diffusion_edf_tpu_torch.train import ranking as trank

    rng = np.random.default_rng(9)
    T0, x_ref = t(_poses(rng, 2)), t(rng.uniform(-3, 3, (3, 3)).astype(np.float32))
    pts = TFP(x=t(rng.uniform(-5, 5, (30, 3)).astype(np.float32)), f=t(rng.uniform(0, 1, (30, 3)).astype(np.float32)),
              mask=t(np.arange(30) < 25))

    def gen():
        return torch.Generator().manual_seed(11)

    def same(a, b):
        for x, y in zip(jax.tree_util.tree_leaves(a), jax.tree_util.tree_leaves(b)):
            np.testing.assert_array_equal(npy(x), npy(y))

    cases = [
        (lambda: tig.sample_igso3(0.3, 6, gen()),
         lambda: tig.sample_igso3_given(tig.igso3_draws(6, gen(), torch.float32, "cpu"), 0.3)),
        (lambda: tig.sample_isotropic_se3_gaussian(0.3, 2.0, 6, gen()),
         lambda: tig.sample_isotropic_se3_gaussian_given(tig.se3_gaussian_draws(6, gen(), torch.float32, "cpu"), 0.3, 2.0)),
        (lambda: tig.diffuse_isotropic_se3(T0, 0.3, 2.0, x_ref=x_ref, generator=gen()),
         lambda: tig.diffuse_isotropic_se3_given(T0, 0.3, 2.0, tig.se3_gaussian_draws(6, gen(), torch.float32, "cpu"),
                                                 x_ref=x_ref)),
        (lambda: td.diffuse_T_target(T0, x_ref, t(np.float32([0.4])), 15.0, 2.5, generator=gen()),
         lambda: td.diffuse_T_target_given(T0, x_ref, t(np.float32([0.4])),
                                           tig.se3_gaussian_draws(6, gen(), torch.float32, "cpu"), 15.0, 2.5)),
        (lambda: td.biequiv_diffusion(T0[:1], 0.4, pts, pts, 2.5, 15.0, 4, 3.0, generator=gen()),
         lambda: td.biequiv_diffusion_given(T0[:1], 0.4, pts, td.biequiv_draws(T0[:1], pts, pts, 4, 3.0, gen()), 2.5, 15.0)),
        (lambda: taug.augment_batch(pts, pts, T0[:1], taug.AugmentConfig(), gen()),
         lambda: taug.augment_batch_given(pts, pts, T0[:1], taug.AugmentConfig(),
                                          taug.augment_draws(pts, pts, taug.AugmentConfig(), gen()))),
        (lambda: trank.sample_ranked_poses(T0[0], trank.RankConfig(n_negatives=5), gen()),
         lambda: trank.sample_ranked_poses_given(T0[0], trank.RankConfig(n_negatives=5),
                                                 trank.rank_draws(5, gen(), torch.float32, "cpu"))),
    ]
    for sampler, given in cases:
        a, b = sampler(), given()
        if isinstance(a, tuple) and a and isinstance(a[0], TFP):  # augment_batch
            a, b = [(p.x, p.f, p.mask) for p in a[:2]] + [a[2]], [(p.x, p.f, p.mask) for p in b[:2]] + [b[2]]
        same(a, b)
