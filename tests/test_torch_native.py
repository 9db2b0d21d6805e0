"""The port's native (C++) voxel downsample against its numpy path and the
JAX package's downsample, on seeded clouds (CPU, no JAX rollout)."""
import numpy as np
import pytest

from diffusion_edf_tpu.train import data as jax_data
from diffusion_edf_tpu_torch import native
from diffusion_edf_tpu_torch.train import data
from diffusion_edf_tpu_torch.train.synthetic import make_synthetic_demo

# the native library keeps float32 sums of float32 inputs, numpy float64 ones
TOL = 1e-6


def _clouds():
    rng = np.random.default_rng(0)
    yield "random", data.PointCloud(points=rng.uniform(-0.5, 0.5, (5000, 3)).astype(np.float32),
                                    colors=rng.uniform(0, 1, (5000, 3)).astype(np.float32))
    demo = make_synthetic_demo(1000)[0]
    yield "scene", demo.scene_pcd
    yield "grasp", demo.grasp_pcd


@pytest.mark.parametrize("reduction", ["average", "center"])
def test_native_voxel_downsample_matches_numpy(reduction):
    for name, pcd in _clouds():
        res = native.voxel_downsample(pcd.points, pcd.colors, 0.01, reduction)
        assert res is not None, "the native library did not build or load"
        ref = data._voxel_downsample_numpy(pcd, 0.01, reduction)
        assert res[0].shape == ref.points.shape, name
        np.testing.assert_allclose(res[0], ref.points, atol=TOL, err_msg=name)
        np.testing.assert_allclose(res[1], ref.colors, atol=TOL, err_msg=name)


@pytest.mark.parametrize("reduction", ["average", "center"])
def test_voxel_downsample_matches_jax(reduction):
    for name, pcd in _clouds():
        out = data._voxel_downsample(pcd, 0.01, reduction)
        ref = jax_data._voxel_downsample(jax_data.PointCloud(points=pcd.points, colors=pcd.colors), 0.01,
                                         reduction)
        np.testing.assert_array_equal(out.points, ref.points, err_msg=name)
        np.testing.assert_array_equal(out.colors, ref.colors, err_msg=name)
