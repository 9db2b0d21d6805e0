"""The port's native (C++) voxel downsample against its numpy path and the
JAX package's downsample, route by route, on seeded clouds (CPU, no JAX
rollout); and its build, made by two processes at once."""
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

import diffusion_edf_tpu.native as jax_native
from diffusion_edf_tpu.train import data as jax_data
from diffusion_edf_tpu_torch import native
from diffusion_edf_tpu_torch.train import data
from diffusion_edf_tpu_torch.train.synthetic import make_synthetic_demo

REPO = Path(__file__).resolve().parents[1]

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


def _jax_native_loaded(monkeypatch) -> bool:
    """The JAX package's library loaded in this process.  Its loader gives
    up for good after one failure (for instance a read while another process
    ran ``make`` on it), so reset its state and load again."""
    for _ in range(10):
        if jax_native.available():
            return True
        monkeypatch.setattr(jax_native, "_TRIED", False)
        monkeypatch.setattr(jax_native, "_LIB", None)
        time.sleep(1.0)
    return jax_native.available()


@pytest.mark.parametrize("route", ["native", "numpy"])
@pytest.mark.parametrize("reduction", ["average", "center"])
def test_voxel_downsample_matches_jax(route, reduction, monkeypatch):
    """Each route of the port bit-equal to the same route of the JAX
    package: the two native libraries (the same source), and the two numpy
    paths (the JAX one with its native call patched away)."""
    if route == "native":
        assert _jax_native_loaded(monkeypatch), "the JAX package's native library did not build or load"
    else:
        monkeypatch.setattr(jax_native, "voxel_downsample", lambda *a, **k: None)
    for name, pcd in _clouds():
        if route == "native":
            out = native.voxel_downsample(pcd.points, pcd.colors, 0.01, reduction)
            ref = jax_native.voxel_downsample(pcd.points, pcd.colors, 0.01, reduction)
            assert out is not None and ref is not None, name
        else:
            o = data._voxel_downsample_numpy(pcd, 0.01, reduction)
            r = jax_data._voxel_downsample(jax_data.PointCloud(points=pcd.points, colors=pcd.colors), 0.01,
                                           reduction)
            out, ref = (o.points, o.colors), (r.points, r.colors)
        np.testing.assert_array_equal(out[0], ref[0], err_msg=name)
        np.testing.assert_array_equal(out[1], ref[1], err_msg=name)


_BUILD = """
import json, sys
import numpy as np
sys.path.insert(0, sys.argv[1])
from diffusion_edf_tpu_torch import native
native._BUILD_DIR = native.Path(sys.argv[2])
rng = np.random.default_rng(0)
p, c = native.voxel_downsample(rng.uniform(-0.5, 0.5, (5000, 3)).astype(np.float32),
                               rng.uniform(0, 1, (5000, 3)).astype(np.float32), 0.01)
print(json.dumps({"so": native._LIB._name, "p": p.tolist(), "c": c.tolist()}))
"""


def test_native_build_is_race_free(tmp_path):
    """Two processes build the library into one empty directory at the same
    time: both load a whole library and give the same output, and only the
    hash-named library is left."""
    build = tmp_path / "build"
    procs = [subprocess.Popen([sys.executable, "-c", _BUILD, str(REPO), str(build)], stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True) for _ in range(2)]
    outs = []
    for p in procs:
        out, err = p.communicate(timeout=300)
        assert p.returncode == 0, err[-3000:]
        outs.append(json.loads(out.strip().splitlines()[-1]))
    assert outs[0] == outs[1]
    assert [f.name for f in build.iterdir()] == [Path(outs[0]["so"]).name]
