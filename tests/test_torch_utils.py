"""The port's smaller modules against the JAX package's, at tiny widths on
the CPU: ``geom/parity.py``, ``visualize.py`` (the raw-dict path, plotly
being absent here), ``nn/radial.py::BesselBasis``, ``nn/tp_modules.py::
FullyConnectedTP`` and ``FullyConnectedTPSwishGate`` on the same parameters
(2e-5), and ``utils/profiling.py::trace`` writing a trace file."""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffusion_edf_tpu import visualize as jvis
from diffusion_edf_tpu.geom import parity as jparity
from diffusion_edf_tpu.nn.radial import BesselBasis as JBessel
from diffusion_edf_tpu.nn.tp_modules import FullyConnectedTP as JFCTP
from diffusion_edf_tpu.nn.tp_modules import FullyConnectedTPSwishGate as JGate
from diffusion_edf_tpu_torch import visualize as tvis
from diffusion_edf_tpu_torch.geom import parity as tparity
from diffusion_edf_tpu_torch.nn.radial import BesselBasis
from diffusion_edf_tpu_torch.nn.tp_modules import FullyConnectedTP, FullyConnectedTPSwishGate
from diffusion_edf_tpu_torch.utils.profiling import trace
from diffusion_edf_tpu_torch.weights import flat_arrays, init_params

from .test_torch_tables import torch_to_jax_params

torch.set_num_threads(1)
TOL = 2e-5


@pytest.mark.parametrize("irreps", ["1x0e+1x1e+1x2e", "2x0e+3x1o+1x2e+2x3o", "4x1e"])
def test_parity_matches_jax(irreps):
    rng = np.random.default_rng(0)
    np.testing.assert_array_equal(tparity.parity_sign_vector(irreps), jparity.parity_sign_vector(irreps))
    f = rng.normal(size=(5, len(tparity.parity_sign_vector(irreps)))).astype(np.float32)
    np.testing.assert_array_equal(tparity.parity_inversion_sh(irreps, torch.as_tensor(f)).numpy(),
                                  np.asarray(jparity.parity_inversion_sh(irreps, jnp.asarray(f))))


def test_visualize_matches_jax():
    rng = np.random.default_rng(1)
    pose = np.r_[np.array([0.9, 0.1, -0.3, 0.2]) / np.linalg.norm([0.9, 0.1, -0.3, 0.2]), [1.0, 2.0, 3.0]]
    for a, b in zip(tvis.pose_axes(pose, 0.5), jvis.pose_axes(pose, 0.5)):
        np.testing.assert_array_equal(a, b)
    args = (rng.normal(size=(20, 3)), rng.uniform(size=(20, 3)), rng.normal(size=(8, 3)), rng.uniform(size=(8, 3)),
            np.tile(pose, (3, 1)))
    t, j = tvis.visualize_pose(*args), jvis.visualize_pose(*args)
    assert isinstance(t, dict) and set(t) == set(j)
    np.testing.assert_array_equal(t["poses"], j["poses"])
    np.testing.assert_array_equal(t["scene_points"], j["scene_points"])


@pytest.mark.parametrize("max_cutoff", [False, True])
def test_bessel_basis_matches_jax(max_cutoff):
    x = np.linspace(0.0, 6.0, 50).astype(np.float32)
    jm = JBessel(dim=8, max_val=5.0, max_cutoff=max_cutoff)
    ref = jm.apply({}, jnp.asarray(x))
    out = BesselBasis(8, 5.0, max_cutoff=max_cutoff)(torch.as_tensor(x))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=TOL)


@pytest.mark.parametrize("cls, jcls, irreps_out", [
    (FullyConnectedTP, JFCTP, "4x0e+2x1e+1x2e"),
    (FullyConnectedTP, JFCTP, "3x1e"),
    (FullyConnectedTPSwishGate, JGate, "4x0e+2x1e+1x2e"),
    (FullyConnectedTPSwishGate, JGate, "5x0e"),
], ids=["fctp", "fctp_no_scalar", "fctp_gate", "fctp_gate_scalars"])
def test_fully_connected_tp_matches_jax(cls, jcls, irreps_out):
    """Seeded port weights (the scalar bias nonzero) through the flax key
    layout into the JAX module: the same output and the same keys."""
    irreps_in1, irreps_in2 = "3x0e+2x1e+1x2e", "1x0e+1x1e+1x2e"
    rng = np.random.default_rng(2)
    x1 = rng.normal(size=(6, 3 + 6 + 5)).astype(np.float32)
    x2 = rng.normal(size=(6, 9)).astype(np.float32)
    m = init_params(cls(irreps_in1, irreps_in2, irreps_out), torch.Generator().manual_seed(3))
    with torch.no_grad():
        for name, p in m.named_parameters():
            if name.endswith("bias"):
                p.copy_(torch.randn(p.shape, generator=torch.Generator().manual_seed(4)))
    jm = jcls(irreps_in1, irreps_in2, irreps_out)
    template = jm.init(jax.random.PRNGKey(0), jnp.asarray(x1), jnp.asarray(x2))
    params = torch_to_jax_params(m)
    assert set(flat_arrays(m)) == {"params/" + "/".join(k.key for k in path)
                                   for path, _ in jax.tree_util.tree_flatten_with_path(template["params"])[0]}
    ref = jm.apply(params, jnp.asarray(x1), jnp.asarray(x2))
    with torch.no_grad():
        out = m(torch.as_tensor(x1), torch.as_tensor(x2))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=TOL)


def test_trace_writes_a_trace(tmp_path):
    with trace(str(tmp_path / "t")) as prof:
        torch.ones(64, 64) @ torch.ones(64, 64)
    files = list((tmp_path / "t").glob("trace_*.json"))
    assert len(files) == 1
    events = json.loads(files[0].read_text())["traceEvents"]
    assert any("mm" in e.get("name", "") for e in events)
    assert len(prof.key_averages()) > 0
