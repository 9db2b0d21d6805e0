"""The port's ``importer.py`` against the JAX package's: the e3nn
convention tables and every converter bit-equal on the synthetic state
dicts of ``tests/test_importer.py``; every committed spec executed on the
synthetic reference-named state dict of ``tools/gen_import_spec.py`` gives
the JAX tool's arrays bit for bit; and an ``.npz`` that the port's command
line writes loads into the port with exact keys and scores within 2e-5 (of
max|score|) of the JAX model on the same file (tiny widths, CPU)."""
import glob
import json
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as ge
from diffusion_edf_tpu import importer as jimp
from diffusion_edf_tpu.agent import load_params_npz as j_load_npz
from diffusion_edf_tpu.models.data import FeaturedPoints as JFP
from diffusion_edf_tpu.train.factory import build_score_model as j_build
from diffusion_edf_tpu_torch import importer as timp
from diffusion_edf_tpu_torch.data import FeaturedPoints as TFP
from diffusion_edf_tpu_torch.data import stack_points
from diffusion_edf_tpu_torch.train.factory import build_score_model as t_build
from diffusion_edf_tpu_torch.weights import load_params_npz

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO / "tools"))
from gen_import_spec import convert_spec as j_convert_spec  # noqa: E402
from gen_import_spec import generate_spec, synth_state_dict  # noqa: E402

torch.set_num_threads(1)
IRR1, IRR_SH, IRR_OUT = "4x0e+2x1e+1x2e", "1x0e+1x1e+1x2e", "6x0e+3x1e+2x2e"


def _equal(a, b, where=""):
    if isinstance(a, dict):
        assert set(a) == set(b), where
        for k in a:
            _equal(a[k], b[k], f"{where}/{k}")
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=where)


@pytest.mark.parametrize("fn, args", [
    ("su2_clebsch_gordan", (1, 2, 2)), ("e3nn_w3j", (1, 1, 2)), ("e3nn_w3j", (2, 2, 1)), ("basis_e3nn_to_ours", (1,)),
    ("basis_e3nn_to_ours", (2,)), ("feature_basis_matrix", (IRR_OUT,)), ("path_sign", (1, 2, 2)),
    ("path_sign", (2, 2, 2)),
], ids=lambda v: v if isinstance(v, str) else "-".join(map(str, v)))
def test_convention_tables_match_jax(fn, args):
    _equal(getattr(timp, fn)(*args), getattr(jimp, fn)(*args))


def _synthetic_state_dicts():
    """The state dicts of ``tests/test_importer.py``, one per converter."""
    rng = np.random.default_rng(0)
    _, numel, _ = jimp._fctp_torch_instructions(jimp.Irreps(IRR1), jimp.Irreps("1x0e"), jimp.Irreps(IRR_OUT))
    yield "import_irreps_linear", {"tp.weight": rng.normal(size=(numel,)) * 0.2,
                                   "bias.0": rng.normal(size=(6,)) * 0.1}, ("", IRR1, IRR_OUT)
    from diffusion_edf_tpu.nn.tp import dtp_instructions, fctp_instructions

    prog = fctp_instructions(IRR1, IRR_SH, IRR_OUT)
    yield "import_fctp", {"tp.weight": rng.normal(size=(prog.weight_numel,)) * 0.2,
                          "bias.0": rng.normal(size=(6,)) * 0.1}, ("", IRR1, IRR_SH, IRR_OUT)
    prog = dtp_instructions(IRR1, IRR_SH, IRR_OUT)
    sd = {}
    chans = [8, 16, prog.weight_numel]
    for li, (cin, cout) in enumerate(zip(chans[:-1], chans[1:])):
        t = 3 * li
        sd[f"net.{t}.weight"] = rng.normal(size=(cout, cin)) * 0.3
        if li < len(chans) - 2:
            sd[f"net.{t}.bias"] = rng.normal(size=(cout,)) * 0.1
            sd[f"net.{t + 1}.weight"] = rng.normal(size=(cout,)) * 0.1 + 1.0
            sd[f"net.{t + 1}.bias"] = rng.normal(size=(cout,)) * 0.1
    sd["offset"] = rng.normal(size=(prog.weight_numel,)) * 0.05
    yield "import_dtp_radial_profile", sd, ("", IRR1, IRR_SH, IRR_OUT)
    yield "import_dtp_internal", {"tp.weight": rng.normal(size=(prog.weight_numel,)) * 0.2}, \
        ("", IRR1, IRR_SH, IRR_OUT)
    yield "import_gaussian_radial_basis", {"mean": rng.uniform(0, 1, (1, 8)), "std_logit": rng.normal(size=(1, 8)),
                                           "weight_logit": rng.normal(size=(1, 8))}, ("",)
    yield "import_equivariant_layer_norm", {"affine_weight": rng.normal(size=(1, 5)),
                                            "affine_bias": rng.normal(size=(3,))}, ("",)
    yield "import_dense", {"weight": rng.normal(size=(4, 3)), "bias": rng.normal(size=(4,))}, ("",)
    yield "import_torch_layer_norm", {"weight": rng.normal(size=(6,)), "bias": rng.normal(size=(6,))}, ("",)


@pytest.mark.parametrize("case", list(range(8)))
def test_converters_match_jax(case):
    name, sd, args = list(_synthetic_state_dicts())[case]
    _equal(getattr(timp, name)(sd, *args), getattr(jimp, name)(sd, *args), name)


SPECS = sorted(glob.glob(str(REPO / "tools" / "specs" / "panda_mug_*.json"))) + \
    sorted(glob.glob(str(REPO / "tools" / "specs" / "sapien_p*.json")))


@pytest.mark.parametrize("path", SPECS, ids=lambda p: Path(p).stem)
def test_spec_round_trip_matches_jax(path):
    with open(path) as f:
        spec = json.load(f)
    sd = synth_state_dict(spec, seed=3)
    _equal(timp.convert_spec(spec, sd), j_convert_spec(spec, sd), Path(path).stem)


def test_cli_npz_scores_as_jax(tmp_path):
    """The tiny model: a synthetic reference checkpoint through the port's
    command line (``--spec --out``) into both packages' models."""
    cfg = ge._model_config(tiny=True)
    spec = generate_spec(cfg)
    (tmp_path / "spec.json").write_text(json.dumps(spec))
    sd = synth_state_dict(spec, seed=5)
    torch.save({"epoch": 1, "steps": 2, "score_model_state_dict": {k: torch.as_tensor(v) for k, v in sd.items()}},
               tmp_path / "ckpt.pt")
    out = tmp_path / "params.npz"
    timp.main([str(tmp_path / "ckpt.pt"), "--spec", str(tmp_path / "spec.json"), "--out", str(out)])
    tmodel = load_params_npz(t_build(cfg["model_name"], cfg["model_kwargs"]), str(out))  # exact keys

    rng = np.random.default_rng(0)
    x = rng.uniform(-20, 20, (64, 3)).astype(np.float32)
    f = rng.uniform(0, 1, (64, 3)).astype(np.float32)
    q = rng.normal(size=(3, 4))
    Ts = np.concatenate([q / np.linalg.norm(q, axis=-1, keepdims=True), rng.uniform(-10, 10, (3, 3))], -1)
    Ts, time = Ts.astype(np.float32), np.full(3, 0.5, np.float32)
    with torch.no_grad():
        pcd = TFP(torch.as_tensor(x), torch.as_tensor(f), torch.ones(64, dtype=torch.bool))
        key_ms = [stack_points([p]) for p in tmodel.get_key_pcd_multiscale(pcd)]
        query = stack_points([tmodel.get_query_pcd(pcd)])
        tang, tlin = tmodel.score(torch.as_tensor(Ts)[None], key_ms, query, torch.as_tensor(time)[None])

    jmodel = j_build(cfg["model_name"], cfg["model_kwargs"])
    jscene = JFP(x=jnp.asarray(x), f=jnp.asarray(f), mask=jnp.ones(64, bool))
    template = jax.jit(jmodel.init)(jax.random.PRNGKey(0), jnp.asarray(Ts), jscene, jscene, jnp.asarray(time))
    params = j_load_npz(str(out), template)
    jang, jlin = jax.jit(lambda p: jmodel.apply(p, jnp.asarray(Ts), jscene, jscene, jnp.asarray(time)))(params)
    # the synthetic weights are O(1) per path, so the scores are O(100): held relative to their max
    scale = max(float(np.abs(np.asarray(a)).max()) for a in (jang, jlin))
    assert scale > 0
    np.testing.assert_allclose(tang[0].numpy(), np.asarray(jang), atol=2e-5 * scale)
    np.testing.assert_allclose(tlin[0].numpy(), np.asarray(jlin), atol=2e-5 * scale)
