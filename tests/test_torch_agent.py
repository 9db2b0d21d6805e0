"""The port's agent end to end against the JAX agent, the port's config
copies, and the shipped pick and place checkpoints loading into the port with
exact keys and shapes.

End-to-end parity runs at temperature 0: the Langevin noise of the two
frameworks cannot match, and at temperature 0 the noise term is exactly
zero."""
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
import yaml

import __graft_entry__ as ge
from diffusion_edf_tpu.agent import DiffusionEdfAgent as JAgent
from diffusion_edf_tpu.agent import ModelBundle as JBundle
from diffusion_edf_tpu.train.data import PointCloud as JPC
from diffusion_edf_tpu.train.factory import build_score_model as j_build
from diffusion_edf_tpu_torch.agent import DiffusionEdfAgent as TAgent
from diffusion_edf_tpu_torch.agent import load_model_bundle
from diffusion_edf_tpu_torch.train.data import PointCloud as TPC
from diffusion_edf_tpu_torch.weights import flax_key, load_flat_params

from .test_torch_tables import torch_to_jax_params

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parents[1]

PREPROCESS = [
    dict(name="downsample", kwargs=dict(voxel_size=0.01, coord_reduction="average")),
    dict(name="rescale", kwargs=dict(rescale_factor=100.0)),
]
UNPROCESS = [dict(name="rescale", kwargs=dict(rescale_factor=0.01))]
DIFF_CFG = dict(
    N_steps_list=[[3, 3]],
    timesteps_list=[[0.04, 0.02]],
    temperatures_list=[[0.0, 0.0]],
    diffusion_schedules_list=[[[1.0, 0.15], [0.15, 0.02]]],
    log_t_schedule=True,
    time_exponent_temp=1.0,
    time_exponent_alpha=0.5,
)
POSE_GATE = 2e-2  # the f32 final-pose gate of bench.py


@pytest.fixture(scope="module")
def tiny_config_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("tinycfg")
    cfg = ge._model_config(tiny=True)
    (d / "train_configs.yaml").write_text(yaml.safe_dump(dict(model_config_file="score_model_configs.yaml")))
    (d / "task_configs.yaml").write_text(yaml.safe_dump(dict(task_type="pick")))
    (d / "score_model_configs.yaml").write_text(yaml.safe_dump(cfg))
    return str(d)


def _clouds(seed=0):
    rng = np.random.default_rng(seed)
    scene = rng.uniform(-0.12, 0.12, size=(220, 3)).astype(np.float32)
    grasp = rng.uniform(-0.05, 0.05, size=(60, 3)).astype(np.float32) + np.float32([0, 0, 0.1])
    return (scene, rng.uniform(0, 1, size=(220, 3)).astype(np.float32),
            grasp, rng.uniform(0, 1, size=(60, 3)).astype(np.float32))


def test_tiny_agent_sample_matches_jax(tiny_config_dir):
    tb = load_model_bundle(tiny_config_dir, device="cpu", n_scene_pad=256, n_grasp_pad=96, init_seed=3)
    cfg = ge._model_config(tiny=True)
    jb = JBundle(model=j_build(cfg["model_name"], cfg["model_kwargs"]), params=torch_to_jax_params(tb.model),
                 ang_mult=tb.ang_mult, lin_mult=tb.lin_mult, n_scene_pad=256, n_grasp_pad=96)
    sp, sc, gp, gc = _clouds()
    Ts_init = np.asarray([[1.0, 0, 0, 0, 0.0, 0.02, 0.1], [0.7071068, 0, 0.7071068, 0, 0.03, -0.02, 0.08]])

    traj_t, scene_t, _, info = TAgent([tb], PREPROCESS, UNPROCESS).sample(
        TPC(sp, sc), TPC(gp, gc), Ts_init, generator=torch.Generator().manual_seed(0), **DIFF_CFG)
    traj_j, scene_j, _, _ = JAgent([jb], PREPROCESS, UNPROCESS).sample(
        JPC(sp, sc), JPC(gp, gc), Ts_init, key=jax.random.PRNGKey(0), **DIFF_CFG)
    np.testing.assert_allclose(scene_t.points, scene_j.points, atol=1e-4)
    assert traj_t.shape == traj_j.shape == (7, 2, 7)
    drift = float(np.abs(traj_t[-1] - np.asarray(traj_j[-1])).max())
    print(f"tiny agent final-pose drift port vs JAX: {drift:.3g}")
    assert drift <= POSE_GATE
    np.testing.assert_allclose(np.linalg.norm(traj_t[-1, :, :4], axis=-1), 1.0, atol=1e-5)
    assert info["steps"] == [6]


def test_tiny_agent_evaluate_matches_jax(tiny_config_dir):
    """The whole slice: both packages' ``evaluate_agent`` on both agents, one
    small synthetic demo, the temperature-0 schedule.  The seed poses are the
    same draws, so the errors agree within the pose gate: with 3 seeds each
    demo's median and best are sample errors, the means all of them."""
    from diffusion_edf_tpu.eval import evaluate_agent as j_evaluate
    from diffusion_edf_tpu.train.synthetic import make_synthetic_demo as j_demo
    from diffusion_edf_tpu_torch.eval import evaluate_agent as t_evaluate
    from diffusion_edf_tpu_torch.train.synthetic import make_synthetic_demo as t_demo

    tb = load_model_bundle(tiny_config_dir, device="cpu", n_scene_pad=256, n_grasp_pad=96, init_seed=3)
    cfg = ge._model_config(tiny=True)
    jb = JBundle(model=j_build(cfg["model_name"], cfg["model_kwargs"]), params=torch_to_jax_params(tb.model),
                 ang_mult=tb.ang_mult, lin_mult=tb.lin_mult, n_scene_pad=256, n_grasp_pad=96)
    kw = dict(task_type="pick", n_seeds=3, diffusion_configs=DIFF_CFG, seed=0)
    small = dict(n_scene=240, n_grasp=90)  # within the pads after voxelisation
    rt = t_evaluate(TAgent([tb], PREPROCESS, UNPROCESS), [t_demo(1000, **small)], **kw)
    rj = j_evaluate(JAgent([jb], PREPROCESS, UNPROCESS), [j_demo(1000, **small)], **kw)
    assert rt.keys() == rj.keys() and rt["n_samples"] == rj["n_samples"] == 3
    pairs = [(rt[k]["mean"], rj[k]["mean"]) for k in ("trans_err_cm", "rot_err_deg")]
    pairs += [(rt["per_demo"][0][k], rj["per_demo"][0][k]) for k in
              ("trans_err_cm_median", "rot_err_deg_median", "best_trans_err_cm", "best_rot_err_deg")]
    drift = max(abs(a - b) for a, b in pairs)
    print(f"tiny agent evaluation, errors port vs JAX: {drift:.3g} (cm and deg)")
    assert drift <= POSE_GATE
    assert rt["success_rate"] == rj["success_rate"] and rt["per_demo"][0]["demo"] == rj["per_demo"][0]["demo"]


def test_agent_kernel_branch_matches_plain_on_cpu(tiny_config_dir):
    """``edge_impl='kernel'`` on CPU runs the kernel's plain version: same
    rollout as the module path, seeded noise included."""
    sp, sc, gp, gc = _clouds(1)
    Ts_init = np.asarray([[1.0, 0, 0, 0, 0.0, 0.0, 0.1]] * 3)
    cfg = dict(DIFF_CFG, temperatures_list=[[1.0, 1.0]])
    out = []
    for impl in ("plain", "kernel"):
        b = load_model_bundle(tiny_config_dir, device="cpu", n_scene_pad=256, n_grasp_pad=96, edge_impl=impl)
        out.append(TAgent([b], PREPROCESS, UNPROCESS).sample(
            TPC(sp, sc), TPC(gp, gc), Ts_init, generator=torch.Generator().manual_seed(5), **cfg)[0])
    assert np.abs(out[0] - out[1]).max() <= 1e-4
    assert np.abs(out[0][-1] - out[0][0]).max() > 1e-3  # the poses moved


CONFIG_FILES = ["train_configs.yaml", "task_configs.yaml", "score_model_configs.yaml"]


@pytest.mark.parametrize(
    "model,name",
    [pytest.param("panda_mug/pick_lowres", n, id=n) for n in CONFIG_FILES]
    + [pytest.param(f"panda_mug/{m}", n, id=f"{m}-{n}") for m in ("pick_highres", "pick_ebm", "place_lowres",
                                                                 "place_highres", "place_ebm") for n in CONFIG_FILES]
    + [pytest.param("panda_mug", n, id=n) for n in ("server.yaml", "preprocess.yaml")]
    + [pytest.param(f"sapien/{m}", n, id=f"sapien/{m}-{n}") for m in ("pick_lowres", "pick_highres")
       for n in CONFIG_FILES],
)
def test_port_config_copy_matches_reference(model, name):
    """The port carries its own copy of the pick and place models' config
    directories, of the family's serving configs, and of the sapien pick
    models' config directories."""
    rel = Path("configs") / model / name
    port, ref = ROOT / "diffusion_edf_tpu_torch" / rel, ROOT / "diffusion_edf_tpu" / rel
    assert port.read_bytes() == ref.read_bytes()


def test_port_agent_yaml_points_at_port_configs():
    """The port's ``agent.yaml`` differs from the JAX one only in the
    ``configs_root_dir`` prefix, which names the port's config copies."""
    rel = Path("configs") / "panda_mug" / "agent.yaml"
    port = (ROOT / "diffusion_edf_tpu_torch" / rel).read_text().splitlines()
    ref = (ROOT / "diffusion_edf_tpu" / rel).read_text().splitlines()
    assert len(port) == len(ref)
    changed = [(a, b) for a, b in zip(port, ref) if a != b]
    assert len(changed) == 6
    for a, b in changed:
        assert a == b.replace("diffusion_edf_tpu/configs/", "diffusion_edf_tpu_torch/configs/")


SHIPPED_CHECKPOINTS = [
    ("panda_mug/pick_lowres", 939),
    ("panda_mug/pick_highres", None),
    ("panda_mug/pick_ebm", None),
    ("panda_bottle/pick_lowres", None),
    ("panda_bowl/pick_lowres", None),
    ("panda_mug/place_lowres", 1935),  # 998 of them under params/query_model
    ("panda_mug/place_highres", 1935),
    ("panda_mug/place_ebm", 1927),
    ("panda_bowl/place_lowres", None),
    # critics trained further from pick_ebm / place_ebm: the same model, the same keys
    ("panda_mug/pick_ebm_fine", 934),
    ("panda_mug/pick_ebm_cascade", 934),
    ("panda_mug/place_ebm_cascade", 1927),
    ("sapien/pick_lowres", 1034),  # PointAttentiveScoreModel
]
CONFIG_OF = {"panda_mug/pick_ebm_fine": "panda_mug/pick_ebm", "panda_mug/pick_ebm_cascade": "panda_mug/pick_ebm",
             "panda_mug/place_ebm_cascade": "panda_mug/place_ebm"}


@pytest.mark.parametrize("name,n_keys", SHIPPED_CHECKPOINTS)
def test_shipped_checkpoint_loads(name, n_keys):
    path = str(ROOT / "checkpoints" / f"{name}.npz")
    with np.load(path) as z:
        flat = {k: z[k] for k in z.files}
    params = {k for k in flat if not k.startswith("__")}
    if n_keys is not None:
        assert len(params) == n_keys
    b = load_model_bundle(str(ROOT / "diffusion_edf_tpu" / "configs" / CONFIG_OF.get(name, name)), path, device="cpu")
    keys = {flax_key(n)[0] for n, _ in b.model.named_parameters()}
    assert keys == params
    for n, p in b.model.named_parameters():
        key, idx = flax_key(n)
        arr = flat[key][idx] if idx else flat[key]
        np.testing.assert_array_equal(p.detach().numpy(), arr.astype(np.float32))
    # exact both ways: a missing, an unknown or a reshaped key is refused
    k0 = sorted(params)[0]
    for bad in ({k: v for k, v in flat.items() if k != k0}, dict(flat, **{"params/extra": np.zeros(1)}),
                dict(flat, **{k0: np.zeros((3, 3, 3))})):
        with pytest.raises((KeyError, ValueError)):
            load_flat_params(b.model, bad)
