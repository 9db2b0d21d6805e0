"""The benchmark's ``sapien_pick`` cascade at tiny widths on the CPU: the
port's ``PointAttentiveScoreModel`` (the lowres stage: a
``KeypointExtractor`` key whose point weights scale the head's attention)
and its ``MultiscaleScoreModel`` on a ``ForwardOnlyFeatureExtractor`` key
(the highres stage) against the benchmark's plain reference
(``benchmark/reference/edf``), each built from the configuration's dicts
with the configuration's seeded weights; and the agent's ``agent.extract``
spans of that cascade.  Neither side imports JAX.

``tiny_sapien_config()`` is the configuration's file with tiny widths, a
tiny schedule and pads: its preprocessing (the translated crop box), its
stages, their classes and their seeds are the file's own."""
import copy
import json
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
GATE = 2e-5  # float32 at tiny widths, the gate of tests/test_torch_sapien.py against JAX

IRREPS = "8x0e+4x1e+2x2e"
SH = "1x0e+1x1e+1x2e"
_HEAD = dict(irreps_output=IRREPS, irreps_sh=SH, num_heads=2, fc_neurons=[-1, 16, 16], length_emb_dim=16, n_layers=1,
             irreps_mlp_mid=2, cutoff_method="edge_attn", r_mincut_nonscalar_sh=0.1, length_enc_max_r=100.0,
             alpha_drop=0.0)
_SCORE_HEAD = dict(max_time=1.0, time_emb_mlp=[32, 32, 16], ang_mult=2.5, lin_mult=15.0, edge_time_encoding=True,
                   query_time_encoding=False)
_QUERY = dict(irreps_output=IRREPS, keypoint_coords=[[0.0, -4.5, 10.0], [0.0, 4.5, 10.0]])
_EXTRACTOR = dict(irreps_input="3x0e", irreps_output=IRREPS, irreps_mlp_mid=2, alpha_drop=0.0,
                  n_layers_midstream=1)
TINY_MODELS = {
    "pick_lowres": dict(model_name="PointAttentiveScoreModel", model_kwargs=dict(
        score_head_kwargs=dict(_SCORE_HEAD, key_tensor_field_kwargs=dict(
            _HEAD, r_cluster_multiscale=[None], k_multiscale=[64])),  # no radius cut: every keypoint a slot
        key_kwargs=dict(
            weight_activation="sigmoid", weight_mult=None,
            keypoint_kwargs=dict(pool_ratio=0.05, weight_pre_emb_dim=8),
            feature_extractor_name="UnetFeatureExtractor",
            feature_extractor_kwargs=dict(
                _EXTRACTOR, irreps_emb=[IRREPS] * 2, irreps_edge_attr=[SH] * 2, num_heads=[2, 2],
                fc_neurons=[[16, 16]] * 2, n_layers=[1, 1], pool_ratio=[0.25, 0.25], radius=[3.0, None],
                k_pool=[8, 8], k_self=[8, 8], k_up=[6, 6]),
            tensor_field_kwargs=dict(irreps_output=IRREPS, irreps_sh=SH, num_heads=2, fc_neurons=[-1, 16, 16],
                                     length_emb_dim=16, r_cluster_multiscale=[5.0, 20.0], n_layers=1,
                                     irreps_mlp_mid=2, cutoff_method="edge_attn", k_multiscale=[8, 8],
                                     alpha_drop=0.0)),
        query_model="StaticKeypointModel", query_kwargs=_QUERY)),
    "pick_highres": dict(model_name="MultiscaleScoreModel", model_kwargs=dict(
        score_head_kwargs=dict(_SCORE_HEAD, key_tensor_field_kwargs=dict(
            _HEAD, r_cluster_multiscale=[6.0], k_multiscale=[16])),
        key_kwargs=dict(feature_extractor_name="ForwardOnlyFeatureExtractor", feature_extractor_kwargs=dict(
            _EXTRACTOR, n_scales=1, irreps_emb=[IRREPS], irreps_edge_attr=[SH], num_heads=[2],
            fc_neurons=[[16, 16]], n_layers=[3], pool_ratio=[0.25], radius=[3.0], k_pool=[8], k_self=[8],
            k_up=[6])),
        query_model="StaticKeypointModel", query_kwargs=_QUERY)),
}
TINY_DIFFUSION = dict(N_steps_list=[[3, 2], [2, 2]], timesteps_list=[[0.02, 0.02], [0.02, 0.02]],
                      temperatures_list=[[1.0, 1.0], [1.0, 1.0]])


def tiny_sapien_config():
    """``benchmark/configs/sapien_pick.json`` at tiny widths, schedule and pads."""
    with open(ROOT / "benchmark" / "configs" / "sapien_pick.json") as f:
        cfg = json.load(f)
    cfg.update(n_scene_pad=512, n_grasp_pad=128)
    cfg["diffusion_configs"].update(copy.deepcopy(TINY_DIFFUSION))
    for name, model in TINY_MODELS.items():
        assert cfg["models"][name]["score_model_configs"]["model_name"] == model["model_name"]
        cfg["models"][name]["score_model_configs"] = copy.deepcopy(model)
    return cfg


def tiny_request(seed: int = 7, n_scene: int = 400, n_grasp: int = 120, seeds: int = 4):
    """A pick request of the benchmark's traffic generator at a tiny size."""
    from benchmark.harness import traffic

    params = {"task": "pick", "seeds_per_request": seeds, "pose_spread_m": 0.05,
              "scene": {"family": "mug", "n_scene": n_scene, "n_grasp": n_grasp, "diverse": True}}
    return traffic.request(params, seed, 0, 0)


def _models(cfg, name):
    """(the port's model, the reference's model) of stage ``name``, each
    with the configuration's seeded weights, as the harness builds them."""
    from benchmark.reference.edf.train.factory import build_score_model as ref_build
    from benchmark.reference.edf.weights import init_params as ref_init
    from diffusion_edf_tpu_torch.train.factory import build_score_model
    from diffusion_edf_tpu_torch.weights import init_params

    m = cfg["models"][name]
    mc, seed = m["score_model_configs"], int(m["init_seed"])
    port = init_params(build_score_model(mc["model_name"], copy.deepcopy(mc["model_kwargs"])),
                       torch.Generator().manual_seed(seed)).eval()
    ref = ref_init(ref_build(mc["model_name"], copy.deepcopy(mc["model_kwargs"])),
                   torch.Generator().manual_seed(seed)).eval()
    return port, ref


def _poses(scene_x: torch.Tensor, n: int, seed: int) -> torch.Tensor:
    """(1, n, 7) poses (cm) whose gripper keypoints fall 4.5 cm from scene
    points, so that the 6-cm highres field keeps slots: the hand 10 cm
    below a scene point, half of them turned about z."""
    g = torch.Generator().manual_seed(seed)
    idx = torch.randint(0, scene_x.shape[0], (n,), generator=g)
    half = torch.rand(n, generator=g) * np.pi * (torch.arange(n) % 2)
    q = torch.stack([torch.cos(half / 2), torch.zeros(n), torch.zeros(n), torch.sin(half / 2)], -1)
    t = scene_x[idx] - torch.tensor([0.0, 0.0, 10.0])
    return torch.cat([q, t], -1)[None]


def _mean_weights(key):
    """The key cloud with every kept point's weight replaced by their mean."""
    kept = key.mask.to(key.w.dtype)
    mean = (key.w * kept).sum() / kept.sum()
    return key.replace(w=mean * kept)


def _prep(cfg, scene, grasp):
    """The request's clouds through the configuration's preprocessing."""
    from benchmark.reference.edf.train.data import TargetPoseDemo, compose_proc_fn

    demo = compose_proc_fn(cfg["preprocess"]["preprocess_config"])(
        TargetPoseDemo(scene_pcd=scene, grasp_pcd=grasp, target_poses=np.zeros((1, 7))))
    return demo.scene_pcd, demo.grasp_pcd


@pytest.mark.parametrize("name", ["pick_lowres", "pick_highres"])
def test_sapien_stage_matches_the_reference(name):
    """Key extraction (points, mask, features and, for the point-attentive
    key, the point weights) and the score of each stage on a preprocessed
    request, the port against the plain reference, to ``GATE`` of the
    largest value.  The lowres stage's seeded weights spread, and its score
    with the weights flattened to their mean misses the reference by more
    than the gate: a port that ignored them would fail."""
    from benchmark.reference.edf.data import stack_points as ref_stack
    from benchmark.reference.edf.train.data import pad_pointcloud as ref_pad
    from diffusion_edf_tpu_torch.data import stack_points
    from diffusion_edf_tpu_torch.train.data import pad_pointcloud

    cfg = tiny_sapien_config()
    port, ref = _models(cfg, name)
    scene, grasp, _ = tiny_request()
    scene_p, grasp_p = _prep(cfg, scene, grasp)
    with torch.no_grad():
        keys = port.get_key_pcd_multiscale(pad_pointcloud(scene_p, cfg["n_scene_pad"]))
        rkeys = ref.get_key_pcd_multiscale(ref_pad(scene_p, cfg["n_scene_pad"]))
        query = port.get_query_pcd(pad_pointcloud(grasp_p, cfg["n_grasp_pad"]))
        rquery = ref.get_query_pcd(ref_pad(grasp_p, cfg["n_grasp_pad"]))
    assert len(keys) == len(rkeys) == 1
    key, rkey = keys[0], rkeys[0]
    assert torch.equal(key.mask, rkey.mask) and int(key.mask.sum()) > 0
    fields = ("x", "f") + (("w",) if name == "pick_lowres" else ())
    for field in fields:
        a, b = getattr(key, field), getattr(rkey, field)
        torch.testing.assert_close(a, b, rtol=0, atol=GATE * max(1.0, float(b.abs().max())), msg=field)
    T = _poses(torch.as_tensor(np.asarray(scene_p.points, dtype=np.float32)), 6, seed=3)
    t = torch.full(T.shape[:2], 0.3 if name == "pick_lowres" else 0.05)

    def score(model, key_cloud, q, stack):
        with torch.no_grad():
            return model.score(T, [stack([key_cloud])], stack([q]), t)

    got, want = score(port, key, query, stack_points), score(ref, rkey, rquery, ref_stack)
    scale = max(1.0, *(float(w.abs().max()) for w in want))
    for a, b in zip(got, want):
        assert float(b.abs().max()) > 1e-3  # a score that moves the poses
        torch.testing.assert_close(a, b, rtol=0, atol=GATE * scale)
    if name == "pick_lowres":
        w = key.w[key.mask]
        assert float(w.max() - w.min()) > 0.05, w  # weights that spread
        flat = score(port, _mean_weights(key), query, stack_points)
        assert max(float((a - b).abs().max()) for a, b in zip(flat, want)) > 100 * GATE * scale


def test_extract_spans_carry_the_key_and_the_model(tmp_path):
    """A served sapien request through the port's runtime: each stage's
    ``agent.extract`` span names its score model's class and counts the
    points its key cloud keeps (the lowres key's FPS keypoints, the highres
    forward-only extractor's rows), and ``info["key_points"]`` holds the
    same counts, stage by stage."""
    from benchmark.harness import port
    from diffusion_edf_tpu_torch.utils import profiling

    cfg = tiny_sapien_config()
    agent = port.build_agent(cfg, str(tmp_path), str(ROOT), "cpu")
    assert agent.critic is None
    scene, grasp, Ts = tiny_request()
    profiling.drain()
    profiling.record(True)
    try:
        _, scene_p, _, info = agent.sample(scene, grasp, Ts, **cfg["diffusion_configs"])
        spans = [s for s in profiling.drain() if s.name == "agent.extract"]
    finally:
        profiling.record(False)
    spans.sort(key=lambda s: s.attrs["stage"])
    assert [s.attrs["model"] for s in spans] == ["PointAttentiveScoreModel", "MultiscaleScoreModel"]
    counts = [s.attrs["key_points"] for s in spans]
    assert info["key_points"] == counts
    assert scene_p.n > cfg["n_scene_pad"] // 4  # enough valid points to fill both keys
    assert counts[0] == int(np.ceil(0.05 * cfg["n_scene_pad"]))  # the FPS keypoints of the padded cloud
    assert counts[1] == cfg["n_scene_pad"] // 4  # the forward-only extractor's one scale: a quarter of it
    for rt, want in zip(agent._runtimes, counts):
        (entry,) = rt.entries["extract_key"].values()
        assert sum(int(k.mask.sum()) for k in entry.program.out) == want


def test_reply_metres_give_back_the_served_poses(tmp_path):
    """The reply's metres (``unprocess_poses``), through JSON and scaled
    back to centimetres as the benchmark's check reads them, are the
    program's float32 poses to the bit: the check's gaps then hold no
    rounding of the reply's unit."""
    import json as json_

    from benchmark.harness import port
    from benchmark.reference.serve_check import ReferenceModels

    cfg = tiny_sapien_config()
    agent = port.build_agent(cfg, str(tmp_path), str(ROOT), "cpu")
    scene, grasp, Ts = tiny_request(seeds=32)
    traj = agent.sample(scene, grasp, Ts, **cfg["diffusion_configs"])[0]
    assert traj.dtype == np.float32 and np.abs(traj[..., 4:]).max() > 10.0  # centimetres, tens of them
    reply = json_.loads(json_.dumps(agent.unprocess_poses(traj).tolist()))
    np.testing.assert_array_equal(ReferenceModels(cfg, str(ROOT), "cpu").to_model_units(reply), traj)
