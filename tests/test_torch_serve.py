"""The port's serving path on tiny models, on the CPU: request batching
(``sample_batch`` against ``sample``), the trajectory functions against the
JAX package's, the HTTP service (every endpoint, errors, batched dispatch,
a batching service's warm-up, concurrent unbatched calls) and
``build_service`` from a config family."""
import json
import threading
import urllib.error
import urllib.request
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

import __graft_entry__ as ge
from diffusion_edf_tpu.serve import trajectories as jtraj
from diffusion_edf_tpu_torch.agent import DiffusionEdfAgent, load_model_bundle
from diffusion_edf_tpu_torch.serve import AgentService, run_server
from diffusion_edf_tpu_torch.serve import trajectories as ttraj
from diffusion_edf_tpu_torch.serve.cli import build_service, warmup_service
from diffusion_edf_tpu_torch.train.data import PointCloud

from .test_torch_agent import PREPROCESS, UNPROCESS
from .test_torch_keypoint import _place_cfg

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parents[1]
COLD = dict(  # temperature 0: no noise, so concurrent and sequential calls must agree
    N_steps_list=[[2, 1], [1, 1]], timesteps_list=[[0.04, 0.02], [0.02, 0.01]],
    temperatures_list=[[0.0, 0.0], [0.0, 0.0]],
    diffusion_schedules_list=[[[1.0, 0.15], [0.15, 0.09]], [[0.09, 0.03], [0.03, 0.012]]],
    log_t_schedule=True, time_exponent_temp=1.0, time_exponent_alpha=0.5,
)
WARM = dict(COLD, temperatures_list=[[1.0, 1.0], [1.0, 0.0]])
PADS = dict(n_scene_pad=256, n_grasp_pad=96)


def _write_model(d: Path, cfg) -> str:
    d.mkdir(parents=True)
    (d / "train_configs.yaml").write_text(yaml.safe_dump(dict(model_config_file="score_model_configs.yaml")))
    (d / "task_configs.yaml").write_text(yaml.safe_dump(dict(task_type="pick")))
    (d / "score_model_configs.yaml").write_text(yaml.safe_dump(cfg))
    return str(d)


def _pick_cfg(ebm=False):
    cfg = ge._model_config(tiny=True)
    if ebm:
        cfg["model_kwargs"]["score_head_kwargs"].update(ebm=True, edge_time_encoding=False)
    return cfg


@pytest.fixture(scope="module")
def family(tmp_path_factory):
    """A tiny config family: pick (StaticKeypointModel) and place
    (KeypointExtractor) cascades of two stages with a critic each."""
    root = tmp_path_factory.mktemp("family")
    dirs = {name: _write_model(root / name, cfg) for name, cfg in (
        ("pick_lowres", _pick_cfg()), ("pick_highres", _pick_cfg()), ("pick_ebm", _pick_cfg(True)),
        ("place_lowres", _place_cfg()), ("place_highres", _place_cfg()), ("place_ebm", _place_cfg(True)))}
    item = lambda n, s: dict(configs_root_dir=dirs[n], checkpoint_dir=str(root / f"missing_{s}.npz"))  # noqa: E731
    agent_cfg = dict(model_kwargs=dict(
        pick_models_kwargs=[item("pick_lowres", 1), item("pick_highres", 2)], pick_critic_kwargs=item("pick_ebm", 3),
        place_models_kwargs=[item("place_lowres", 4), item("place_highres", 5)],
        place_critic_kwargs=item("place_ebm", 6)))
    server_cfg = dict(pick_diffusion_configs=COLD, place_diffusion_configs=COLD,
                      pick_trajectory_configs=dict(approach_len=0.1, n_steps=4),
                      place_trajectory_configs=dict(n_steps=3, dt=1e-4, cutoff_r=0.05, max_num_neighbors=20, eps=1e-4))
    (root / "agent.yaml").write_text(yaml.safe_dump(agent_cfg))
    (root / "server.yaml").write_text(yaml.safe_dump(server_cfg))
    (root / "preprocess.yaml").write_text(yaml.safe_dump(dict(preprocess_config=PREPROCESS,
                                                              unprocess_config=UNPROCESS)))
    return root, dirs


@pytest.fixture(scope="module")
def agents(family):
    _, dirs = family
    out = {}
    for task, seed in (("pick", 1), ("place", 4)):
        b = [load_model_bundle(dirs[f"{task}_{s}"], device="cpu", init_seed=seed + i, **PADS)
             for i, s in enumerate(("lowres", "highres", "ebm"))]
        out[task] = DiffusionEdfAgent(b[:2], PREPROCESS, UNPROCESS, critic=b[2])
    return out


def _request(seed, n_seeds=3):
    rng = np.random.default_rng(seed)
    scene = rng.uniform(-0.12, 0.12, size=(220, 3)).astype(np.float32)
    grasp = rng.uniform(-0.05, 0.05, size=(60, 3)).astype(np.float32) + np.float32([0, 0, 0.1])
    q = rng.normal(size=(n_seeds, 4))
    Ts = np.concatenate([q / np.linalg.norm(q, axis=-1, keepdims=True),
                         rng.uniform([-0.03, -0.03, 0.07], [0.03, 0.03, 0.11], (n_seeds, 3))], -1)
    return (PointCloud(scene, rng.uniform(0, 1, (220, 3))), PointCloud(grasp, rng.uniform(0, 1, (60, 3))),
            Ts.astype(np.float32))


def _payload(task, seed, n_seeds=2):
    scene, grasp, Ts = _request(seed, n_seeds)
    return {"task_type": task, "Ts_init": Ts.tolist(),
            "scene": {"points": scene.points.tolist(), "colors": scene.colors.tolist()},
            "grasp": {"points": grasp.points.tolist(), "colors": grasp.colors.tolist()}}


@pytest.mark.parametrize("task", ["pick", "place"])
def test_sample_batch_matches_sample(agents, task):
    """Two different requests in one batch give what two ``sample`` calls
    give (temperature 0, to 1e-5), energies sorted per request; one request
    with noise gives what ``sample`` gives under the same generator seed."""
    agent = agents[task]
    reqs = [_request(10), _request(11)]
    traj_b, info_b = agent.sample_batch([r[0] for r in reqs], [r[1] for r in reqs], np.stack([r[2] for r in reqs]),
                                        generator=torch.Generator().manual_seed(0), **COLD)
    assert traj_b.shape == (2, 3 + 1 + 2 + 1, 3, 7) and info_b["energy"].shape == (2, 3)
    for i, (scene, grasp, Ts) in enumerate(reqs):
        traj, _, _, info = agent.sample(scene, grasp, Ts, generator=torch.Generator().manual_seed(0), **COLD)
        np.testing.assert_allclose(traj_b[i], traj, atol=1e-5)
        np.testing.assert_allclose(info_b["energy"][i], info["energy"], atol=1e-5)
        assert np.all(np.diff(info_b["energy"][i]) >= 0)
    assert np.abs(traj_b[0, -1] - traj_b[1, -1]).max() > 1e-3  # the requests differ
    scene, grasp, Ts = reqs[0]
    one, info1 = agent.sample_batch([scene], [grasp], Ts[None], generator=torch.Generator().manual_seed(3), **WARM)
    ref, _, _, info = agent.sample(scene, grasp, Ts, generator=torch.Generator().manual_seed(3), **WARM)
    np.testing.assert_array_equal(one[0], ref)
    np.testing.assert_array_equal(info1["energy"][0], info["energy"])
    cold, _, _, _ = agent.sample(scene, grasp, Ts, generator=torch.Generator().manual_seed(3), **COLD)
    assert np.abs(cold[-1] - ref[-1]).max() > 1e-4  # the noise moved the poses


def test_trajectories_match_jax():
    rng = np.random.default_rng(0)
    for i in range(3):
        q = rng.normal(size=4)
        pose = np.concatenate([q / np.linalg.norm(q), rng.uniform(-0.2, 0.2, 3)])
        np.testing.assert_allclose(ttraj.compute_pre_pick_trajectory(pose, 0.1, 6),
                                   jtraj.compute_pre_pick_trajectory(pose, 0.1, 6), rtol=0, atol=1e-12)
        scene = pose[4:] + rng.normal(0, 0.05, (300, 3))
        grasp = rng.normal(0, 0.03, (80, 3))
        kw = dict(n_steps=5, dt=1e-4 * (i + 1), cutoff_r=0.05, eps=1e-4, max_num_neighbors=50)
        a = ttraj.compute_pre_place_trajectory(pose, scene, grasp, **kw)
        b = jtraj.compute_pre_place_trajectory(pose, scene, grasp, **kw)
        assert a.shape == (5, 7) and np.abs(a[0] - a[-1]).max() > 1e-3
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-12)


def _post(url, payload, timeout=600):
    req = urllib.request.Request(url, data=json.dumps(payload).encode(), headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return json.loads(r.read())


def _serve(service):
    httpd = run_server(service, host="127.0.0.1", port=0, block=False)
    return httpd, f"http://127.0.0.1:{httpd.server_address[1]}"


def _check_poses(traj, n_seeds):
    traj = np.asarray(traj)
    assert traj.shape == (3 + 1 + 2 + 1, n_seeds, 7) and np.isfinite(traj).all()
    np.testing.assert_allclose(np.linalg.norm(traj[-1, :, :4], axis=-1), 1.0, atol=1e-4)
    assert np.abs(traj[-1, :, 4:]).max() < 1.0  # metres on the wire, not centimetres


def test_http_endpoints(agents):
    service = AgentService(agents["pick"], agents["place"], dict(
        pick_diffusion_configs=COLD, place_diffusion_configs=COLD,
        pick_trajectory_configs=dict(approach_len=0.1, n_steps=4),
        place_trajectory_configs=dict(n_steps=3, cutoff_r=0.05, max_num_neighbors=20)))
    httpd, url = _serve(service)
    try:
        with urllib.request.urlopen(url + "/health") as r:
            assert json.loads(r.read()) == {"status": "ok"}
        with urllib.request.urlopen(url + "/get_configs") as r:
            assert json.loads(r.read())["pick_trajectory_configs"]["n_steps"] == 4
        assert _post(url + "/reconfigure", {"place_trajectory_configs": dict(n_steps=5, cutoff_r=0.05)})[
            "place_trajectory_configs"]["n_steps"] == 5
        for task, n_traj in (("pick", 4), ("place", 5)):
            out = _post(url + "/denoise", _payload(task, 20))
            _check_poses(out["trajectories"], 2)
            assert np.all(np.diff(out["energy"]) >= 0)
            out = _post(url + "/request_trajectories", _payload(task, 21))
            assert np.asarray(out["trajectories"]).shape == (2, n_traj, 7)
            _check_poses(out["denoise"]["trajectories"], 2)
            final = np.asarray(out["denoise"]["trajectories"])[-1]
            np.testing.assert_allclose(np.asarray(out["trajectories"])[:, -1], final, atol=1e-6)
        for bad in (lambda: urllib.request.urlopen(url + "/nowhere"), lambda: _post(url + "/nowhere", {})):
            with pytest.raises(urllib.error.HTTPError) as e:
                bad()
            assert e.value.code == 404 and "error" in json.loads(e.value.read())
        with pytest.raises(urllib.error.HTTPError) as e:  # no scene
            _post(url + "/denoise", {"task_type": "place", "Ts_init": [[1, 0, 0, 0, 0, 0, 0.1]]})
        assert e.value.code == 500 and "scene" in json.loads(e.value.read())["error"]
    finally:
        httpd.shutdown()


def test_batched_place_requests_one_dispatch(agents):
    """Four concurrent place requests go through one ``sample_batch`` call
    and each gets what it gets alone."""
    service = AgentService(None, agents["place"], dict(place_diffusion_configs=COLD),
                           batching=dict(max_batch=4, window_ms=2000))
    httpd, url = _serve(service)
    payloads = [_payload("place", 30 + i, n_seeds=1 + i % 2) for i in range(4)]
    results = [None] * 4
    try:
        threads = [threading.Thread(target=lambda i=i: results.__setitem__(i, _post(url + "/denoise", payloads[i])))
                   for i in range(4)]
        for th in threads:
            th.start()
        for th in threads:
            th.join()
    finally:
        httpd.shutdown()
    assert service.batch_stats == {"dispatches": 1, "requests": 4, "batched_requests": 4, "padded_requests": 0}
    alone = AgentService(None, agents["place"], dict(place_diffusion_configs=COLD))
    for p, out in zip(payloads, results):
        _check_poses(out["trajectories"], len(p["Ts_init"]))
        ref = alone.denoise(p)
        np.testing.assert_allclose(out["trajectories"], ref["trajectories"], atol=1e-6)
        np.testing.assert_allclose(out["energy"], ref["energy"], atol=1e-6)


def test_batched_padding_seeds_rank_last(agents):
    """A 3-seed request batched beside a 5-seed one is padded with two copies
    of its last seed.  With its lowest-energy seed placed last, the critic's
    sort must still return its three real seeds, each once, as it does alone."""
    alone = AgentService(None, agents["place"], dict(place_diffusion_configs=COLD))
    small, big = _payload("place", 60, n_seeds=3), _payload("place", 61, n_seeds=5)
    small["Ts_init"] = alone.denoise(small)["trajectories"][0][::-1]  # initial poses, best seed last
    service = AgentService(None, agents["place"], dict(place_diffusion_configs=COLD),
                           batching=dict(max_batch=2, window_ms=2000))
    results = [None, None]
    threads = [threading.Thread(target=lambda i=i, p=p: results.__setitem__(i, service.denoise(p)))
               for i, p in enumerate((small, big))]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    assert service.batch_stats == {"dispatches": 1, "requests": 2, "batched_requests": 2, "padded_requests": 0}
    for p, out in zip((small, big), results):
        ref = alone.denoise(p)
        np.testing.assert_allclose(out["trajectories"], ref["trajectories"], atol=1e-6)
        np.testing.assert_allclose(out["energy"], ref["energy"], atol=1e-6)
    final = np.asarray(results[0]["trajectories"])[-1]
    assert final.shape == (3, 7) and np.abs(final[:, None] - final[None]).max(-1)[np.triu_indices(3, 1)].min() > 1e-4


def test_warmed_batching_service_serves_a_lone_request_on_warm_entries(family):
    """A batching service warmed by ``warmup_service`` (through ``sample``)
    answers a lone 1-seed ``/denoise``, which its dispatcher runs through
    ``sample_batch`` of one request, on the entries the warm-up made: no
    runtime of the agent gains one."""
    _, dirs = family
    b = [load_model_bundle(dirs[f"pick_{s}"], device="cpu", init_seed=7 + i, **PADS)
         for i, s in enumerate(("lowres", "highres", "ebm"))]
    agent = DiffusionEdfAgent(b[:2], PREPROCESS, UNPROCESS, critic=b[2])
    service = AgentService(agent, None, dict(pick_diffusion_configs=COLD), batching=dict(max_batch=2))
    warmup_service(service, n_points=64)
    runtimes = [*agent._runtimes, agent._critic_runtime]
    before = [rt.cache_sizes() for rt in runtimes]
    httpd, url = _serve(service)
    try:
        out = _post(url + "/denoise", _payload("pick", 70, n_seeds=1))
    finally:
        httpd.shutdown()
    _check_poses(out["trajectories"], 1)
    assert service.batch_stats == {"dispatches": 1, "requests": 1, "batched_requests": 1, "padded_requests": 0}
    after = [rt.cache_sizes() for rt in runtimes]
    assert after == before and all(sum(s.values()) for s in before)  # every runtime warmed, none grown


def test_concurrent_unbatched_calls_match_sequential(agents):
    """Two /denoise calls at once on an unbatched service (its lock keeps the
    device work on one thread at a time) give what the same calls give one
    after the other."""
    service = AgentService(agents["pick"], agents["place"], dict(pick_diffusion_configs=COLD,
                                                                 place_diffusion_configs=COLD))
    payloads = [_payload("place", 40), _payload("pick", 41)]
    sequential = [service.denoise(p) for p in payloads]
    httpd, url = _serve(service)
    concurrent = [None, None]
    try:
        threads = [threading.Thread(target=lambda i=i: concurrent.__setitem__(i, _post(url + "/denoise", payloads[i])))
                   for i in range(2)]
        for th in threads:
            th.start()
        for th in threads:
            th.join()
    finally:
        httpd.shutdown()
    for a, b in zip(concurrent, sequential):
        np.testing.assert_array_equal(np.asarray(a["trajectories"]), np.asarray(b["trajectories"]))
        np.testing.assert_array_equal(a["energy"], b["energy"])


def test_build_service_from_family(family):
    """``build_service`` reads agent.yaml / server.yaml / preprocess.yaml;
    the missing checkpoints fall back to seeded initial weights; the warm-up
    runs both agents; the config copies of the port's own family load."""
    root, _ = family
    service = build_service(str(root), device="cpu", batching=dict(max_batch=2), **PADS)
    assert service.batching == dict(max_batch=2) and service.agents["place"].critic is not None
    assert type(service.agents["place"].models[0].model.query_model).__name__ == "KeypointExtractor"
    warmup_service(service, n_points=64)
    out = service.denoise(_payload("pick", 50, n_seeds=1))
    _check_poses(out["trajectories"], 1)
    with open(ROOT / "diffusion_edf_tpu_torch" / "configs" / "panda_mug" / "agent.yaml") as f:
        shipped = yaml.safe_load(f)["model_kwargs"]
    dirs = [i["configs_root_dir"] for k, v in shipped.items() for i in (v if isinstance(v, list) else [v])]
    assert len(dirs) == 6 and all((ROOT / d / "score_model_configs.yaml").exists() for d in dirs)
