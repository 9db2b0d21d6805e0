"""The port's evaluation harness against the JAX package's: the metric
functions on seeded inputs, ``evaluate_agent`` of both packages on one stub
agent (no rollout), and the port's command line on tiny seeded models.

The stub agent returns seeded poses near each demo's targets and ignores the
random key / generator, so both harnesses score the same samples."""
import json
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from diffusion_edf_tpu import eval as jeval
from diffusion_edf_tpu.train import synthetic as jsyn
from diffusion_edf_tpu.train.data import compose_proc_fn as j_proc
from diffusion_edf_tpu_torch import eval as teval
from diffusion_edf_tpu_torch.train import synthetic as tsyn
from diffusion_edf_tpu_torch.train.data import compose_proc_fn as t_proc
from diffusion_edf_tpu_torch.train.factory import build_score_model
from diffusion_edf_tpu_torch.weights import flat_arrays, init_params

from .test_torch_agent import PREPROCESS
from .test_torch_critic import _config_dir, _tiny_cfg

ROOT = Path(__file__).resolve().parents[1]


def _quats(rng, n):
    q = rng.normal(size=(n, 4))
    return q / np.linalg.norm(q, axis=-1, keepdims=True)


def test_pose_errors_match_jax():
    rng = np.random.default_rng(0)
    samples = np.concatenate([_quats(rng, 9), rng.normal(0, 3, (9, 3))], -1)
    targets = np.concatenate([_quats(rng, 4), rng.normal(0, 3, (4, 3))], -1)
    samples[3] = targets[1] + [0, 0, 0, 0, 0.2, 0, 0]  # a sample at a target
    j, t = jeval.pose_errors(samples, targets), teval.pose_errors(samples, targets)
    assert j.keys() == t.keys()
    for k in j:
        np.testing.assert_array_equal(j[k], t[k])
    assert abs(t["trans_err"][3] - 0.2) < 1e-12 and t["rot_err_deg"][3] < 1e-5


@pytest.mark.parametrize("center", [None, [0.3, -1.2, 0.5]], ids=["no-center", "center"])
def test_symmetry_orbit_matches_jax(center):
    rng = np.random.default_rng(1)
    targets = np.concatenate([_quats(rng, 3), rng.normal(0, 3, (3, 3))], -1)
    j, t = jeval._symmetry_orbit(targets, 72, center=center), teval._symmetry_orbit(targets, 72, center=center)
    assert t.shape == (3 * 72, 7)
    np.testing.assert_array_equal(j, t)


@pytest.mark.parametrize("n_stages", [1, 2])
def test_reference_inference_config_matches_jax(n_stages):
    assert teval.reference_inference_config(n_stages) == jeval.reference_inference_config(n_stages)


@pytest.mark.parametrize("report", ["schedule_sweep_pick_r2.json", "schedule_sweep_place.json"])
def test_to_diffusion_configs_matches_tools_copy(report):
    """The port's copy of ``tools/sweep_schedule.py::to_diffusion_configs``
    on every candidate of the committed sweep reports, one and two stages."""
    sys.path.insert(0, str(ROOT / "tools"))
    try:
        from sweep_schedule import to_diffusion_configs
    finally:
        sys.path.remove(str(ROOT / "tools"))
    sweep = json.loads((ROOT / "reports" / report).read_text())
    for c in sweep["candidates"]:
        for n in (1, 2):
            cand = {**c["schedule"], "name": c["name"]}
            assert teval.to_diffusion_configs(cand, n) == to_diffusion_configs(cand, n)


class StubAgent:
    """``models`` (only their number and device are read), ``proc_fn`` and a
    ``sample`` that returns, for the i-th call, seeded poses around demo i's
    processed target (rotated about world z through its symmetry centre by a
    seeded angle when ``spin``), and seeded ascending energies or constant
    ones.  The key or generator is ignored."""

    def __init__(self, proc_fn, targets, symmetry, n_models=2, energy=None, spin=False):
        self.models = [types.SimpleNamespace(device=torch.device("cpu"))] * n_models
        self.proc_fn, self.targets, self.symmetry = proc_fn, targets, symmetry
        self.energy, self.spin, self.calls = energy, spin, 0

    def sample(self, scene_pcd, grasp_pcd, Ts_init, record_trajectory=True, **_):
        rng = np.random.default_rng(100 + self.calls)
        T = np.asarray(self.targets[self.calls], dtype=np.float64)[0]
        sym = self.symmetry[self.calls]
        self.calls += 1
        n = len(Ts_init)
        if self.spin and sym:
            T = teval._symmetry_orbit(T[None], 360, center=sym.get("center"))[rng.integers(360)]
        q = T[:4] + rng.normal(0, 0.01, (n, 4))
        q /= np.linalg.norm(q, axis=-1, keepdims=True)
        x = T[4:] + rng.normal(0, 0.3, (n, 3))
        x[: n // 4] += 5.0  # some samples far off
        info = {}
        if self.energy == "seeded":
            info["energy"] = np.sort(rng.normal(size=n))
        elif self.energy == "constant":
            info["energy"] = np.full(n, 0.25)
        return np.concatenate([q, x], -1)[None].astype(np.float32), None, None, info


def _assert_reports_equal(a, b, path="report"):
    assert type(a) is type(b) or (isinstance(a, (int, float)) and isinstance(b, (int, float))), path
    if isinstance(a, dict):
        assert a.keys() == b.keys(), path
        for k in a:
            _assert_reports_equal(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, list):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_reports_equal(x, y, f"{path}[{i}]")
    elif isinstance(a, float):
        np.testing.assert_allclose(a, b, rtol=1e-12, atol=1e-12, err_msg=path)
    else:
        assert a == b, path


CASES = {
    "pick": dict(task="pick", family="mug"),
    "pick-declared-symmetry": dict(task="pick", family="bowl", spin=True),
    "place": dict(task="place", family="mug", spin=True),
    "critic": dict(task="pick", family="mug", energy="seeded"),
    "constant-energy": dict(task="place", family="bottle", energy="constant"),
    "explicit-orbit-undeclared-pick": dict(task="pick", family="mug", symmetry_orbit=36),
    "non-z-axis": dict(task="place", family="mug", axis=[1.0, 0.0, 0.0]),
}


def _stub_run(pkg, c, symmetry_orbit):
    """``evaluate_agent`` of ``pkg`` (``teval`` or ``jeval``) on case ``c``:
    its package's demos and preprocessing, a fresh stub."""
    proc, syn = (t_proc, tsyn) if pkg is teval else (j_proc, jsyn)
    demos = syn.make_split_dataset("default", n_demos=3, seed=1000, family=c["family"])
    step = 0 if c["task"] == "pick" else 1
    if "axis" in c:
        for seq in demos:
            seq[step].symmetry = dict(seq[step].symmetry, axis=c["axis"])
    proc_fn = proc(PREPROCESS)
    processed = [proc_fn(seq[step]) for seq in demos]
    agent = StubAgent(proc_fn, [d.target_poses for d in processed], [d.symmetry for d in processed],
                      energy=c.get("energy"), spin=c.get("spin", False))
    return pkg.evaluate_agent(agent, demos, task_type=c["task"], n_seeds=N_SEEDS, diffusion_configs={}, seed=3,
                              symmetry_orbit=symmetry_orbit)


N_SEEDS = 8


@pytest.mark.parametrize("case", list(CASES))
def test_evaluate_agent_matches_jax_on_a_stub(case):
    """Both harnesses on the same stub samples give the same report.  The
    reference's quirks hold in the port: an explicit ``symmetry_orbit`` is
    not applied to a pick demo that declares no symmetry (the report still
    records it); a constant-energy critic gives a Spearman correlation of 0;
    a symmetry axis other than world z fails the assert."""
    c = CASES[case]
    if "axis" in c:
        for pkg in (teval, jeval):
            with pytest.raises(AssertionError, match="world-z axis"):
                _stub_run(pkg, c, None)
        return
    rt, rj = (_stub_run(pkg, c, c.get("symmetry_orbit")) for pkg in (teval, jeval))
    _assert_reports_equal(rt, rj)
    assert rt["n_samples"] == 3 * N_SEEDS
    orbit = {"pick": 0, "pick-declared-symmetry": 72, "place": 72, "explicit-orbit-undeclared-pick": 36}
    if case in orbit:
        assert rt["symmetry_orbit"]["n"] == orbit[case]
    if case == "explicit-orbit-undeclared-pick":  # scored against the one target, as with the orbit off
        assert rt["per_demo"] == _stub_run(teval, c, None)["per_demo"]
    if case in ("pick-declared-symmetry", "place"):  # the spun samples succeed only against the orbit
        assert rt["success_rate"] >= 0.5
    if case == "critic":
        assert rt["energy_error_spearman_mean"] is not None and "executed_success_rate" in rt
    if case == "constant-energy":
        assert rt["energy_error_spearman_per_demo"] == [0.0] * 3


def test_main_writes_the_report_keys_of_the_jax_reports(tmp_path):
    """``main`` with every option of the committed cascade evaluations (a
    cascade, a critic, a sweep report's winner schedule, splits) on tiny
    seeded models on the CPU writes a report with the JAX reports' keys."""
    dirs, ckpts = {}, {}
    for name, ebm, seed in (("low", False, 3), ("high", False, 4), ("ebm", True, 5)):
        cfg = _tiny_cfg(ebm)
        dirs[name] = _config_dir(tmp_path, name, cfg)
        model = init_params(build_score_model(cfg["model_name"], cfg["model_kwargs"]),
                            torch.Generator().manual_seed(seed))
        ckpts[name] = str(tmp_path / f"{name}.npz")
        np.savez(ckpts[name], **flat_arrays(model))
    sweep = dict(winner="short", candidates=[dict(name="short", schedule=dict(
        steps=[2, 1, 1], dts=[0.04, 0.02, 0.01], temps=[1.0, 1.0, 0.0],
        scheds=[[1.0, 0.15], [0.15, 0.03], [0.03, 0.03]], split=1))])
    (tmp_path / "sweep.json").write_text(json.dumps(sweep))
    out = tmp_path / "report.json"
    teval.main([
        "--configs-root-dir", dirs["low"], "--checkpoint-dir", ckpts["low"],
        "--cascade-configs-root-dir", dirs["high"], "--cascade-checkpoint-dir", ckpts["high"],
        "--critic-configs-root-dir", dirs["ebm"], "--critic-checkpoint-dir", ckpts["ebm"],
        "--schedule-json", str(tmp_path / "sweep.json"), "--task-type", "pick",
        "--synthetic-demos", "1", "--n-seeds", "5", "--splits", "default", "--n-scene-pad", "1536",
        "--device", "cpu", "--out", str(out),
    ])
    report = json.loads(out.read_text())
    ref = json.loads((ROOT / "reports" / "eval_pick_cascade.json").read_text())
    assert set(report) == {"default"} and set(report) <= set(ref)
    assert report["default"].keys() == ref["default"].keys()
    assert report["default"]["per_demo"][0].keys() == ref["default"]["per_demo"][0].keys()
    assert report["default"]["per_demo"][0]["demo"] == ref["default"]["per_demo"][0]["demo"]
    assert report["default"]["n_samples"] == 5 and np.isfinite(report["default"]["trans_err_cm"]["mean"])
