"""The port's model-building tools (``diffusion_edf_tpu_torch/tools/``)
against the JAX repository's ``tools/``, on the CPU at tiny widths:

* the sweep's candidate schedules and their diffusion configs, equal;
* the critic's noise-floor probe on seeded arrays, to 1e-6; both critic
  tools on one fabricated dump, warm-started from one ``.npz`` of JAX
  init: the epoch-0 held-out metrics equal, the held-out energies within
  2e-5, the same report and export keys; one fine-tune step, dropout off,
  the fans given to both, against ``jax.value_and_grad`` of the JAX tool's
  loss, within the tolerances of ``test_torch_train_step.py``;
* the ``gen_cascade_samples`` and ``sweep_schedule`` mains of both packages
  behind one stub agent (no rollout): the dumps and reports equal key for
  key;
* ``train_eval_loop`` for one epoch: the learning curve's keys those of
  ``reports/learning_curve_pick_lowres.jsonl``, the export read by the JAX
  ``load_params_npz`` with exact keys; ``k_truncation_report``'s rows;
* ``geom/wigner.py::wigner_D_from_quaternion`` against JAX; every config the
  port copied parses to the JAX file's dict and builds."""
import json
import sys
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from diffusion_edf_tpu import agent as jagent
from diffusion_edf_tpu.geom import wigner as jwigner
from diffusion_edf_tpu.models.data import FeaturedPoints as JFP
from diffusion_edf_tpu.train import ranking as jrank
from diffusion_edf_tpu.train import synthetic as jsyn
from diffusion_edf_tpu.train.data import PointCloud as JPC
from diffusion_edf_tpu.train.data import TargetPoseDemo as JDemo
from diffusion_edf_tpu.train.data import compose_proc_fn as j_proc
from diffusion_edf_tpu.train.factory import build_score_model as j_build
from diffusion_edf_tpu_torch import agent as tagent
from diffusion_edf_tpu_torch import eval as teval
from diffusion_edf_tpu_torch.geom import wigner as twigner
from diffusion_edf_tpu_torch.tools import gen_cascade_samples as tgen
from diffusion_edf_tpu_torch.tools import k_truncation_report as tkt
from diffusion_edf_tpu_torch.tools import sweep_schedule as tsweep
from diffusion_edf_tpu_torch.tools import train_critic_cascade as tcc
from diffusion_edf_tpu_torch.tools import train_eval_loop as tloop
from diffusion_edf_tpu_torch.train import synthetic as tsyn
from diffusion_edf_tpu_torch.train.data import TargetPoseDemo as TDemo
from diffusion_edf_tpu_torch.train.data import compose_proc_fn as t_proc
from diffusion_edf_tpu_torch.train.factory import build_score_model as t_build
from diffusion_edf_tpu_torch.train.ranking import RankConfig, sample_ranked_poses
from diffusion_edf_tpu_torch.weights import flat_arrays, init_params, load_params_npz

from .test_critic_cascade import _fake_dump, ebm_cfg_dir  # noqa: F401  (a fixture)
from .test_torch_tables import flatten_jax, torch_to_jax_params
from .test_torch_train import _config_dir
from .test_torch_train_step import TOLERANCES

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "tools"))
import gen_cascade_samples as jgen  # noqa: E402
import sweep_schedule as jsweep  # noqa: E402
import train_critic_cascade as jcc  # noqa: E402


# --------------------------------------------------------------------------- #
# schedules
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("which", ["candidate_schedules", "round2_schedules"])
def test_schedules_match_jax(which):
    for task in ("pick", "place"):
        cands = getattr(tsweep, which)(task)
        assert cands == getattr(jsweep, which)(task)
        for c in cands:
            for n in (1, 2):
                assert tsweep.to_diffusion_configs(c, n) == jsweep.to_diffusion_configs(c, n)
    assert tsweep.to_diffusion_configs is teval.to_diffusion_configs  # one copy in the port


# --------------------------------------------------------------------------- #
# the critic fine-tune
# --------------------------------------------------------------------------- #
def test_noise_floor_probe_matches_jax():
    rng = np.random.default_rng(4)
    b = [rng.uniform(0, 10, n) for n in (40, 24, 7)]
    for e in ([bb + rng.normal(0, 2.0, len(bb)) for bb in b], [rng.normal(size=len(bb)) for bb in b],
              [np.full(len(bb), 0.3) for bb in b]):
        t, j = tcc.noise_floor_probe(e, b), jcc.noise_floor_probe(e, b)
        assert t.keys() == j.keys()
        for k in t:
            np.testing.assert_allclose(t[k], j[k], atol=1e-6, err_msg=k)
    assert tcc.noise_floor_probe([np.zeros(5)], [np.arange(5.0)]) == {}


@pytest.fixture(scope="module")
def critic_files(ebm_cfg_dir, tmp_path_factory):  # noqa: F811
    """One fabricated train and eval dump, and the JAX tool's init of the
    tiny EBM saved as a flat ``.npz`` (the warm start of both tools)."""
    d = tmp_path_factory.mktemp("critic")
    rng = np.random.default_rng(0)
    files = dict(cfg=ebm_cfg_dir, train=str(d / "train.npz"), eval=str(d / "eval.npz"), init=str(d / "init.npz"))
    _fake_dump(files["train"], rng)
    _fake_dump(files["eval"], rng)
    train_cfg, _, model_cfg = (yaml.safe_load((Path(ebm_cfg_dir) / n).read_text())
                               for n in ("train_configs.yaml", "task_configs.yaml", "score_model_configs.yaml"))
    jmodel = j_build(model_cfg["model_name"], model_cfg["model_kwargs"], deterministic_fps=True)
    tr = jcc.load_dump(files["train"])
    scene = JFP(x=jnp.asarray(tr["scene_x"][0]), f=jnp.asarray(tr["scene_f"][0]), mask=jnp.asarray(tr["scene_mask"][0]))
    grasp = JFP(x=jnp.asarray(tr["grasp_x"][0]), f=jnp.asarray(tr["grasp_f"][0]), mask=jnp.asarray(tr["grasp_mask"][0]))
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(7), jnp.asarray(tr["samples"][0][:2]), scene, grasp,
                                  jnp.full((2,), 0.5))
    np.savez(files["init"], **flatten_jax(params))
    return files, jmodel, params, RankConfig(*jrank.RankConfig.from_dict(train_cfg["critic_rank_configs"]))


def _jax_energies(jmodel, params, d, i):
    def fwd(m, T, s, g):
        return m.energy(T, m.get_key_pcd_multiscale(s), m.get_query_pcd(g), jnp.ones((T.shape[0],), T.dtype))

    fp = {n: JFP(x=jnp.asarray(d[f"{n}_x"][i]), f=jnp.asarray(d[f"{n}_f"][i]), mask=jnp.asarray(d[f"{n}_mask"][i]))
          for n in ("scene", "grasp")}
    run = jax.jit(lambda p, T, s, g: jmodel.apply(p, T, s, g, method=fwd))
    return np.asarray(run(params, jnp.asarray(d["samples"][i]), fp["scene"], fp["grasp"]))


def test_critic_tools_match_jax(critic_files, tmp_path):
    """Both tools, one epoch from the same warm start: the epoch-0 metrics
    (before any step) equal, the held-out energies within 2e-5, and the
    report, its entries and the float16 export with the same keys."""
    files, jmodel, params, _ = critic_files
    out = {}
    for name, main, extra in (("jax", jcc.main, []), ("port", tcc.main, ["--device", "cpu"])):
        out[name] = (str(tmp_path / f"{name}.json"), str(tmp_path / f"{name}.npz"))
        main(["--configs-root-dir", files["cfg"], "--init-params-npz", files["init"],
              "--train-dump", files["train"], "--eval-dump", files["eval"], "--max-epochs", "1",
              "--eval-every", "1", "--fan-negatives", "4", "--export-best", out[name][1], "--out", out[name][0]]
             + extra)
    jrep, trep = (json.loads(Path(out[n][0]).read_text()) for n in ("jax", "port"))
    assert trep["epochs"][0] == jrep["epochs"][0]
    assert trep.keys() == jrep.keys() and trep["best"].keys() == jrep["best"].keys()
    assert [e.keys() for e in trep["epochs"]] == [e.keys() for e in jrep["epochs"]]
    assert trep["noise_floor"].keys() == jrep["noise_floor"].keys()
    with np.load(out["jax"][1]) as zj, np.load(out["port"][1]) as zt:
        assert set(zt.files) == set(zj.files) and "__meta__" in zt.files
        mj, mt = (json.loads(bytes(z["__meta__"]).decode()) for z in (zj, zt))
        assert mt.keys() == mj.keys() and mt["tool"] == "train_critic_cascade"
        assert all(zt[k].dtype == np.float16 for k in zt.files if k != "__meta__")
    model, _ = tcc.build_critic(files["cfg"], "cpu", files["init"])
    ev = tcc.load_dump(files["eval"])
    for i in range(ev["samples"].shape[0]):
        with torch.no_grad():
            e = tcc.energies(model, torch.as_tensor(ev["samples"][i]), *tcc.dump_clouds(ev, i, "cpu")).numpy()
        assert np.abs(e - _jax_energies(jmodel, params, ev, i)).max() <= 2e-5


def test_critic_step_matches_jax_value_and_grad(critic_files):
    """One step's loss (fan + cascade samples, half each) and gradient,
    dropout off on both sides, the port's fan given to the JAX loss: the
    critic's tolerances of ``test_torch_train_step.py``."""
    files, jmodel, params, rank_cfg = critic_files
    loss_rtol, grad_tol = TOLERANCES[True]
    model, _ = tcc.build_critic(files["cfg"], "cpu", files["init"])
    tr = tcc.load_dump(files["train"])
    scene, grasp = tcc.dump_clouds(tr, 1, "cpu")
    fan_Ts, fan_bad = sample_ranked_poses(torch.as_tensor(tr["target"][1]), RankConfig(n_negatives=4),
                                          torch.Generator().manual_seed(3))
    samples, badness = torch.as_tensor(tr["samples"][1]), torch.as_tensor(tr["badness"][1])
    loss, stats = tcc.step_loss(model, scene, grasp, samples, badness, fan_Ts, fan_bad, rank_cfg)
    params_t = list(model.parameters())
    grads = flat_arrays(model, torch.autograd.grad(loss, params_t))

    jrank_cfg = jrank.RankConfig(*rank_cfg)
    poses = jnp.asarray(np.concatenate([fan_Ts.numpy(), tr["samples"][1]]))
    bad = jnp.asarray(np.concatenate([fan_bad.numpy(), tr["badness"][1]]))
    js = JFP(x=jnp.asarray(tr["scene_x"][1]), f=jnp.asarray(tr["scene_f"][1]), mask=jnp.asarray(tr["scene_mask"][1]))
    jg = JFP(x=jnp.asarray(tr["grasp_x"][1]), f=jnp.asarray(tr["grasp_f"][1]), mask=jnp.asarray(tr["grasp_mask"][1]))
    n_fan = fan_Ts.shape[0]

    def loss_fn(p):  # the JAX tool's step loss (tools/train_critic_cascade.py), deterministic
        def fwd(m, T, s, g):
            return m.energy(T, m.get_key_pcd_multiscale(s), m.get_query_pcd(g), jnp.ones((T.shape[0],), T.dtype))

        E = jmodel.apply(p, poses, js, jg, method=fwd)
        la, acc = jrank.rank_loss(E, bad, jrank_cfg)
        lc, cacc = jrank.rank_loss(E[n_fan:], bad[n_fan:], jrank_cfg)
        total = 0.5 * la + 0.5 * lc
        return total, dict(loss=total, acc=acc, cascade_loss=lc, cascade_acc=cacc)

    (jloss, jstats), jgrads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params)
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=loss_rtol)
    assert stats.keys() == jstats.keys()
    for k in stats:
        np.testing.assert_allclose(float(stats[k].detach()), float(jstats[k]), rtol=loss_rtol, atol=1e-6, err_msg=k)
    jflat = flatten_jax(jgrads)
    assert set(grads) == set(jflat)
    for k, g in jflat.items():
        assert np.abs(grads[k] - g).max() <= grad_tol * np.abs(g).max() + 1e-12, k
    assert 0.0 < float(stats["acc"].detach()) < 1.0 and any(np.abs(g).max() > 0 for g in jflat.values())


# --------------------------------------------------------------------------- #
# the dump and the sweep behind one stub agent
# --------------------------------------------------------------------------- #
PKGS = {
    "jax": dict(agent=jagent, proc=j_proc, demo=JDemo, syn=jsyn),
    "port": dict(agent=tagent, proc=t_proc, demo=TDemo, syn=tsyn),
}


class ToolStub:
    """Stands in for a cascade agent: ``sample`` processes the clouds as the
    agent would and returns, for its i-th call, seeded poses around the
    processed target of the demo whose scene it was given (some far off,
    some spun about z), ignoring the schedule and the random key."""

    def __init__(self, pkg, preprocess, targets, n_models):
        self.proc_fn, self.demo, self.targets, self.calls = pkg["proc"](preprocess), pkg["demo"], targets, 0
        self.models = [types.SimpleNamespace(device=torch.device("cpu"))] * n_models

    def sample(self, scene_pcd, grasp_pcd, Ts_init, record_trajectory=True, **_):
        d = self.proc_fn(self.demo(scene_pcd=scene_pcd, grasp_pcd=grasp_pcd, target_poses=np.zeros((1, 7))))
        T = self.targets[scene_pcd.points.tobytes()]
        rng = np.random.default_rng(100 + self.calls)
        self.calls += 1
        n = len(Ts_init)
        q = teval._symmetry_orbit(T[None], 8)[rng.integers(0, 8, n), :4] + rng.normal(0, 0.01, (n, 4))
        q /= np.linalg.norm(q, axis=-1, keepdims=True)
        x = T[4:] + rng.normal(0, 0.4, (n, 3))
        x[: n // 3] += 4.0
        return np.concatenate([q, x], -1)[None].astype(np.float32), d.scene_pcd, d.grasp_pcd, {}


def test_critic_runtime_step_equals_eager(critic_files):
    """The tool's step through its program (on the CPU run eagerly, over the
    dump staged on the device and a device index) against its eager step,
    from the same weights and generator seed, demos 1, 0, 1: the statistics,
    the parameters and the optimizer state bit-equal; and ``run_eval``'s
    energies, through its program, equal to ``energies`` demo by demo."""
    files, _, _, rank_cfg = critic_files
    tr = tcc.load_dump(files["train"])
    runs = {}
    for use_runtime in (False, True):
        model, _ = tcc.build_critic(files["cfg"], "cpu", files["init"])
        opt = tcc.make_optimizer(list(model.parameters()), 1e-3, 3)
        step = tcc.make_train_step(model, tr, RankConfig(n_negatives=4), rank_cfg, opt,
                                   torch.Generator().manual_seed(0), use_runtime=use_runtime)
        runs[use_runtime] = model, opt, [step(d) for d in (1, 0, 1)]
    (m_e, o_e, s_e), (m_r, o_r, s_r) = runs[False], runs[True]
    assert [st.keys() for st in s_r] == [st.keys() for st in s_e] and len(s_r[0]) == 4
    assert all(torch.equal(a[k], b[k]) for a, b in zip(s_r, s_e) for k in a)
    assert s_r[0]["loss"] != s_r[2]["loss"]  # the steps are not one replayed copy
    for a, b in zip([*m_r.parameters(), *o_r.state_tensors()], [*m_e.parameters(), *o_e.state_tensors()]):
        assert torch.equal(a, b)
    ev = tcc.load_dump(files["eval"])
    _, Ed = tcc.run_eval(m_r, ev)
    m_r.eval()
    for i, e in enumerate(Ed):
        with torch.no_grad():
            ref = tcc.energies(m_r, torch.as_tensor(ev["samples"][i]), *tcc.dump_clouds(ev, i, "cpu"))
        np.testing.assert_array_equal(e, ref.numpy())


def _install_stub(monkeypatch, pkg, demo_sets):
    """Patch ``pkg``'s agent module so that its tools build a ``ToolStub``
    over the processed targets of ``demo_sets``."""
    targets = {}
    proc = pkg["proc"](teval.PREPROCESS)
    for demos in demo_sets:
        for seq in demos:
            for demo in seq:
                d = proc(pkg["demo"](scene_pcd=demo.scene_pcd, grasp_pcd=demo.grasp_pcd,
                                     target_poses=demo.target_poses))
                targets[demo.scene_pcd.points.tobytes()] = np.asarray(d.target_poses[0], np.float64)
    bundle = types.SimpleNamespace(device=torch.device("cpu"), n_scene_pad=2048, n_grasp_pad=512)
    monkeypatch.setattr(pkg["agent"], "load_model_bundle", lambda *a, **k: bundle)
    monkeypatch.setattr(pkg["agent"], "DiffusionEdfAgent",
                        lambda bundles, pre, unpre, **k: ToolStub(pkg, pre, targets, len(bundles)))


@pytest.mark.parametrize("task", ["pick", "place"])
def test_gen_cascade_samples_matches_jax_on_a_stub(task, tmp_path, monkeypatch):
    """Both tools write the same dump: keys, dtypes, shapes and values."""
    out = {}
    for name, main, extra in (("jax", jgen.main, []), ("port", tgen.main, ["--device", "cpu"])):
        pkg = PKGS[name]
        _install_stub(monkeypatch, pkg, [pkg["syn"].make_synthetic_dataset(n_demos=2, seed=3, diverse=True)])
        out[name] = str(tmp_path / f"{name}.npz")
        main(["--task-type", task, "--checkpoint-dir", "none.npz", "--cascade-checkpoint-dir", "none.npz",
              "--schedule-json", str(ROOT / "reports" / "schedule_sweep_pick_r2.json"), "--n-demos", "2",
              "--n-seeds", "6", "--demo-seed", "3", "--seed", "1", "--out", out[name]] + extra)
    with np.load(out["jax"]) as zj, np.load(out["port"]) as zt:
        assert set(zt.files) == set(zj.files) == {"scene_x", "scene_f", "scene_mask", "grasp_x", "grasp_f",
                                                   "grasp_mask", "samples", "trans_err", "rot_err_deg", "target",
                                                   "names", "meta"}
        for k in zj.files:
            assert zt[k].dtype == zj[k].dtype and zt[k].shape == zj[k].shape, k
            np.testing.assert_array_equal(zt[k], zj[k], err_msg=k)
        assert zt["samples"].shape == (2, 6, 7) and zt["scene_x"].shape == (2, 2048, 3)
        assert json.loads(bytes(zt["meta"]).decode())["sym_orbit"] == (72 if task == "place" else 0)
        ok = (zt["trans_err"] <= 1.0) & (zt["rot_err_deg"] <= 5.0)
        assert ok.any() and not ok.all()
    # and the port's critic tool reads the JAX tool's dump
    d = tcc.load_dump(out["jax"])
    assert d["badness"].shape == (2, 6)


@pytest.mark.parametrize("round2", [False, True], ids=["round1", "round2"])
def test_sweep_schedule_matches_jax_on_a_stub(round2, tmp_path, monkeypatch):
    """Both sweeps write the same report, every candidate and split, and
    pick the same winner; only the wall seconds differ."""
    splits = ["default", "unseen_poses"]
    out = {}
    for name, main, extra in (("jax", jsweep.main, []), ("port", tsweep.main, ["--device", "cpu"])):
        pkg = PKGS[name]
        _install_stub(monkeypatch, pkg, [pkg["syn"].make_split_dataset(s, n_demos=2, seed=1000) for s in splits])
        out[name] = tmp_path / f"{name}.json"
        main(["--checkpoint-dir", "none.npz", "--cascade-checkpoint-dir", "none.npz", "--n-demos", "2",
              "--n-seeds", "5", "--out", str(out[name])] + (["--round2"] if round2 else []) + extra)
    jrep, trep = (json.loads(out[n].read_text()) for n in ("jax", "port"))
    for rep in (jrep, trep):
        for c in rep["candidates"]:
            assert c.pop("wall_s") >= 0
    assert trep == jrep
    assert len(trep["candidates"]) == (5 if round2 else 6)
    assert any(0 < c[s]["success"] < 1 for c in trep["candidates"] for s in splits)


# --------------------------------------------------------------------------- #
# the train-and-evaluate loop and the K-truncation report
# --------------------------------------------------------------------------- #
SHORT = dict(N_steps_list=[[2]], timesteps_list=[[0.02]], temperatures_list=[[1.0]],
             diffusion_schedules_list=[[[1.0, 0.5]]], log_t_schedule=True, time_exponent_temp=1.0,
             time_exponent_alpha=0.5)


@pytest.mark.parametrize("ebm", [False, True], ids=["score_model", "critic"])
def test_train_eval_loop_one_epoch(ebm, tmp_path, monkeypatch):
    """One epoch from a warm start with an evaluation before and after (a
    two-step schedule stands in for the 900-step reference): two curve
    lines with the committed curve's keys (a critic: the rank Spearman
    alone, with ``--skip-sampler-eval``), ``best.json``, and a float16
    export that the JAX loader reads with exact keys."""
    cfg_dir = _config_dir(tmp_path, ebm=ebm)
    monkeypatch.setattr(teval, "reference_inference_config", lambda n_stages=1: SHORT)
    monkeypatch.chdir(tmp_path)
    model_cfg = yaml.safe_load((Path(cfg_dir) / "score_model_configs.yaml").read_text())
    warm = tmp_path / "warm.npz"
    tmodel = t_build(model_cfg["model_name"], model_cfg["model_kwargs"])
    np.savez(warm, **flat_arrays(init_params(tmodel, torch.Generator().manual_seed(9))))
    export = tmp_path / "best.npz"
    best = tloop.main(["--configs-root-dir", cfg_dir, "--synthetic-demos", "1", "--max-epochs", "1", "--eval-every",
                       "1", "--eval-demos", "1", "--n-seeds", "3", "--log-name", "loop", "--init-params-npz",
                       str(warm), "--export-best", str(export), "--lr", "1e-4", "--grad-clip-norm", "1.0",
                       "--device", "cpu"] + (["--skip-sampler-eval"] if ebm else []))
    lines = [json.loads(s) for s in (tmp_path / "runs" / "loop" / "learning_curve.jsonl").read_text().splitlines()]
    assert [r["epoch"] for r in lines] == [0, 1] and lines[1]["steps"] == 1
    if ebm:
        assert all(set(r[s]) == {"rank_spearman"} and -1 <= r[s]["rank_spearman"] <= 1
                   for r in lines for s in ("default", "unseen_poses"))
    else:
        ref = json.loads((ROOT / "reports" / "learning_curve_pick_lowres.jsonl").read_text().splitlines()[0])
        for r in lines:
            assert r.keys() == ref.keys()
            assert all(r[s].keys() == ref[s].keys() for s in ("default", "unseen_poses"))
    assert best["epoch"] == 1 and json.loads((tmp_path / "runs" / "loop" / "best.json").read_text())["epoch"] == 1
    with np.load(export) as z:
        assert all(z[k].dtype == np.float16 for k in z.files if k != "__meta__")
        assert json.loads(bytes(z["__meta__"]).decode()).keys() == {"log_name", "best_epoch", "score"}
    # the JAX loader reads the export with exact keys (it raises on a missing or an unknown one)
    loaded = jagent.load_params_npz(str(export), torch_to_jax_params(tmodel))
    assert set(flatten_jax(loaded)) == set(flatten_jax(torch_to_jax_params(tmodel)))
    load_params_npz(tmodel, str(export))


def test_k_truncation_report_rows(tmp_path):
    """The rows of the JAX tool's report, one per call site in call order of
    first appearance, every destination counted once per demo."""
    cfg_dir = _config_dir(tmp_path)
    out = tmp_path / "k.json"
    rows = tkt.main(["--configs-root-dir", cfg_dir, "--n-demos", "2", "--n-poses", "3", "--json-out", str(out),
                     "--device", "cpu"])
    assert json.loads(out.read_text()) == rows
    assert all(r.keys() == {"tag", "r", "k", "max_degree", "frac_truncated", "n_eval"} for r in rows)
    tags = {r["tag"]: r for r in rows}
    assert {"extractor/pool_0", "extractor/self_0", "extractor/up_1", "radius_edge/parser_0"} <= set(tags)
    assert tags["radius_edge/parser_0"]["n_eval"] == 2 * 3 * 2  # demos x poses x keypoints
    assert tags["extractor/pool_0"]["n_eval"] == 2 * 512  # ceil(0.25 * 2048) FPS points a demo
    assert [r["frac_truncated"] for r in rows] == sorted((r["frac_truncated"] for r in rows), reverse=True)


# --------------------------------------------------------------------------- #
# small counterparts and the copied configs
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("l", [0, 1, 2, 3])
def test_wigner_D_from_quaternion_matches_jax(l):
    rng = np.random.default_rng(l)
    q = rng.normal(size=(5, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    out = twigner.wigner_D_from_quaternion(l, torch.as_tensor(q)).numpy()
    assert out.shape == (5, 2 * l + 1, 2 * l + 1)
    np.testing.assert_allclose(out, np.asarray(jwigner.wigner_D_from_quaternion(l, jnp.asarray(q))), atol=1e-6)


PORT_CONFIGS = ROOT / "diffusion_edf_tpu_torch" / "configs"
JAX_CONFIGS = ROOT / "diffusion_edf_tpu" / "configs"
COPIED = ["panda_bowl", "panda_bottle", "sapien_bottle", "sapien/place_lowres", "sapien/place_highres",
          "sapien/pick_lowres_synth", "sapien/agent.yaml", "sapien/preprocess.yaml", "sapien/server.yaml",
          "panda_mug/pick_ebm_fine"]
COPIED_FILES = sorted(str(p.relative_to(PORT_CONFIGS)) for c in COPIED for p in
                      ([PORT_CONFIGS / c] if c.endswith(".yaml") else (PORT_CONFIGS / c).rglob("*.yaml")))
COPIED_MODELS = sorted(str(Path(f).parent) for f in COPIED_FILES if f.endswith("score_model_configs.yaml"))


def _port_prefix(node):
    if isinstance(node, dict):
        return {k: _port_prefix(v) for k, v in node.items()}
    if isinstance(node, list):
        return [_port_prefix(v) for v in node]
    if isinstance(node, str):
        return node.replace("diffusion_edf_tpu/configs/", "diffusion_edf_tpu_torch/configs/")
    return node


@pytest.mark.parametrize("rel", COPIED_FILES)
def test_copied_config_parses_to_the_jax_dict(rel):
    """Each copy is the JAX file's dict; an ``agent.yaml``'s
    ``configs_root_dir`` entries name the port's copies instead."""
    port, ref = (yaml.safe_load((root / rel).read_text()) for root in (PORT_CONFIGS, JAX_CONFIGS))
    assert port == (_port_prefix(ref) if rel.endswith("agent.yaml") else ref)
    if rel.endswith("agent.yaml"):
        assert "diffusion_edf_tpu/configs/" not in (PORT_CONFIGS / rel).read_text()


SHIPPED = {"panda_bowl/pick_lowres", "panda_bowl/place_lowres", "panda_bottle/pick_lowres", "panda_mug/pick_ebm_fine"}


@pytest.mark.parametrize("rel", COPIED_MODELS)
def test_copied_model_config_builds(rel):
    """Every copied model config builds in the port; where a checkpoint of
    that family ships, it loads with exact keys."""
    cfg = yaml.safe_load((PORT_CONFIGS / rel / "score_model_configs.yaml").read_text())
    model = t_build(cfg["model_name"], cfg["model_kwargs"])
    assert sum(p.numel() for p in model.parameters()) > 0
    if rel in SHIPPED:
        load_params_npz(model, str(ROOT / "checkpoints" / f"{rel}.npz"))


def test_every_jax_config_has_a_port_copy():
    assert sorted(str(p.relative_to(JAX_CONFIGS)) for p in JAX_CONFIGS.rglob("*.yaml")) == \
        sorted(str(p.relative_to(PORT_CONFIGS)) for p in PORT_CONFIGS.rglob("*.yaml"))
    assert COPIED_MODELS and set(SHIPPED) <= set(COPIED_MODELS)
