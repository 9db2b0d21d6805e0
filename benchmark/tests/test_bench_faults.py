"""The check fails a broken timed path: each fault a cell can have, planted
in the program underneath a whole run (the look for a card skipped, tiny
models on the CPU), reads ``correct`` false; the sound path reads true."""
from __future__ import annotations

import json
import os

import pytest
import torch

from .conftest import run_cell


def _unchanged_step(monkeypatch):
    """A Langevin step that returns its state unchanged."""
    import diffusion_edf_tpu_torch.agent as agent

    def step(score_fn, T, table, step, noise=None, traj=None):
        if traj is not None:
            traj.index_copy_(0, step + 1, T.unsqueeze(0))
        step.add_(1)

    monkeypatch.setattr(agent, "langevin_step", step)


def _altered_answer(monkeypatch):
    """A pose altered where the step produces it."""
    import diffusion_edf_tpu_torch.agent as agent

    orig = agent.langevin_step

    def step(score_fn, T, table, step, noise=None, traj=None):
        orig(score_fn, T, table, step, noise, None)
        T[..., 0, 4] += 0.05
        if traj is not None:
            traj.index_copy_(0, step, T.unsqueeze(0))

    monkeypatch.setattr(agent, "langevin_step", step)


def _half_batch_served(monkeypatch):
    """Half of a dispatch's requests left out: the others get the first's answer."""
    from diffusion_edf_tpu_torch.agent import DiffusionEdfAgent

    orig = DiffusionEdfAgent.sample_batch

    def sample_batch(self, scenes, grasps, Ts, n_seeds=None, **kw):
        R = len(scenes)
        h = max(R // 2, 1)
        traj, info = orig(self, scenes[:h], grasps[:h], Ts[:h], n_seeds=None if n_seeds is None else n_seeds[:h], **kw)
        idx = [i if i < h else 0 for i in range(R)]
        info = dict(info, energy=info["energy"][idx]) if "energy" in info else info
        return traj[idx], info

    monkeypatch.setattr(DiffusionEdfAgent, "sample_batch", sample_batch)


def _lowres_query_moved(monkeypatch):
    """The first stage's query points moved by a centimetre: a wrong answer of
    the lowres stage alone (the place query is the keypoint extractor's)."""
    from diffusion_edf_tpu_torch.agent import DiffusionEdfAgent

    orig = DiffusionEdfAgent.__init__

    def init(self, *args, **kwargs):
        orig(self, *args, **kwargs)
        rt = self._runtimes[0]
        extract = rt.extract

        def moved(preps, batched):
            key_ms, query = extract(preps, batched)
            return key_ms, query.replace(x=query.x + 1.0)

        rt.extract = moved

    monkeypatch.setattr(DiffusionEdfAgent, "__init__", init)


def _no_update(monkeypatch):
    """A train step that leaves the parameters, EMA and optimizer unchanged."""
    from diffusion_edf_tpu_torch.train.trainer import DiffusionEdfTrainer

    monkeypatch.setattr(DiffusionEdfTrainer, "apply_grads", lambda self, grads: None)


def _ema_frozen(monkeypatch):
    """A train step whose update leaves the EMA where it is."""
    from diffusion_edf_tpu_torch.train.trainer import DiffusionEdfTrainer

    monkeypatch.setattr(DiffusionEdfTrainer, "apply_grads", lambda self, grads: self.optimizer.step(grads))


def _half_batch_trained(monkeypatch):
    """The loss over half of the poses, the mean taken over the rest."""
    import diffusion_edf_tpu_torch.train.trainer as trainer

    orig = trainer.train_loss

    def half(ang, lin, t_ang, t_lin, time, *a):
        n = ang.shape[0] // 2
        return orig(ang[:n], lin[:n], t_ang[:n], t_lin[:n], time[:n], *a)

    monkeypatch.setattr(trainer, "train_loss", half)


CASES = [("pick_serve", None), ("pick_serve", _unchanged_step), ("pick_serve", _altered_answer),
         ("pick_serve", _lowres_query_moved),
         ("place_serve4", None), ("place_serve4", _unchanged_step), ("place_serve4", _half_batch_served),
         ("place_serve4", _lowres_query_moved),
         ("pick_train", None), ("pick_train", _no_update), ("pick_train", _half_batch_trained),
         ("pick_train", _ema_frozen)]


@pytest.mark.parametrize("cell,fault", CASES, ids=[f"{c}-{f.__name__.strip('_') if f else 'sound'}" for c, f in CASES])
def test_fault_reads_incorrect(tiny_root, capsys, monkeypatch, cell, fault):
    torch.set_num_threads(2)
    path = os.path.join(tiny_root, "benchmark", "traffic", f"tiny_{cell}.json")
    with open(path) as f:
        mix = json.load(f)
    if "requests" in mix["check"]:
        mix["check"]["requests"] = 100  # every request: a fault in one request of a dispatch shows
    with open(path, "w") as f:
        json.dump(mix, f)
    if fault is not None:
        fault(monkeypatch)
    code, line, err = run_cell(tiny_root, cell, capsys, seconds=2.0)
    assert code == 0 and line is not None, err
    assert line["correct"] is (fault is None), err
    assert line["failed"] == 0
