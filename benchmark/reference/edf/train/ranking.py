"""The critic's ranking loss: the EBM's energy must order poses by quality
(counterpart of the JAX package's ``train/ranking.py``).  Per step,
perturbations of the demo target at log-uniform translation and rotation
magnitudes, with known badness ``trans_cm + badness_rot_weight * rot_deg``,
and a pairwise logistic loss that asks the energies to follow the badness
order.  :func:`rank_draws` makes the random numbers and
:func:`sample_ranked_poses_given` is a deterministic function of them."""
from __future__ import annotations

import math
from typing import Dict, NamedTuple, Optional, Tuple

import torch

from ..geom import so3

__all__ = ["RankConfig", "rank_draws", "sample_ranked_poses_given", "sample_ranked_poses", "rank_loss"]


class RankConfig(NamedTuple):
    """``critic_rank_configs`` of ``train_configs.yaml`` (EBM models only)."""

    weight: float = 1.0
    n_negatives: int = 32
    trans_range_cm: Tuple[float, float] = (0.1, 8.0)
    rot_range_deg: Tuple[float, float] = (0.5, 45.0)
    badness_rot_weight: float = 0.2  # cm-equivalent per degree
    tau: float = 0.1  # energy scale of the pairwise logistic
    min_gap: float = 0.25  # badness gap below which a pair is not ranked

    @classmethod
    def from_dict(cls, d) -> "RankConfig":
        d = dict(d or {})
        unknown = set(d) - set(cls._fields)
        if unknown:
            raise ValueError(f"unknown critic_rank_configs keys: {sorted(unknown)}")
        for k in ("trans_range_cm", "rot_range_deg"):
            if k in d:
                d[k] = tuple(float(v) for v in d[k])
        return cls(**d)


def _log_uniform(u: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    return torch.exp(math.log(lo) + u * (math.log(hi) - math.log(lo)))


def rank_draws(n: int, generator: Optional[torch.Generator], dtype, device) -> Dict[str, torch.Tensor]:
    """Uniforms of the translation and rotation magnitudes (``u_trans``,
    ``u_rot``, (n,)) and Gaussian directions and axes (``dirs``, ``axes``,
    (n, 3)) of ``n`` negatives."""
    def uniform():
        return torch.rand(n, generator=generator, dtype=dtype, device=device)

    def normal():
        return torch.randn(n, 3, generator=generator, dtype=dtype, device=device)

    return dict(u_trans=uniform(), u_rot=uniform(), dirs=normal(), axes=normal())


def sample_ranked_poses_given(T_target: torch.Tensor, cfg: RankConfig,
                              draws: Dict[str, torch.Tensor]) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(Ts (1 + n, 7), badness (1 + n,))``: the target ``T_target`` (7,)
    first at badness 0, then each negative, which perturbs both its rotation
    (random axis, log-uniform angle) and its translation (random direction,
    log-uniform length)."""
    mag_t = _log_uniform(draws["u_trans"], *cfg.trans_range_cm)
    mag_r_deg = _log_uniform(draws["u_rot"], *cfg.rot_range_deg)
    dirs, axes = draws["dirs"], draws["axes"]
    dirs = dirs / torch.clamp(torch.linalg.norm(dirs, dim=-1, keepdim=True), min=1e-9)
    axes = axes / torch.clamp(torch.linalg.norm(axes, dim=-1, keepdim=True), min=1e-9)
    n = dirs.shape[0]
    dq = so3.axis_angle_to_quaternion(axes * torch.deg2rad(mag_r_deg)[:, None])
    q = so3.quaternion_multiply(dq, T_target[None, :4].expand(n, 4))
    x = T_target[None, 4:] + dirs * mag_t[:, None]
    Ts = torch.cat([T_target[None], torch.cat([q, x], dim=-1)], dim=0)
    badness = torch.cat([mag_t.new_zeros(1), mag_t + cfg.badness_rot_weight * mag_r_deg])
    return Ts, badness


def sample_ranked_poses(T_target: torch.Tensor, cfg: RankConfig, generator: Optional[torch.Generator] = None):
    return sample_ranked_poses_given(
        T_target, cfg, rank_draws(cfg.n_negatives, generator, T_target.dtype, T_target.device))


def rank_loss(energies: torch.Tensor, badness: torch.Tensor, cfg: RankConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(loss, pair_accuracy)``: for every pair with ``badness_j > badness_i
    + min_gap``, ``softplus((E_i - E_j) / tau)`` weighted by
    ``tanh(gap / 2)``; the accuracy is the share of those pairs already in
    order."""
    dE = (energies[:, None] - energies[None, :]) / cfg.tau
    db = badness[None, :] - badness[:, None]
    ranked = db > cfg.min_gap
    w = torch.where(ranked, torch.tanh(db / 2.0), torch.zeros_like(db))
    loss = torch.sum(w * torch.nn.functional.softplus(dE)) / torch.clamp(torch.sum(w), min=1e-6)
    pairs = ranked.to(dE.dtype)
    acc = torch.sum(pairs * (dE < 0)) / torch.clamp(torch.sum(pairs), min=1e-6)
    return loss, acc
