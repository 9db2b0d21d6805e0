"""Annealed Langevin dynamics on SE(3) (counterpart of the JAX package's
``diffusion/langevin.py``).  The schedule is flattened into per-step arrays
on the host; the rollout is a Python loop over steps with the whole seed
batch in one pose tensor.  Pose state is f32 and the quaternion is
renormalised every step."""
from __future__ import annotations

import math
from typing import NamedTuple, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..geom import so3
from ..models.score_head import quat_L

__all__ = ["LangevinSchedule", "build_schedule", "langevin_sample"]


class LangevinSchedule(NamedTuple):
    t: np.ndarray  # (S,) float64
    alpha_ang: np.ndarray
    alpha_lin: np.ndarray
    temperature: np.ndarray


def build_schedule(
    diffusion_schedules: Sequence[Sequence[float]],
    N_steps: Sequence[int],
    timesteps: Sequence[float],
    ang_mult: float,
    lin_mult: float,
    temperatures: Union[float, Sequence[float]] = 1.0,
    log_t_schedule: bool = True,
    time_exponent_temp: float = 0.5,
    time_exponent_alpha: float = 0.5,
) -> LangevinSchedule:
    """``alpha = timestep * mult^2 * t^exp_alpha``, ``T = temp * t^exp_temp``
    for every step of every annealing segment."""
    if isinstance(temperatures, (int, float)):
        temperatures = [float(temperatures)] * len(diffusion_schedules)
    ts, a_ang, a_lin, temps = [], [], [], []
    for (t0, t1), n, dt, temp in zip(diffusion_schedules, N_steps, timesteps, temperatures):
        seg = np.logspace(math.log(t0), math.log(t1), n, base=math.e) if log_t_schedule else np.linspace(t0, t1, n)
        ts.append(seg)
        a_ang.append(ang_mult**2 * seg**time_exponent_alpha * dt)
        a_lin.append(lin_mult**2 * seg**time_exponent_alpha * dt)
        temps.append(temp * seg**time_exponent_temp)
    return LangevinSchedule(*(np.concatenate(v) for v in (ts, a_ang, a_lin, temps)))


def langevin_sample(
    score_fn,
    T_seed: torch.Tensor,  # ([R,] nT, 7)
    schedule: LangevinSchedule,
    ang_mult: float,
    lin_mult: float,
    generator: Optional[torch.Generator] = None,
    record_trajectory: bool = True,
    seed_block: Optional[Tuple[int, int]] = None,
):
    """``score_fn(Ts ([R,] nT, 7), time ([R,] nT)) -> (ang, lin)`` is the
    dimensionless network output, unscaled here by ``1 / (mult * sqrt(t))``.
    Noise comes from ``generator`` (on the pose tensor's device), one
    block of the poses' shape for the angular part, then one for the linear
    part, each step.  ``seed_block = (n, start)``: ``T_seed`` holds the
    seeds ``start:start + nT`` of an ``n``-seed batch (the seed axis is the
    second to last); the noise is drawn for all ``n`` and this block kept,
    so the block moves as it does in the rollout of the whole batch.
    Returns the final poses and, if asked, the trajectory (S + 1, [R,] nT,
    7)."""
    T = T_seed.to(torch.float32)
    traj = [T] if record_trajectory else None
    f32 = np.float32

    def noise(like: torch.Tensor) -> torch.Tensor:
        if seed_block is None:
            return torch.randn(like.shape, generator=generator, dtype=like.dtype, device=like.device)
        shape = list(like.shape)
        shape[-2] = seed_block[0]
        return torch.randn(shape, generator=generator, dtype=like.dtype, device=like.device).narrow(
            -2, seed_block[1], like.shape[-2])

    for t, a_ang, a_lin, temp in zip(*(v.astype(f32) for v in schedule)):
        ang, lin = score_fn(T, torch.full(T.shape[:-1], float(t), dtype=T.dtype, device=T.device))
        sqrt_t = float(np.sqrt(t))
        ang = ang / float(f32(ang_mult) * f32(sqrt_t))
        lin = lin / float(f32(lin_mult) * f32(sqrt_t))
        ang_disp = float(a_ang / f32(2.0)) * ang
        lin_disp = float(a_lin / f32(2.0)) * lin
        if temp > 0:
            ang_disp = ang_disp + float(np.sqrt(temp * a_ang)) * noise(ang)
            lin_disp = lin_disp + float(np.sqrt(temp * a_lin)) * noise(lin)
        q, x = T[..., :4], T[..., 4:]
        dq = torch.einsum("...ia,...a->...i", quat_L(q), ang_disp)
        dx = so3.quaternion_apply(q, lin_disp)
        T = torch.cat([so3.normalize_quaternion(q + dq), x + dx], dim=-1)
        if record_trajectory:
            traj.append(T)
    return T, (torch.stack(traj) if record_trajectory else None)
