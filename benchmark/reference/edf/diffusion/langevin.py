"""Annealed Langevin dynamics on SE(3) (counterpart of the JAX package's
``diffusion/langevin.py``).  The schedule is flattened into per-step arrays
on the host, and from them into a table of each step's scalars on the
device (:func:`schedule_table`).  One step (:func:`langevin_step`) reads its
row of the table through a step counter on the device, which it then
increments, and updates the poses in place.  Pose state is f32 and the
quaternion is renormalised every step."""
from __future__ import annotations

import math
from typing import NamedTuple, Optional, Sequence, Union

import numpy as np
import torch

from ..geom import so3
from ..models.score_head import quat_L

__all__ = ["LangevinSchedule", "build_schedule", "schedule_table", "draws_noise", "langevin_step"]


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


# the columns of schedule_table: the time, the score's unscaling 1 / (mult * sqrt(t)) as a divisor and as its
# reciprocal, the drift factors alpha / 2, and the noise scales sqrt(temperature * alpha)
(COL_T, COL_DIV_ANG, COL_DIV_LIN, COL_INV_ANG, COL_INV_LIN, COL_HALF_ANG, COL_HALF_LIN, COL_SIG_ANG,
 COL_SIG_LIN) = range(9)
N_COLUMNS = 9


def schedule_table(schedule: LangevinSchedule, ang_mult: float, lin_mult: float) -> np.ndarray:
    """(S, ``N_COLUMNS``) float32: each step's scalars, by the float32
    expressions the eager loop always used, so the rollout is the same to the
    bit.  Steps at temperature 0 have noise scales 0 (they draw nothing)."""
    f32 = np.float32
    t, a_ang, a_lin, temp = (v.astype(f32) for v in schedule)
    sqrt_t = np.sqrt(t)
    div_ang, div_lin = f32(ang_mult) * sqrt_t, f32(lin_mult) * sqrt_t
    hot = draws_noise(schedule)
    sig_ang = np.sqrt(np.where(hot, temp * a_ang, f32(0)))
    sig_lin = np.sqrt(np.where(hot, temp * a_lin, f32(0)))
    cols = (t, div_ang, div_lin, f32(1) / div_ang, f32(1) / div_lin, a_ang / f32(2.0), a_lin / f32(2.0), sig_ang,
            sig_lin)
    return np.stack([c.astype(f32) for c in cols], axis=-1)


def draws_noise(schedule: LangevinSchedule) -> np.ndarray:
    """(S,) bool: the steps that draw noise (temperature above 0)."""
    return schedule.temperature.astype(np.float32) > 0


def langevin_step(score_fn, T: torch.Tensor, table: torch.Tensor, step: torch.Tensor,
                  noise: Optional[torch.Tensor] = None, traj: Optional[torch.Tensor] = None) -> None:
    """One step, in place on the poses ``T`` ([R,] nT, 7) float32, with
    the scalars of row ``step`` of ``table`` (:func:`schedule_table` on T's
    device; ``step`` a (1,) int64 tensor there, incremented here).
    ``noise`` (2, [R,] nT, 3): the angular then the linear draw (None at
    temperature 0); ``traj`` (S + 1, [R,] nT, 7) or None receives the new
    poses at row ``step + 1``."""
    row = table.index_select(0, step)[0]
    ang, lin = score_fn(T, row[COL_T].expand(T.shape[:-1]).contiguous())
    if T.is_cuda:  # as PyTorch divides by a host float: on CUDA a product with the float's reciprocal
        ang, lin = ang * row[COL_INV_ANG], lin * row[COL_INV_LIN]
    else:
        ang, lin = ang / row[COL_DIV_ANG], lin / row[COL_DIV_LIN]
    ang_disp = ang * row[COL_HALF_ANG]
    lin_disp = lin * row[COL_HALF_LIN]
    if noise is not None:
        ang_disp = ang_disp + row[COL_SIG_ANG] * noise[0]
        lin_disp = lin_disp + row[COL_SIG_LIN] * noise[1]
    q, x = T[..., :4], T[..., 4:]
    dq = torch.einsum("...ia,...a->...i", quat_L(q), ang_disp)
    dx = so3.quaternion_apply(q, lin_disp)
    T.copy_(torch.cat([so3.normalize_quaternion(q + dq), x + dx], dim=-1))
    if traj is not None:
        traj.index_copy_(0, step + 1, T.unsqueeze(0))
    step.add_(1)

