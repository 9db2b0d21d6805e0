"""Training-time SE(3) diffusion: contact reference points and the pose
perturbation with its analytic score targets (counterpart of the JAX
package's ``diffusion/diffuse.py``).

Each sampler is a draw function (``*_draws``, or the one-line draw inside
the sampler), which takes every random number from a ``torch.Generator``,
and a deterministic function of those numbers (``*_given``)."""
from __future__ import annotations

from typing import Dict, Optional, Tuple, Union

import torch

from ..data import FeaturedPoints
from ..geom import igso3, so3
from ..ops.neighbors import count_within_radius

__all__ = [
    "reference_point_weights",
    "sample_reference_points",
    "time_from_uniform",
    "random_time",
    "diffuse_T_target_given",
    "diffuse_T_target",
    "biequiv_draws",
    "biequiv_diffusion_given",
    "biequiv_diffusion",
]


def reference_point_weights(
    src_points: torch.Tensor,
    dst_points: torch.Tensor,
    r: float,
    src_mask: Optional[torch.Tensor] = None,
    dst_mask: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(weights, counts)`` of contact-point sampling over ``dst_points``:
    each valid point's count of sources within ``r``; with no contact at
    all, 1 for every valid point (uniform sampling)."""
    counts = count_within_radius(src_points, dst_points, r, src_mask=src_mask, dst_mask=dst_mask)
    w = counts.to(torch.float32)
    if dst_mask is not None:
        w = torch.where(dst_mask, w, torch.zeros_like(w))
    fallback = torch.ones_like(w) if dst_mask is None else dst_mask.to(torch.float32)
    return torch.where(torch.sum(w) > 0, w, fallback), counts


def sample_reference_points(
    src_points: torch.Tensor,
    dst_points: torch.Tensor,
    r: float,
    n_samples: int,
    src_mask: Optional[torch.Tensor] = None,
    dst_mask: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``n_samples`` contact reference points drawn from ``dst_points`` with
    the weights of :func:`reference_point_weights`, and the counts."""
    w, counts = reference_point_weights(src_points, dst_points, r, src_mask, dst_mask)
    idx = torch.multinomial(w, n_samples, replacement=True, generator=generator)
    return dst_points[idx], counts


def time_from_uniform(u: torch.Tensor, min_time: float, max_time: float) -> torch.Tensor:
    """A uniform draw ``u`` in [0, 1) mapped to [min_time, max_time)."""
    ratio = min_time / max_time
    return (ratio + u * (1.0 - ratio)) * max_time


def random_time(min_time: float, max_time: float, generator: Optional[torch.Generator] = None,
                dtype=torch.float32, device=None) -> torch.Tensor:
    """(1,) time, uniform in [min_time, max_time)."""
    return time_from_uniform(torch.rand(1, generator=generator, dtype=dtype, device=device), min_time, max_time)


def diffuse_T_target_given(
    T_target: torch.Tensor,  # (nT, 7)
    x_ref: torch.Tensor,  # (nX, 3)
    time: torch.Tensor,  # (1,) or scalar
    draws: Dict[str, torch.Tensor],
    lin_mult: float,
    ang_mult: float,
    lmax: int = 100,
):
    """The target poses perturbed about every reference point with the
    ``nX * nT`` perturbations of ``draws`` (``igso3.se3_gaussian_draws``):
    ``eps = t / 2 * ang_mult^2``, ``std = sqrt(t) * lin_mult``.  Returns
    ``(T, delta_T, time_in, (ang, lin), (ang_ref, lin_ref))``, flattened to
    (nX * nT, .)."""
    t = time.reshape(())
    eps = t / 2.0 * (ang_mult**2)
    std = torch.sqrt(t) * lin_mult
    T, delta_T, (ang, lin), (ang_ref, lin_ref) = igso3.diffuse_isotropic_se3_given(
        T_target, eps, std, draws, x_ref=x_ref, lmax=lmax)
    n = T.shape[0] * T.shape[1]
    return (
        T.reshape(n, 7),
        delta_T.reshape(n, 7),
        t.expand(n).to(T.dtype),
        (ang.reshape(n, 3), lin.reshape(n, 3)),
        (ang_ref.reshape(n, 3), lin_ref.reshape(n, 3)),
    )


def diffuse_T_target(T_target, x_ref, time, lin_mult: float, ang_mult: float, lmax: int = 100,
                     generator: Optional[torch.Generator] = None):
    draws = igso3.se3_gaussian_draws(x_ref.shape[0] * T_target.shape[0], generator, T_target.dtype,
                                     T_target.device)
    return diffuse_T_target_given(T_target, x_ref, time, draws, lin_mult, ang_mult, lmax=lmax)


def _scene_in_grasp_frame(T_init: torch.Tensor, scene_x: torch.Tensor) -> torch.Tensor:
    T_inv = so3.se3_invert(T_init)[0]
    return so3.quaternion_apply(T_inv[None, :4], scene_x) + T_inv[None, 4:]


def _draw_indices(w: torch.Tensor, n: int, generator: Optional[torch.Generator]) -> torch.Tensor:
    """``n`` indices drawn with replacement with the weights ``w``, as
    ``torch.multinomial`` draws them.  For one sample that function takes an
    exponential race behind a check that reads ``w`` on the host; the race
    is written out here without the check, so a CUDA graph can capture it."""
    if n == 1:
        q = torch.empty_like(w).exponential_(1.0, generator=generator)
        return torch.argmax(w / q, dim=-1, keepdim=True)
    return torch.multinomial(w, n, replacement=True, generator=generator)


def biequiv_draws(
    T_init: torch.Tensor,  # (1, 7)
    scene_points: FeaturedPoints,
    grasp_points: FeaturedPoints,
    n_samples_x_ref: int,
    contact_radius: float,
    generator: Optional[torch.Generator] = None,
) -> Dict[str, torch.Tensor]:
    """The random numbers of :func:`biequiv_diffusion_given`: ``ref_idx``,
    the grasp points drawn as contact reference points (weighted by the
    scene points near them once the scene is moved into the grasp frame by
    ``T_init^-1``), and the perturbations of ``igso3.se3_gaussian_draws``."""
    w, _ = reference_point_weights(_scene_in_grasp_frame(T_init, scene_points.x), grasp_points.x,
                                   contact_radius, scene_points.mask, grasp_points.mask)
    draws = dict(ref_idx=_draw_indices(w, n_samples_x_ref, generator))
    draws.update(igso3.se3_gaussian_draws(n_samples_x_ref * T_init.shape[0], generator, T_init.dtype,
                                          T_init.device))
    return draws


def biequiv_diffusion_given(T_init: torch.Tensor, time: Union[float, torch.Tensor], grasp_points: FeaturedPoints,
                            draws: Dict[str, torch.Tensor], ang_mult: float, lin_mult: float, lmax: int = 100):
    """The diffusion of ``T_init`` about the drawn contact points (see
    :func:`diffuse_T_target_given` for what it returns)."""
    time = (time.to(device=T_init.device, dtype=T_init.dtype) if isinstance(time, torch.Tensor)
            else torch.full((), float(time), dtype=T_init.dtype, device=T_init.device))  # a fill: no host copy
    return diffuse_T_target_given(T_init, grasp_points.x[draws["ref_idx"]], time, draws,
                                  lin_mult=lin_mult, ang_mult=ang_mult, lmax=lmax)


def biequiv_diffusion(
    T_init: torch.Tensor,
    time: Union[float, torch.Tensor],
    scene_points: FeaturedPoints,
    grasp_points: FeaturedPoints,
    ang_mult: float,
    lin_mult: float,
    n_samples_x_ref: int,
    contact_radius: float,
    lmax: int = 100,
    generator: Optional[torch.Generator] = None,
):
    draws = biequiv_draws(T_init, scene_points, grasp_points, n_samples_x_ref, contact_radius, generator)
    return biequiv_diffusion_given(T_init, time, grasp_points, draws, ang_mult, lin_mult, lmax=lmax)
