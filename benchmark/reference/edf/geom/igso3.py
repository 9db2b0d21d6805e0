"""Isotropic Gaussian on SO(3) (IGSO(3)) and the IGSO(3) x R^3 diffusion
kernel on SE(3): density, score, inverse-CDF sampling and the transport of
the score to a reference point (counterpart of the JAX package's
``geom/igso3.py``).

Everything runs in the dtype of its inputs (float32 in training): the
character sum is truncated at a fixed ``lmax`` with the same small-number
guards as the JAX package, and the inverse CDF is a 1024-point grid with
linear interpolation (``jnp.interp``'s rule).  Every sampler is a draw
function, which makes all the random numbers (``*_draws``), and a
deterministic function of those numbers (``*_given``).  The float64 numpy
forms (``*_np``) are the oracles of the tests.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from . import so3

__all__ = [
    "determine_lmax",
    "haar_measure_angle",
    "igso3_angle_density",
    "igso3_score",
    "interp",
    "igso3_draws",
    "sample_igso3_given",
    "sample_igso3",
    "r3_isotropic_gaussian_score",
    "se3_isotropic_gaussian_score",
    "adjoint_inv_tr_isotropic_se3_score",
    "se3_gaussian_draws",
    "sample_isotropic_se3_gaussian_given",
    "sample_isotropic_se3_gaussian",
    "diffuse_isotropic_se3_given",
    "diffuse_isotropic_se3",
    "igso3_angle_density_np",
    "igso3_score_np",
]

_GRID_N = 1024


def determine_lmax(eps: float) -> int:
    """Truncation with ``exp(-lmax^2 eps) < exp(-10)``."""
    assert eps > 0.0
    return max(math.ceil(math.sqrt(10.0 / eps)), 5)


def haar_measure_angle(omg: torch.Tensor) -> torch.Tensor:
    """The Haar density of SO(3) over the rotation angle."""
    return (1.0 - torch.cos(omg)) / math.pi


def _small(dtype) -> float:
    return 1e-9 if dtype == torch.float32 else 1e-20


def igso3_angle_density(omg: torch.Tensor, eps, lmax: int = 100) -> torch.Tensor:
    """IGSO(3) density over the angle ``omg`` by the truncated character sum."""
    eps = torch.as_tensor(eps, dtype=omg.dtype, device=omg.device)
    small = _small(omg.dtype)
    l = torch.arange(lmax + 1, dtype=omg.dtype, device=omg.device)
    omg_ = omg[..., None]
    terms = (
        (2 * l + 1)
        * torch.exp(-l * (l + 1) * eps[..., None])
        * (torch.sin((l + 0.5) * omg_) + (l + 0.5) * small)
        / (torch.sin(omg_ / 2.0) + 0.5 * small)
    )
    return torch.clamp(torch.sum(terms, dim=-1), min=0.0)


def igso3_score(q: torch.Tensor, eps, lmax: int = 100) -> torch.Tensor:
    """Body-frame (Riemannian) score of IGSO(3) at the quaternions ``q``
    (..., 4): the Lie derivative of the density over the density."""
    dtype = q.dtype
    eps = torch.as_tensor(eps, dtype=dtype, device=q.device)
    small = _small(dtype)
    small_prob = 1e-10 if dtype == torch.float32 else 1e-30
    versor = torch.clamp(q[..., 0], -1.0, 1.0)
    omg = torch.arccos(versor) * 2.0
    l = torch.arange(lmax + 1, dtype=dtype, device=q.device)
    omg_ = omg[..., None]
    lie_deriv_cos_omg = -2.0 * versor[..., None] * q[..., 1:]
    char_deriv = (
        (l + 1) * torch.sin(l * omg_) - l * torch.sin((l + 1) * omg_) + small * l * (l + 1) * (2 * l + 1)
    ) / ((1.0 - torch.cos(omg_)) * torch.sin(omg_) + 3.0 * small)
    deriv_sum = torch.sum((2 * l + 1) * torch.exp(-l * (l + 1) * eps[..., None]) * char_deriv, dim=-1, keepdim=True)
    deriv = deriv_sum * lie_deriv_cos_omg
    prob = igso3_angle_density(omg, eps, lmax=lmax)[..., None]
    return (deriv / (prob + small_prob)) * (prob > 0.0)


def interp(x: torch.Tensor, xp: torch.Tensor, fp: torch.Tensor) -> torch.Tensor:
    """Piecewise-linear interpolation of ``fp`` over the sorted ``xp`` at
    ``x``, constant beyond both ends; an interval shorter than the dtype's
    spacing of its epsilon takes its left value (``jnp.interp``'s rule)."""
    i = torch.clamp(torch.searchsorted(xp, x, right=True), 1, xp.shape[0] - 1)
    df = fp[i] - fp[i - 1]
    dx = xp[i] - xp[i - 1]
    delta = x - xp[i - 1]
    epsilon = float(np.spacing(np.finfo(torch.empty(0, dtype=xp.dtype).numpy().dtype).eps))
    dx0 = torch.abs(dx) <= epsilon
    f = torch.where(dx0, fp[i - 1], fp[i - 1] + (delta / torch.where(dx0, torch.ones_like(dx), dx)) * df)
    f = torch.where(x < xp[0], fp[0], f)
    return torch.where(x > xp[-1], fp[-1], f)


def _inv_cdf_grid(eps, lmax: int, dtype, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """(cdf, angle) grid of the inverse-CDF sampler over ``[0, min(8 sqrt(eps), pi)]``."""
    eps = torch.as_tensor(eps, dtype=dtype, device=device)
    omg_range = torch.clamp(8.0 * torch.sqrt(eps), max=math.pi)
    X = torch.linspace(0.0, 1.0, _GRID_N, dtype=dtype, device=device) * omg_range
    Y = igso3_angle_density(X, eps, lmax=lmax) * haar_measure_angle(X)
    cdf = torch.cumsum(Y, dim=0)
    return cdf / cdf[-1], X


def igso3_draws(n: int, generator: Optional[torch.Generator], dtype, device) -> Dict[str, torch.Tensor]:
    """The random numbers of ``n`` IGSO(3) rotations: ``u`` (n,) uniform
    for the angle, ``axis`` (n, 3) Gaussian for the axis."""
    return dict(u=torch.rand(n, generator=generator, dtype=dtype, device=device),
                axis=torch.randn(n, 3, generator=generator, dtype=dtype, device=device))


def sample_igso3_given(draws: Dict[str, torch.Tensor], eps, lmax: int = 100) -> torch.Tensor:
    """IGSO(3) quaternions (n, 4) from :func:`igso3_draws`: the angle by the
    inverse CDF, the axis the normalised Gaussian."""
    u, axis = draws["u"], draws["axis"]
    cdf, X = _inv_cdf_grid(eps, lmax, u.dtype, u.device)
    angle = interp(u, cdf, X)[..., None]
    axis = axis / torch.linalg.norm(axis, dim=-1, keepdim=True)
    return so3.axis_angle_to_quaternion(axis * angle)


def sample_igso3(eps, n: int, generator: Optional[torch.Generator] = None, lmax: int = 100,
                 dtype=torch.float32, device=None) -> torch.Tensor:
    return sample_igso3_given(igso3_draws(n, generator, dtype, device), eps, lmax=lmax)


def r3_isotropic_gaussian_score(x: torch.Tensor, std) -> torch.Tensor:
    std = torch.as_tensor(std, dtype=x.dtype, device=x.device)
    return -x / torch.square(std)


def se3_isotropic_gaussian_score(T: torch.Tensor, eps, std, lmax: int = 100):
    """Body-frame ``(ang, lin)`` score of the IGSO(3) x R^3 kernel at the
    poses ``T``: the linear part rotated into the body frame."""
    q, x = T[..., :4], T[..., 4:]
    ang = igso3_score(q, eps, lmax=lmax)
    lin = so3.quaternion_apply(so3.quaternion_invert(q), r3_isotropic_gaussian_score(x, std))
    return ang, lin


def adjoint_inv_tr_isotropic_se3_score(x_ref: torch.Tensor, ang: torch.Tensor, lin: torch.Tensor):
    """The score transported to the reference point ``x_ref``."""
    return ang + torch.linalg.cross(x_ref.expand_as(lin), lin, dim=-1), lin


def se3_gaussian_draws(n: int, generator: Optional[torch.Generator], dtype, device) -> Dict[str, torch.Tensor]:
    """The random numbers of ``n`` IGSO(3) x R^3 perturbations: those of
    :func:`igso3_draws` and ``x`` (n, 3) Gaussian for the translation."""
    draws = igso3_draws(n, generator, dtype, device)
    draws["x"] = torch.randn(n, 3, generator=generator, dtype=dtype, device=device)
    return draws


def sample_isotropic_se3_gaussian_given(draws: Dict[str, torch.Tensor], eps, std, lmax: int = 100) -> torch.Tensor:
    x = draws["x"] * torch.as_tensor(std, dtype=draws["x"].dtype, device=draws["x"].device)
    return torch.cat([sample_igso3_given(draws, eps, lmax=lmax), x], dim=-1)


def sample_isotropic_se3_gaussian(eps, std, n: int, generator: Optional[torch.Generator] = None, lmax: int = 100,
                                  dtype=torch.float32, device=None) -> torch.Tensor:
    """``n`` IGSO(3) x R^3 perturbations (n, 7)."""
    return sample_isotropic_se3_gaussian_given(se3_gaussian_draws(n, generator, dtype, device), eps, std, lmax=lmax)


def diffuse_isotropic_se3_given(T0: torch.Tensor, eps, std, draws: Dict[str, torch.Tensor],
                                x_ref: Optional[torch.Tensor] = None, lmax: int = 100):
    """Forward-diffuse the poses ``T0`` (nT, 7) about the reference points
    ``x_ref`` (nX, 3) with the ``nX * nT`` perturbations of ``draws``
    (:func:`se3_gaussian_draws`): the analytic body-frame scores, transported
    to the reference points, the perturbation recentred to pivot about them
    and right-multiplied onto ``T0``.  Returns ``(T, delta_T, (ang, lin),
    (ang_ref, lin_ref))``, each with leading shape (nX, nT) ((1, nT) without
    ``x_ref``)."""
    nT = T0.shape[0]
    nX = 1 if x_ref is None else x_ref.shape[0]
    delta_T = sample_isotropic_se3_gaussian_given(draws, eps, std, lmax=lmax)
    ang_ref, lin_ref = se3_isotropic_gaussian_score(delta_T, eps, std, lmax=lmax)
    delta_T = delta_T.reshape(nX, nT, 7)
    ang_ref = ang_ref.reshape(nX, nT, 3)
    lin_ref = lin_ref.reshape(nX, nT, 3)
    if x_ref is not None:
        xr = x_ref[:, None, :]
        ang, lin = adjoint_inv_tr_isotropic_se3_score(xr, ang_ref, lin_ref)
        q = delta_T[..., :4]
        delta_T = torch.cat([q, delta_T[..., 4:] + xr - so3.quaternion_apply(q, xr)], dim=-1)
    else:
        ang, lin = ang_ref, lin_ref
    T = so3.multiply_se3(T0[None, :, :], delta_T)
    return T, delta_T, (ang, lin), (ang_ref, lin_ref)


def diffuse_isotropic_se3(T0: torch.Tensor, eps, std, x_ref: Optional[torch.Tensor] = None, lmax: int = 100,
                          generator: Optional[torch.Generator] = None):
    n = T0.shape[0] * (1 if x_ref is None else x_ref.shape[0])
    draws = se3_gaussian_draws(n, generator, T0.dtype, T0.device)
    return diffuse_isotropic_se3_given(T0, eps, std, draws, x_ref=x_ref, lmax=lmax)


# float64 numpy oracles (tests only)
def igso3_angle_density_np(omg: np.ndarray, eps: float, lmax: Optional[int] = None) -> np.ndarray:
    if lmax is None:
        lmax = determine_lmax(eps)
    omg = np.asarray(omg, dtype=np.float64)[..., None]
    l = np.arange(lmax + 1, dtype=np.float64)
    small = 1e-20
    terms = (
        (2 * l + 1)
        * np.exp(-l * (l + 1) * eps)
        * (np.sin((l + 0.5) * omg) + (l + 0.5) * small)
        / (np.sin(omg / 2.0) + 0.5 * small)
    )
    return np.clip(terms.sum(-1), 0.0, None)


def igso3_score_np(q: np.ndarray, eps: float, lmax: Optional[int] = None) -> np.ndarray:
    if lmax is None:
        lmax = determine_lmax(eps)
    q = np.asarray(q, dtype=np.float64)
    small = 1e-20
    versor = np.clip(q[..., 0], -1.0, 1.0)
    omg = np.arccos(versor) * 2.0
    l = np.arange(lmax + 1, dtype=np.float64)
    omg_ = omg[..., None]
    lie_deriv_cos_omg = -2.0 * versor[..., None] * q[..., 1:]
    char_deriv = (
        (l + 1) * np.sin(l * omg_) - l * np.sin((l + 1) * omg_) + small * l * (l + 1) * (2 * l + 1)
    ) / ((1.0 - np.cos(omg_)) * np.sin(omg_) + 3.0 * small)
    deriv = ((2 * l + 1) * np.exp(-l * (l + 1) * eps) * char_deriv).sum(-1, keepdims=True) * lie_deriv_cos_omg
    prob = igso3_angle_density_np(omg, eps, lmax)[..., None]
    return (deriv / (prob + 1e-30)) * (prob > 0.0)
