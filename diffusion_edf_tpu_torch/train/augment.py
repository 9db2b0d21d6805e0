"""Per-step demo augmentation on the device (counterpart of the JAX
package's ``train/augment.py``): a random SO(3) frame for the scene (an
exact symmetry of the architecture: the target transports as
``T' = A_s * T * A_g^-1``), Gaussian point jitter, random point dropout
through the validity mask, and colour jitter.  Every op is elementwise or
masked on the padded tensors, so shapes never change.

:func:`augment_draws` makes every random number of one step and
:func:`augment_batch_given` is a deterministic function of them."""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional

import torch

from ..data import FeaturedPoints
from ..geom import so3
from ..nn.util import constant

__all__ = ["AugmentConfig", "augment_draws", "augment_batch_given", "augment_batch"]


class AugmentConfig(NamedTuple):
    """Knobs in model units (cm after the standard rescale).  ``point_keep``
    is the per-point keep probability applied to the validity mask; a falsy
    field disables its augmentation.  ``rotate_grasp`` stays off for the
    standard model families: their queries are anchored in the grasp frame
    and do not co-transform with the grasp cloud, so a grasp-frame rotation
    is not a symmetry of the model."""

    rotate_scene: bool = True
    rotate_grasp: bool = False
    jitter_std: float = 0.25
    point_keep: float = 0.95
    color_std: float = 0.02

    @classmethod
    def from_dict(cls, d) -> "AugmentConfig":
        d = dict(d or {})
        if d.pop("enable", True) is False:
            return cls(False, False, 0.0, 1.0, 0.0)
        unknown = set(d) - set(cls._fields)
        if unknown:
            raise ValueError(f"unknown augment_configs keys: {sorted(unknown)}")
        return cls(**d)


def _masked_centroid(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    w = mask.to(x.dtype)[:, None]
    return torch.sum(x * w, dim=0) / torch.clamp(torch.sum(w), min=1.0)


def _frame_about(q: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """The SE(3) action of rotating by ``q`` about the point ``c``."""
    return torch.cat([q, c - so3.quaternion_apply(q, c)])


def augment_draws(scene: FeaturedPoints, grasp: FeaturedPoints, cfg: AugmentConfig,
                  generator: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
    """The random numbers of one augmentation, for the knobs ``cfg`` turns
    on: Gaussian 4-vectors of the frames' rotations (``rot_scene``,
    ``rot_grasp``), jitter (``jitter_scene``, ``jitter_grasp``), the keep
    masks (``keep_scene``, ``keep_grasp``) and colour noise (``color_scene``,
    ``color_grasp``)."""
    x = scene.x
    draws = {}

    def normal(name, shape):
        draws[name] = torch.randn(shape, generator=generator, dtype=x.dtype, device=x.device)

    if cfg.rotate_scene:
        normal("rot_scene", (4,))
    if cfg.rotate_grasp:
        normal("rot_grasp", (4,))
    if cfg.jitter_std:
        normal("jitter_scene", scene.x.shape)
        normal("jitter_grasp", grasp.x.shape)
    if cfg.point_keep < 1.0:
        for name, pts in (("keep_scene", scene), ("keep_grasp", grasp)):
            draws[name] = torch.rand(pts.mask.shape, generator=generator, device=x.device) < cfg.point_keep
    if cfg.color_std:
        normal("color_scene", scene.f.shape)
        normal("color_grasp", grasp.f.shape)
    return draws


def augment_batch_given(scene: FeaturedPoints, grasp: FeaturedPoints, T_target: torch.Tensor,
                        cfg: AugmentConfig, draws: Dict[str, torch.Tensor]):
    """The augmented ``(scene, grasp, T_target)`` for the numbers of
    :func:`augment_draws`.  The rotations turn each cloud about its masked
    centroid and the target transports exactly; with every knob off this is
    the identity."""
    ident = constant("identity_pose", lambda: [1.0, 0, 0, 0, 0, 0, 0], scene.x)

    def frame(name, pts):
        if name not in draws:
            return ident
        q = so3.standardize_quaternion(so3.normalize_quaternion(draws[name]))
        return _frame_about(q, _masked_centroid(pts.x, pts.mask))

    A_s, A_g = frame("rot_scene", scene), frame("rot_grasp", grasp)

    def move(T, x):
        return so3.quaternion_apply(T[None, :4], x) + T[None, 4:]

    scene_x, grasp_x = move(A_s, scene.x), move(A_g, grasp.x)
    T_new = so3.multiply_se3(A_s[None], so3.multiply_se3(T_target, so3.se3_invert(A_g[None])))
    if cfg.jitter_std:
        scene_x = scene_x + cfg.jitter_std * draws["jitter_scene"]
        grasp_x = grasp_x + cfg.jitter_std * draws["jitter_grasp"]
    scene_mask, grasp_mask = scene.mask, grasp.mask
    if cfg.point_keep < 1.0:
        scene_mask = scene_mask & draws["keep_scene"]
        grasp_mask = grasp_mask & draws["keep_grasp"]
    scene_f, grasp_f = scene.f, grasp.f
    if cfg.color_std:
        scene_f = torch.clamp(scene_f + cfg.color_std * draws["color_scene"], 0.0, 1.0)
        grasp_f = torch.clamp(grasp_f + cfg.color_std * draws["color_grasp"], 0.0, 1.0)
    return (scene.replace(x=scene_x, f=scene_f, mask=scene_mask),
            grasp.replace(x=grasp_x, f=grasp_f, mask=grasp_mask), T_new)


def augment_batch(scene: FeaturedPoints, grasp: FeaturedPoints, T_target: torch.Tensor, cfg: AugmentConfig,
                  generator: Optional[torch.Generator] = None):
    return augment_batch_given(scene, grasp, T_target, cfg, augment_draws(scene, grasp, cfg, generator))
