"""SE(3) bi-equivariant heads over the key tensor field (counterpart of the
JAX package's ``models/score_head.py``): the denoising score head
``ScoreModelHead`` and the energy-based critic head ``EbmScoreModelHead``.

Per pose batch (R requests x nT poses x nQ query points; the clouds come
stacked over the R requests): time encoding -> per-scale time
MLPs; the query cloud is moved by every pose (positions by SE(3), features
by Wigner-D); the key tensor field is evaluated at the R*nT*nQ moved points
in one call.
The score head combines field and query features into prescore vectors with
two SeparableFCTPs; frame change, orbital term and query-weighted sums give
(ang, lin).  The critic head takes the query-weighted mean squared difference
of field and moved query features as the energy of each pose.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from ..data import FeaturedPoints
from ..geom import so3, wigner
from ..geom.irreps import Irreps
from ..nn.radial import Dense, SinusoidalPositionEmbeddings
from ..nn.tp_modules import SeparableFCTP
from ..nn.util import constant
from .tensor_field import MultiscaleTensorField

__all__ = ["ScoreModelHead", "EbmScoreModelHead", "ebm_score", "quat_L", "QUAT_L_INDICES", "QUAT_L_FACTOR"]

# dq = L(q) @ ang with L[i, a] = q[QUAT_L_INDICES[i][a]] * QUAT_L_FACTOR[i][a]
QUAT_L_INDICES = ((1, 2, 3), (0, 3, 2), (3, 0, 1), (2, 1, 0))
QUAT_L_FACTOR = ((-0.5, -0.5, -0.5), (0.5, -0.5, 0.5), (0.5, 0.5, -0.5), (-0.5, 0.5, 0.5))


def quat_L(q: torch.Tensor) -> torch.Tensor:
    """(..., 4) -> (..., 4, 3) with dq = L @ ang_disp."""
    idx = constant("quat_L_idx", lambda: np.asarray(QUAT_L_INDICES), q, dtype=torch.long)
    return q[..., idx] * constant("quat_L_fac", lambda: np.asarray(QUAT_L_FACTOR), q)


class _TimeMLP(nn.Module):
    def __init__(self, dims: Sequence[int]):
        """``dims``: ``time_emb_mlp`` (input width first)."""
        super().__init__()
        self.n = len(dims) - 1
        for i in range(self.n):
            self.add_module(f"dense{i}", Dense(dims[i], dims[i + 1]))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.n):
            x = getattr(self, f"dense{i}")(x)
            if i != self.n - 1:
                x = torch.nn.functional.silu(x)
        return x


class _FieldHead(nn.Module):
    """What both heads share: the time encoding, the key tensor field with
    its per-scale time MLPs, and the field evaluated at the query cloud moved
    by every pose.  ``time_mlps`` is a list of modules whose flax counterpart
    is one module with stacked params (``nn.vmap``); the weight loader
    unstacks them by index."""

    def __init__(
        self,
        max_time: float,
        time_emb_mlp: Sequence[int],
        key_tensor_field_kwargs: Dict,
        irreps_query_edf,
        lin_mult: float,
        ang_mult: float,
        time_enc_n: float = 10000.0,
        edge_time_encoding: bool = True,
        query_time_encoding: bool = False,
    ):
        super().__init__()
        assert not query_time_encoding, "query time encoding is not ported yet (no config in the tree sets it)"
        self.lin_mult, self.ang_mult = lin_mult, ang_mult
        self.edge_time_encoding = edge_time_encoding
        self.irreps_query = Irreps(irreps_query_edf)
        self.irreps_key = Irreps(key_tensor_field_kwargs["irreps_output"])
        self.n_scales = len(key_tensor_field_kwargs["r_cluster_multiscale"])
        self.time_emb_dim = time_emb_mlp[-1]
        self.time_enc = SinusoidalPositionEmbeddings(time_emb_mlp[0], max_time, n=time_enc_n)
        kwargs = dict(key_tensor_field_kwargs)
        kwargs["irreps_query"] = None
        kwargs["edge_context_emb_dim"] = self.time_emb_dim if edge_time_encoding else None
        self.key_tensor_field = MultiscaleTensorField(**kwargs)
        if edge_time_encoding:
            self.time_mlps = nn.ModuleList(_TimeMLP(time_emb_mlp) for _ in range(self.n_scales))

    def field_at_poses(
        self,
        Ts: torch.Tensor,  # (R, nT, 7)
        key_pcd_multiscale: List[FeaturedPoints],  # stacked over R
        query_pcd: FeaturedPoints,  # stacked over R
        time: torch.Tensor,  # (R, nT)
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """``(key_features (R*nT*nQ, Fk), f_t (R*nT*nQ, Fq))``: the key field
        at the moved query points and the rotated query features, every
        request's poses moving its own query cloud in its own key field."""
        assert Ts.ndim == 3 and Ts.shape[-1] == 7
        r, nT, nQ = Ts.shape[0], Ts.shape[1], query_pcd.n
        time_enc = self.time_enc(time)
        q = Ts[..., :4]
        x_t = so3.transform_points(query_pcd.x[:, None], Ts)  # (R, nT, nQ, 3)
        f_t = wigner.rotate_irreps(self.irreps_query, query_pcd.f, q)  # (R, nT, nQ, Fq)
        query_moved = FeaturedPoints(
            x=x_t.reshape(r, nT * nQ, 3),
            f=Ts.new_zeros(r, nT * nQ, 0),
            mask=query_pcd.mask[:, None, :].expand(r, nT, nQ).reshape(r, nT * nQ),
        )
        ctx = None
        if self.edge_time_encoding:
            ctx = [
                mlp(time_enc)[:, :, None, :].expand(r, nT, nQ, self.time_emb_dim).reshape(r * nT * nQ, -1)
                for mlp in self.time_mlps
            ]
        key_features = self.key_tensor_field(query_moved, key_pcd_multiscale, context_emb=ctx).f
        return key_features, f_t.reshape(r * nT * nQ, -1)


class ScoreModelHead(_FieldHead):
    """``vel_tps`` is, like ``time_mlps``, a list of modules whose flax
    counterpart has stacked params."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.n_pre = (self.irreps_query.count((1, 1)) + self.irreps_key.count((1, 1))) // 2
        irreps_pre = Irreps(f"1x0e+{self.n_pre}x1e")
        self.vel_tps = nn.ModuleList(
            SeparableFCTP(self.irreps_key, self.irreps_query, irreps_pre, use_activation=True)
            for _ in range(2)
        )

    def forward(self, Ts, key_pcd_multiscale, query_pcd, time) -> Tuple[torch.Tensor, torch.Tensor]:
        """``(ang (R, nT, 3), lin (R, nT, 3))`` score of every pose of every
        request (see :meth:`field_at_poses`)."""
        r, nT, nQ = Ts.shape[0], Ts.shape[1], query_pcd.n
        q = Ts[..., :4]
        key_features, f_t_flat = self.field_at_poses(Ts, key_pcd_multiscale, query_pcd, time)
        lin_vel, ang_spin = (tp(key_features, f_t_flat)[..., 1:] for tp in self.vel_tps)
        lin_vel = lin_vel.reshape(r, nT, nQ, self.n_pre, 3).mean(dim=-2)
        ang_spin = ang_spin.reshape(r, nT, nQ, self.n_pre, 3).mean(dim=-2)

        qinv = so3.quaternion_invert(q)[:, :, None, :]
        lin_vel = so3.quaternion_apply(qinv, lin_vel)
        ang_spin = so3.quaternion_apply(qinv, ang_spin)
        ang_orbital = torch.linalg.cross(
            (query_pcd.x[:, None, :, :] / self.lin_mult).expand_as(lin_vel), lin_vel, dim=-1
        )
        qw = torch.where(query_pcd.mask, query_pcd.w, torch.zeros_like(query_pcd.w))
        lin = torch.einsum("rq,rtqi->rti", qw, lin_vel)
        ang = torch.einsum("rq,rtqi->rti", qw, ang_orbital + ang_spin)
        return ang, lin


class EbmScoreModelHead(_FieldHead):
    """Energy-based critic head: per-pose energy ``(R, nT)``, the mean
    squared difference of the key field and the moved query features per
    query point, weighted by the query weights under the query mask."""

    def forward(self, Ts, key_pcd_multiscale, query_pcd, time) -> torch.Tensor:
        r, nT, nQ = Ts.shape[0], Ts.shape[1], query_pcd.n
        key_features, f_t_flat = self.field_at_poses(Ts, key_pcd_multiscale, query_pcd, time)
        diff2 = torch.square(key_features - f_t_flat).sum(dim=-1) * (1.0 / self.irreps_key.dim)
        qw = torch.where(query_pcd.mask, query_pcd.w, torch.zeros_like(query_pcd.w))
        return torch.einsum("rq,rtq->rt", qw, diff2.reshape(r, nT, nQ))


def ebm_score(apply_energy: Callable[[torch.Tensor], torch.Tensor], Ts: torch.Tensor, ang_mult: float,
              lin_mult: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(ang, lin)`` score of an energy-based head: the gradient of ``-E``
    with respect to the poses ``Ts`` (..., 7), mapped through the quaternion
    L-matrix (angular) and into the body frame (linear).  While grad mode is
    on the gradient keeps its graph, so a loss on the score backpropagates to
    the parameters (second order); under ``torch.no_grad()`` it is computed
    all the same and returned detached."""
    keep_graph = torch.is_grad_enabled()
    with torch.enable_grad():
        T = Ts if Ts.requires_grad else Ts.detach().requires_grad_(True)
        (grad,) = torch.autograd.grad(-apply_energy(T).sum(), T, create_graph=keep_graph)
    q = Ts[..., :4]
    ang = torch.einsum("...ia,...i->...a", quat_L(q), grad[..., :4]) * ang_mult
    lin = so3.quaternion_apply(so3.quaternion_invert(q), grad[..., 4:]) * lin_mult
    return ang, lin
