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

With ``query_shard_axes`` (e.g. ``("data", "model")``), the nT*nQ query
rows of every request are split into contiguous blocks over those axes of
the active mesh (``parallel/mesh.py::use_mesh``), padded to a multiple of
the shard count as ``shard_batch`` pads: each rank evaluates the
tensor field and the prescore products on its rows against the replicated
scene, and the per-pose sums over query points add the ranks' partial sums
(``reduce_from_shards``); the poses enter the per-row work through
``copy_to_shards``, so the critic's score (the gradient of its energy)
sums every rank's share.  The padding rows are dropped before the sums.
Up to summation order, the result is the unsharded one.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from ..data import FeaturedPoints
from ..geom import so3, wigner
from ..geom.irreps import Irreps
from ..nn.radial import Dense, SinusoidalPositionEmbeddings
from ..nn.tp_modules import SeparableFCTP
from ..nn.util import constant
from ..parallel.mesh import copy_to_shards, current_mesh, reduce_from_shards, shard_batch
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
        query_shard_axes: Optional[Sequence[str]] = None,
    ):
        super().__init__()
        self.query_shard_axes = tuple(query_shard_axes) if query_shard_axes else None
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

    def _group(self):
        """The process group that shares the query rows (None unsharded)."""
        return current_mesh().group(self.query_shard_axes) if self.query_shard_axes else None

    def _rows(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's block of the pose-major nT*nQ query rows (axis 1 of
        ``x``), the rows padded to a multiple of the shard count as
        ``shard_batch`` pads; ``x`` itself without ``query_shard_axes``."""
        if not self.query_shard_axes:
            return x
        return shard_batch(current_mesh(), x, self.query_shard_axes, dim=1)[0]

    def _all_rows(self, x: torch.Tensor, nT: int, nQ: int) -> torch.Tensor:
        """(R, rows of this rank, ...) -> (R, nT, nQ, ...): every row, zeros
        on the other ranks' rows (and the padding dropped)."""
        r, rest = x.shape[0], x.shape[2:]
        if self.query_shard_axes:
            mesh = current_mesh()
            blk, a = x.shape[1], mesh.index(self.query_shard_axes) * x.shape[1]
            n_pad = blk * mesh.axis_size(self.query_shard_axes)
            x = torch.cat([x.new_zeros(r, a, *rest), x, x.new_zeros(r, n_pad - a - blk, *rest)], dim=1)
            x = x.narrow(1, 0, nT * nQ)
        return x.reshape(r, nT, nQ, *rest)

    def field_at_poses(
        self,
        Ts: torch.Tensor,  # (R, nT, 7)
        key_pcd_multiscale: List[FeaturedPoints],  # stacked over R
        query_pcd: FeaturedPoints,  # stacked over R
        time: torch.Tensor,  # (R, nT)
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """``(key_features (R*n, Fk), f_t (R*n, Fq))`` on this rank's n of
        every request's nT*nQ query rows (pose-major; all of them without
        ``query_shard_axes``): the key field at the moved query points and
        the rotated query features, every request's poses moving its own
        query cloud in its own key field."""
        assert Ts.ndim == 3 and Ts.shape[-1] == 7
        r, nT, nQ = Ts.shape[0], Ts.shape[1], query_pcd.n
        time_enc = self.time_enc(time)
        q = Ts[..., :4]
        x_t = so3.transform_points(query_pcd.x[:, None], Ts)  # (R, nT, nQ, 3)
        f_t = wigner.rotate_irreps(self.irreps_query, query_pcd.f, q)  # (R, nT, nQ, Fq)
        x_rows = self._rows(x_t.reshape(r, nT * nQ, 3))
        query_moved = FeaturedPoints(
            x=x_rows,
            f=Ts.new_zeros(r, x_rows.shape[1], 0),
            mask=self._rows(query_pcd.mask[:, None, :].expand(r, nT, nQ).reshape(r, nT * nQ)),
        )
        ctx = None
        if self.edge_time_encoding:
            D = self.time_emb_dim
            ctx = [self._rows(mlp(time_enc)[:, :, None, :].expand(r, nT, nQ, D).reshape(r, nT * nQ, D)).reshape(-1, D)
                   for mlp in self.time_mlps]
        key_features = self.key_tensor_field(query_moved, key_pcd_multiscale, context_emb=ctx).f
        return key_features, self._rows(f_t.reshape(r, nT * nQ, -1)).reshape(r * x_rows.shape[1], -1)


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
        group = self._group()
        Ts = copy_to_shards(Ts, group)
        key_features, f_t_flat = self.field_at_poses(Ts, key_pcd_multiscale, query_pcd, time)
        lin_vel, ang_spin = (self._all_rows(tp(key_features, f_t_flat)[..., 1:].reshape(r, -1, self.n_pre, 3)
                                            .mean(dim=-2), nT, nQ) for tp in self.vel_tps)

        qinv = so3.quaternion_invert(Ts[..., :4])[:, :, None, :]
        lin_vel = so3.quaternion_apply(qinv, lin_vel)
        ang_spin = so3.quaternion_apply(qinv, ang_spin)
        ang_orbital = torch.linalg.cross(
            (query_pcd.x[:, None, :, :] / self.lin_mult).expand_as(lin_vel), lin_vel, dim=-1
        )
        qw = torch.where(query_pcd.mask, query_pcd.w, torch.zeros_like(query_pcd.w))
        lin = torch.einsum("rq,rtqi->rti", qw, lin_vel)
        ang = torch.einsum("rq,rtqi->rti", qw, ang_orbital + ang_spin)
        return reduce_from_shards(ang, group), reduce_from_shards(lin, group)


class EbmScoreModelHead(_FieldHead):
    """Energy-based critic head: per-pose energy ``(R, nT)``, the mean
    squared difference of the key field and the moved query features per
    query point, weighted by the query weights under the query mask."""

    def forward(self, Ts, key_pcd_multiscale, query_pcd, time) -> torch.Tensor:
        r, nT, nQ = Ts.shape[0], Ts.shape[1], query_pcd.n
        group = self._group()
        Ts = copy_to_shards(Ts, group)
        key_features, f_t_flat = self.field_at_poses(Ts, key_pcd_multiscale, query_pcd, time)
        diff2 = torch.square(key_features - f_t_flat).sum(dim=-1) * (1.0 / self.irreps_key.dim)
        qw = torch.where(query_pcd.mask, query_pcd.w, torch.zeros_like(query_pcd.w))
        return reduce_from_shards(torch.einsum("rq,rtq->rt", qw, self._all_rows(diff2.reshape(r, -1), nT, nQ)), group)


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
