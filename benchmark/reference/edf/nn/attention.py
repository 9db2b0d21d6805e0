"""Equivariant graph attention over padded neighbourhoods: the program's
``nn/attention.py`` copied with its plain edge segment only, on one device.

The message lanes come in i-major order (``nn/tp.py::im_perm`` of
``irreps_input``), as ``EquiformerBlock``'s linears emit them.  Per edge slot:
radial-MLP-weighted depthwise TP of the (src+dst) message with the edge SH
-> alpha logits (linear, SmoothLeakyReLU, per-head dot) and value
(gate, second depthwise TP, linear); then a masked softmax over the K axis,
the weighted sum and the output projection.

With ``kept_only`` set, the per-edge segment runs on the slots the mask keeps
and the others read 0, as the program's edge kernel does; the softmax then
gives the same result.

In ``train()`` mode the attention weights are dropped with probability
``alpha_drop`` after the softmax, and with ``proj_drop > 0`` whole irreps of
the output; the keep masks come from ``dropout_generator``.
"""
from __future__ import annotations

import functools
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from ..geom.irreps import Irreps, multiply_irreps, sort_irreps_even_first
from .edge_plan import build_edge_plan, pack_radial, prepare_weights
from .layers import EquivariantDropout, GateFromIrreps, IrrepsLinear, irreps2gate, keep_mask, scalar_silu
from .radial import RadialProfile
from .tp import cm_eligible, cm_input_perm, dtp_instructions, im_perm
from .tp_modules import DepthwiseTP, SeparableFCTP
from .util import constant, smooth_leaky_relu, smooth_leaky_relu_norm

__all__ = ["GraphAttention", "attn_heads_irreps"]


def attn_heads_irreps(irreps_head: Irreps, num_heads: int) -> Irreps:
    """``sort_even_first(irreps_head * H).simplify()``."""
    rep = Irreps([(mul * num_heads, ir) for mul, ir in Irreps(irreps_head)])
    s, _, _ = sort_irreps_even_first(rep)
    return s.simplify()


@functools.lru_cache(maxsize=None)
def _head_select(irreps_head: Irreps, H: int, dim: int) -> np.ndarray:
    """0/1 (H, attn_dim): lane f of the attention output takes head h(f)."""
    Hsel = np.zeros((H, dim))
    off = 0
    for mul, ir in irreps_head:
        blk = mul * ir.dim
        for h in range(H):
            Hsel[h, off + h * blk : off + (h + 1) * blk] = 1.0
        off += H * blk
    return Hsel


@functools.lru_cache(maxsize=None)
def _head_of_col(irreps_head: Irreps, H: int, dim: int) -> Tuple[int, ...]:
    """The head h(f) of every lane f of the attention output."""
    return tuple(int(h) for h in _head_select(irreps_head, H, dim).argmax(axis=0))


class GraphAttention(nn.Module):
    def __init__(
        self,
        irreps_input,
        irreps_edge_attr,
        irreps_output,
        fc_neurons: Sequence[int],
        num_heads: int,
        irreps_head=None,
        alpha_drop: float = 0.1,
        proj_drop: float = 0.0,
    ):
        super().__init__()
        self.kept_only = False  # True: the segment on the kept slots only (work.py counts its operations)
        self.alpha_drop = float(alpha_drop)
        self.dropout_generator: Optional[torch.Generator] = None
        irreps_input = self.irreps_input = Irreps(irreps_input)
        irreps_mid = self.irreps_mid = irreps_input
        irreps_edge = Irreps(irreps_edge_attr)
        H = self.H = num_heads
        irreps_head = self.irreps_head = (
            Irreps(irreps_head) if irreps_head is not None else multiply_irreps(irreps_mid, 1.0 / H, strict=True)
        )
        irreps_attn = self.irreps_attn = attn_heads_irreps(irreps_head, H)
        ma = self.mul_alpha = irreps_attn.mul_0
        self.mul_alpha_head = ma // H
        assert self.mul_alpha_head * H == ma

        self.sep_act_dtp = DepthwiseTP(irreps_input, irreps_edge, irreps_mid)
        prog1 = self.sep_act_dtp.program
        self.sep_act_rad = RadialProfile(tuple(fc_neurons) + (prog1.weight_numel,))
        assert cm_eligible(prog1), "edge attributes must be multiplicity-1 (spherical harmonics)"
        s, g, t = irreps2gate(irreps_mid)
        val_out_irreps = irreps_mid if g.dim == 0 else (s + g + t).simplify()
        # the gate output must read as irreps_mid (scalars first)
        assert tuple(Irreps(list(s) + list(t))) == tuple(irreps_mid), (s, t, irreps_mid)
        out_perm = tuple(range(ma)) + tuple(ma + p for p in im_perm(val_out_irreps))
        self.sep_alpha_value = IrrepsLinear(
            prog1.irreps_out,
            Irreps(f"{ma}x0e") + val_out_irreps,
            input_perm=cm_input_perm(prog1),
            output_perm=out_perm,
        )
        self.alpha_dot = nn.Parameter(torch.empty(H, self.mul_alpha_head))
        self.gate = GateFromIrreps(irreps_mid, component_major=True) if g.dim else None
        self.sep_value = SeparableFCTP(
            irreps_mid, irreps_edge, irreps_attn,
            use_activation=False, x_component_major=True,
        )
        self.proj = IrrepsLinear(irreps_attn, Irreps(irreps_output))
        if proj_drop > 0.0:
            self.proj_drop = EquivariantDropout(irreps_output, proj_drop)
        self.plan = build_edge_plan(
            prog1, dtp_instructions(irreps_mid, irreps_edge, irreps_attn), irreps_mid, H, ma, irreps_attn
        )
        self.eval()  # deterministic until train(), as the JAX module's deterministic=True default

    def _dmat(self) -> torch.Tensor:
        """Block-diagonal (mul_alpha, H) matrix of the per-head alpha dot."""
        ma, mah = self.mul_alpha, self.mul_alpha_head
        D = self.alpha_dot.new_zeros(ma, self.H)
        for h in range(self.H):
            D[h * mah : (h + 1) * mah, h] = self.alpha_dot[h]
        return D

    def _kernel_weights(self):
        W_av, b_av = self.sep_alpha_value.materialize()
        w_tp2, W_lin2, b_lin2 = self.sep_value.materialize()
        weights = prepare_weights(self.plan, W_av, b_av, self._dmat(), w_tp2, W_lin2, b_lin2)
        return weights, pack_radial(*self.sep_act_rad.materialize())

    def forward(
        self,
        message: torch.Tensor,  # (Nd, K, F_in) i-major
        edge_attr: torch.Tensor,  # (Nd, K, sh)
        edge_scalars: torch.Tensor,  # (Nd, K, S)
        edge_mask: torch.Tensor,  # (Nd, K) bool
        edge_pre_attn_logit: Optional[torch.Tensor] = None,  # (Nd, K)
        edge_post_attn: Optional[torch.Tensor] = None,  # (Nd, K)
    ) -> torch.Tensor:
        nd, nk = message.shape[:2]
        H = self.H
        msg2 = message.reshape(nd * nk, -1)
        attr2 = edge_attr.reshape(nd * nk, -1)
        scal2 = edge_scalars.reshape(nd * nk, -1)
        kept = edge_mask.reshape(-1).nonzero()[:, 0] if self.kept_only else None
        if kept is not None:  # the slots the mask keeps: the segment's work as the edge kernel does it
            msg2, attr2, scal2 = msg2[kept], attr2[kept], scal2[kept]
        w = self.sep_act_rad(scal2)
        mid = self.sep_act_dtp(msg2, attr2, w, component_major=True, x_component_major=True)
        combined = self.sep_alpha_value(mid)
        ma = self.mul_alpha
        la = smooth_leaky_relu(combined[..., :ma]) * smooth_leaky_relu_norm()
        val_pre = combined[..., ma:]
        val = scalar_silu(val_pre) if self.gate is None else self.gate(val_pre)
        val = self.sep_value(val, attr2)
        if kept is None:
            log_alpha = torch.einsum("nkm,mh->nhk", la.reshape(nd, nk, ma), self._dmat())
            val = val.reshape(nd, nk, -1)
        else:
            logits = la @ self._dmat()
            log_alpha = logits.new_zeros(nd * nk, H).index_copy_(0, kept, logits).reshape(nd, nk, H).transpose(1, 2)
            val = val.new_zeros(nd * nk, val.shape[-1]).index_copy_(0, kept, val).reshape(nd, nk, -1)

        # masked softmax over K
        if edge_pre_attn_logit is not None:
            log_alpha = log_alpha + edge_pre_attn_logit[..., None, :]
        mask = edge_mask[..., None, :]
        log_alpha = torch.where(mask, log_alpha, torch.full_like(log_alpha, -1e30))
        m = torch.clamp(log_alpha.amax(dim=-1, keepdim=True).detach(), min=-0.5e30)
        ea = torch.where(mask, torch.exp(log_alpha - m), torch.zeros_like(log_alpha))
        # floor 0.5, not a tiny eps: a row with a valid edge has denom >= 1,
        # so the floor only engages on all-masked rows (alpha = 0 there)
        alpha = ea / torch.clamp(ea.sum(dim=-1, keepdim=True), min=0.5)
        if edge_post_attn is not None:
            alpha = alpha * edge_post_attn[..., None, :]
        if self._dropping():
            keep = keep_mask(alpha.shape, self.alpha_drop, self.dropout_generator, alpha.device)
            alpha = alpha * keep / (1.0 - self.alpha_drop)

        attn_hf = torch.einsum("nhk,nkf->nhf", alpha, val)
        key = (self.irreps_head, H, self.irreps_attn.dim)
        Hsel = constant(("head_select",) + key, lambda: _head_select(*key), attn_hf)
        attn = torch.einsum("nhf,hf->nf", attn_hf, Hsel)
        return self._project(attn)

    def _dropping(self) -> bool:
        return self.training and self.alpha_drop > 0.0

    def _project(self, attn: torch.Tensor) -> torch.Tensor:
        out = self.proj(attn)
        return self.proj_drop(out) if hasattr(self, "proj_drop") else out
