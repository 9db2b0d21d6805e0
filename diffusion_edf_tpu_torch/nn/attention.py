"""Equivariant graph attention over padded neighbourhoods (counterpart of
the JAX package's ``nn/attention.py``, inference only).

The message lanes come in i-major order (``nn/tp.py::im_perm`` of
``irreps_input``), as ``EquiformerBlock``'s linears emit them.  Per edge slot:
radial-MLP-weighted depthwise TP of the (src+dst) message with the edge SH
-> alpha logits (linear, SmoothLeakyReLU, per-head dot) and value
(gate, second depthwise TP, linear); then a masked softmax over the K axis,
the weighted sum and the output projection.

The per-edge segment has four implementations, chosen by ``edge_impl``:

* ``"plain"``: the module path, one PyTorch op per step;
* ``"kernel"``: :func:`..nn.edge_kernel.edge_kernel` in float32, then the
  masked softmax in PyTorch;
* ``"kernel_bf16"``: the same kernel in its selective mixed precision: only
  the message is cast to bfloat16 (and ``W_av`` with it); logits come back
  float32, the value bfloat16 and is widened to float32 for the softmax tail;
* ``"fused"``: :func:`..nn.fused_attention.fused_attention`, which takes the
  place of everything between the message and the output projection, the
  softmax included.

Each wrapper launches its hand-written CUDA kernel on CUDA tensors and runs
its plain version on CPU tensors.  ``edge_impl=None`` picks ``"kernel"`` for
CUDA tensors and ``"plain"`` for CPU tensors.  All read the same parameters.
"""
from __future__ import annotations

import functools
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from ..geom.irreps import Irreps, multiply_irreps, sort_irreps_even_first
from .edge_kernel import build_edge_plan, edge_kernel, pack_radial, prepare_weights, weights_bf16
from .fused_attention import fused_attention
from .layers import GateFromIrreps, IrrepsLinear, irreps2gate, scalar_silu
from .radial import RadialProfile
from .tp import cm_eligible, cm_input_perm, dtp_instructions, im_perm
from .tp_modules import DepthwiseTP, SeparableFCTP
from .util import cached, constant, smooth_leaky_relu, smooth_leaky_relu_norm

__all__ = ["GraphAttention", "attn_heads_irreps", "EDGE_IMPLS"]

EDGE_IMPLS = ("kernel", "kernel_bf16", "fused", "plain")


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
        edge_impl: Optional[str] = None,
    ):
        super().__init__()
        assert edge_impl is None or edge_impl in EDGE_IMPLS, edge_impl
        self.edge_impl = edge_impl
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
        self.plan = build_edge_plan(
            prog1, dtp_instructions(irreps_mid, irreps_edge, irreps_attn), irreps_mid, H, ma, irreps_attn
        )

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

    def _kernel_weights_bf16(self):
        weights, rad = self._kernel_weights()
        return weights_bf16(weights), rad

    def forward(
        self,
        message: torch.Tensor,  # (Nd, K, F_in) i-major
        edge_attr: torch.Tensor,  # (Nd, K, sh)
        edge_scalars: torch.Tensor,  # (Nd, K, S)
        edge_mask: torch.Tensor,  # (Nd, K) bool
        edge_pre_attn_logit: Optional[torch.Tensor] = None,  # (Nd, K)
        edge_post_attn: Optional[torch.Tensor] = None,  # (Nd, K)
    ) -> torch.Tensor:
        impl = self.edge_impl or ("kernel" if message.is_cuda else "plain")
        nd, nk = message.shape[:2]
        H = self.H
        if impl == "fused":
            weights, rad = cached(self, "edge_weights", list(self.parameters()), self._kernel_weights)
            head_of_col = _head_of_col(self.irreps_head, H, self.irreps_attn.dim)
            attn = fused_attention(self.plan, head_of_col, message, edge_attr, edge_scalars, edge_mask,
                                   edge_pre_attn_logit, edge_post_attn, weights, rad)
            return self.proj(attn)
        msg2 = message.reshape(nd * nk, -1)
        attr2 = edge_attr.reshape(nd * nk, -1)
        scal2 = edge_scalars.reshape(nd * nk, -1)
        if impl == "kernel":
            weights, rad = cached(self, "edge_weights", list(self.parameters()), self._kernel_weights)
            logits, val = edge_kernel(self.plan, msg2, attr2, scal2, weights, rad)
            log_alpha = logits.reshape(nd, nk, H).transpose(1, 2)
            val = val.reshape(nd, nk, -1)
        elif impl == "kernel_bf16":
            weights, rad = cached(self, "edge_weights_bf16", list(self.parameters()), self._kernel_weights_bf16)
            logits, val = edge_kernel(self.plan, msg2.to(torch.bfloat16), attr2, scal2, weights, rad)
            log_alpha = logits.reshape(nd, nk, H).transpose(1, 2)
            val = val.reshape(nd, nk, -1).to(message.dtype)
        else:
            w = self.sep_act_rad(scal2)
            mid = self.sep_act_dtp(msg2, attr2, w, component_major=True, x_component_major=True)
            combined = self.sep_alpha_value(mid)
            ma = self.mul_alpha
            la = smooth_leaky_relu(combined[..., :ma]) * smooth_leaky_relu_norm()
            log_alpha = torch.einsum("nkm,mh->nhk", la.reshape(nd, nk, ma), self._dmat())
            val_pre = combined[..., ma:]
            val = scalar_silu(val_pre) if self.gate is None else self.gate(val_pre)
            val = self.sep_value(val, attr2).reshape(nd, nk, -1)

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

        attn_hf = torch.einsum("nhk,nkf->nhf", alpha, val)
        key = (self.irreps_head, H, self.irreps_attn.dim)
        Hsel = constant(("head_select",) + key, lambda: _head_select(*key), attn_hf)
        attn = torch.einsum("nhf,hf->nf", attn_hf, Hsel)
        return self.proj(attn)
