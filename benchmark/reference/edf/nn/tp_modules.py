"""Tensor-product modules: depthwise TP, SeparableFCTP (DTP + linear +
gate) and the fully connected TP with its gated form (no shipped config
uses the last two); counterpart of the JAX package's ``nn/tp_modules.py``."""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..geom.irreps import Irreps
from .layers import GateFromIrreps, IrrepsLinear, irreps2gate, scalar_silu
from .tp import apply_dtp, apply_dtp_cm, apply_fctp, cm_eligible, cm_input_perm, dtp_instructions, fctp_instructions

__all__ = ["DepthwiseTP", "SeparableFCTP", "FullyConnectedTP", "FullyConnectedTPSwishGate"]


class DepthwiseTP(nn.Module):
    """'uvu' TP of node features with edge attributes; weights either internal
    (``tp_weight``, shared) or supplied per row (from a radial MLP)."""

    def __init__(self, irreps_in, irreps_edge, irreps_out_target, internal_weights: bool = False):
        super().__init__()
        self.program = dtp_instructions(Irreps(irreps_in), Irreps(irreps_edge), Irreps(irreps_out_target))
        self.internal_weights = internal_weights
        if internal_weights:
            self.tp_weight = nn.Parameter(torch.empty(self.program.weight_numel))

    @property
    def irreps_out(self) -> Irreps:
        return self.program.irreps_out

    @property
    def weight_numel(self) -> int:
        return self.program.weight_numel

    def forward(
        self,
        x: torch.Tensor,
        edge_attr: torch.Tensor,
        weight: Optional[torch.Tensor] = None,
        component_major: bool = False,
        x_component_major: bool = False,
    ) -> torch.Tensor:
        """``component_major`` emits the layout of :func:`apply_dtp_cm`; the
        consumer folds ``cm_input_perm(self.program)`` into its weights.
        ``x_component_major``: x lanes are in ``im_perm(irreps_in)`` order."""
        if self.internal_weights:
            assert weight is None
            weight = self.tp_weight
        if component_major:
            return apply_dtp_cm(self.program, x, edge_attr, weight, x1_component_major=x_component_major)
        assert not x_component_major
        return apply_dtp(self.program, x, edge_attr, weight)


class SeparableFCTP(nn.Module):
    """DTP with internal (shared) weights + linear (+ gate): the two modes
    inference uses (the attention value path and the score head's twin TPs).
    The radial-weighted mode is ``GraphAttention``'s own first DTP."""

    def __init__(
        self,
        irreps_in,
        irreps_edge,
        irreps_out,
        use_activation: bool = False,
        x_component_major: bool = False,
    ):
        super().__init__()
        self.irreps_out = Irreps(irreps_out)
        self.use_activation = use_activation
        self.x_component_major = x_component_major
        self.dtp = DepthwiseTP(irreps_in, irreps_edge, self.irreps_out, internal_weights=True)
        prog = self.dtp.program
        self.cm = cm_eligible(prog)
        assert not (x_component_major and not self.cm), "i-major input requires the cm path"
        lin_perm = cm_input_perm(prog) if self.cm else None
        out_ir = self.irreps_out
        s, g, t = irreps2gate(out_ir)
        self.gated = use_activation and g.dim > 0
        lin_out = (s + g + t).simplify() if self.gated else out_ir
        self.lin = IrrepsLinear(prog.irreps_out, lin_out, input_perm=lin_perm)
        self.gate = GateFromIrreps(out_ir) if self.gated else None

    def forward(self, x: torch.Tensor, edge_attr: torch.Tensor) -> torch.Tensor:
        mid = self.dtp(x, edge_attr, component_major=self.cm, x_component_major=self.x_component_major)
        h = self.lin(mid)
        if not self.use_activation:
            return h
        return self.gate(h) if self.gated else scalar_silu(h)

    def materialize(self):
        """``(internal TP weight, dense canonical linear W, bias)`` for the
        edge kernel's DTP2 (same params)."""
        assert not self.use_activation
        W, b = self.lin.materialize()
        return self.dtp.tp_weight, W, b


class FullyConnectedTP(nn.Module):
    """'uvw' TP with shared weights (``tp_weight``) and a bias on the scalar
    outputs (``FCTP Rescale``)."""

    def __init__(self, irreps_in1, irreps_in2, irreps_out, use_bias: bool = True):
        super().__init__()
        self.program = fctp_instructions(Irreps(irreps_in1), Irreps(irreps_in2), Irreps(irreps_out))
        self.tp_weight = nn.Parameter(torch.empty(self.program.weight_numel))
        n_scalar = sum(mul for mul, ir in self.program.irreps_out if ir.l == 0 and ir.p == 1)
        self.bias = nn.Parameter(torch.empty(n_scalar)) if use_bias and n_scalar else None

    def forward(self, x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
        out = apply_fctp(self.program, x1, x2, self.tp_weight)
        if self.bias is None:
            return out
        pieces, i, b = [], 0, 0
        for mul, ir in self.program.irreps_out:
            blk = out[..., i : i + mul * ir.dim]
            if ir.l == 0 and ir.p == 1:
                blk = blk + self.bias[b : b + mul]
                b += mul
            pieces.append(blk)
            i += mul * ir.dim
        return torch.cat(pieces, dim=-1)


class FullyConnectedTPSwishGate(nn.Module):
    """A fully connected TP into the gate's layout, then the gated
    nonlinearity to ``irreps_out`` (SiLU alone when it has no gated irreps).
    The TP keeps the flax module's automatic name ``FullyConnectedTP_0``."""

    def __init__(self, irreps_in1, irreps_in2, irreps_out):
        super().__init__()
        out_ir = Irreps(irreps_out)
        s, g, t = irreps2gate(out_ir)
        self.FullyConnectedTP_0 = FullyConnectedTP(irreps_in1, irreps_in2, (s + g + t).simplify() if g.dim else out_ir)
        self.gate = GateFromIrreps(out_ir) if g.dim else None

    def forward(self, x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
        h = self.FullyConnectedTP_0(x1, x2)
        return scalar_silu(h) if self.gate is None else self.gate(h)
