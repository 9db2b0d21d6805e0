"""Core equivariant layers: irreps linear, layer norm, gate (counterpart of
the JAX package's ``nn/layers.py``)."""
from __future__ import annotations

import functools
from typing import Optional, Tuple

import numpy as np
import torch
from torch import nn

from ..geom.irreps import Irrep, Irreps
from .util import cached, constant, sigmoid_norm, silu_norm

__all__ = [
    "IrrepsLinear",
    "EquivariantLayerNorm",
    "GateFromIrreps",
    "irreps2gate",
    "scalar_silu",
    "norm_sigmoid",
]

_SCALAR = Irrep(0, 1)


def scalar_silu(x: torch.Tensor) -> torch.Tensor:
    """Second-moment-normalized SiLU."""
    return torch.nn.functional.silu(x) * silu_norm()


def norm_sigmoid(x: torch.Tensor) -> torch.Tensor:
    return torch.sigmoid(x) * sigmoid_norm()


class IrrepsLinear(nn.Module):
    """Per-degree linear map with fan-in rescale and scalar bias.  Params
    ``w{oi}_{ir}`` (mul_in, mul_out) are stored as ``U(0, 2)`` draws and used
    as ``(w - 1) / sqrt(mul_in)``; ``b{oi}`` biases the even scalars.  Output
    entries with no matching input degree are zeros (+ bias).

    The layer runs as one product with the dense block-diagonal matrix of
    :meth:`materialize`, cached until the params change.  ``input_perm`` /
    ``output_perm`` fold a lane permutation into it
    (``given[m] == canonical[input_perm[m]]``,
    ``out[m] == canonical_out[output_perm[m]]``)."""

    def __init__(
        self,
        irreps_in,
        irreps_out,
        use_bias: bool = True,
        input_perm: Optional[Tuple[int, ...]] = None,
        output_perm: Optional[Tuple[int, ...]] = None,
    ):
        super().__init__()
        self.irreps_in, self.irreps_out = Irreps(irreps_in), Irreps(irreps_out)
        assert input_perm is None or len(input_perm) == self.irreps_in.dim
        assert output_perm is None or len(output_perm) == self.irreps_out.dim
        self.input_perm, self.output_perm = input_perm, output_perm
        self.in_by_ir = {}
        for ii, (mul, ir) in enumerate(self.irreps_in):
            self.in_by_ir.setdefault(ir, []).append(ii)
        self.w_names = {}
        self.b_names = {}
        for oi, (mul_out, ir) in enumerate(self.irreps_out):
            if ir in self.in_by_ir:
                mul_in = sum(self.irreps_in[ii][0] for ii in self.in_by_ir[ir])
                self.w_names[oi] = (f"w{oi}_{ir}", mul_in)
                self.register_parameter(f"w{oi}_{ir}", nn.Parameter(torch.empty(mul_in, mul_out)))
            if use_bias and ir == _SCALAR:
                self.b_names[oi] = f"b{oi}"
                self.register_parameter(f"b{oi}", nn.Parameter(torch.empty(mul_out)))

    def materialize(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """The effective dense ``(W (dim_in, dim_out), bias (dim_out,))`` in
        canonical layouts, built from the same params."""
        irreps_in, irreps_out = self.irreps_in, self.irreps_out
        ref = next(iter(self.parameters()))
        W = ref.new_zeros(irreps_in.dim, irreps_out.dim)
        bias = ref.new_zeros(irreps_out.dim)
        in_slices, out_slices = irreps_in.slices(), irreps_out.slices()
        for oi, (mul_out, ir) in enumerate(irreps_out):
            d = ir.dim
            if oi in self.w_names:
                name, mul_in = self.w_names[oi]
                w = (getattr(self, name) - 1.0) / float(np.sqrt(mul_in))
                eye = torch.eye(d, dtype=w.dtype, device=w.device)
                u0 = 0
                for ii in self.in_by_ir[ir]:
                    mi = irreps_in[ii][0]
                    blk = torch.einsum("uw,de->udwe", w[u0 : u0 + mi], eye).reshape(mi * d, mul_out * d)
                    W[in_slices[ii].start : in_slices[ii].start + mi * d,
                      out_slices[oi].start : out_slices[oi].start + mul_out * d] = blk
                    u0 += mi
            if oi in self.b_names:
                s = out_slices[oi].start
                bias[s : s + mul_out] = getattr(self, self.b_names[oi])
        return W, bias

    def _dense(self) -> Tuple[torch.Tensor, torch.Tensor]:
        def build():
            W, bias = self.materialize()
            if self.input_perm is not None:
                W = W[list(self.input_perm), :]
            if self.output_perm is not None:
                op = list(self.output_perm)
                W, bias = W[:, op], bias[op]
            return W.contiguous(), bias.contiguous()

        return cached(self, "dense", list(self.parameters()), build)

    def forward(self, f: torch.Tensor) -> torch.Tensor:
        assert f.shape[-1] == self.irreps_in.dim, (f.shape, self.irreps_in)
        if not (self.w_names or self.b_names):
            return f.new_zeros(*f.shape[:-1], self.irreps_out.dim)
        W, bias = self._dense()
        out = f @ W
        return out + bias if self.b_names else out


@functools.lru_cache(maxsize=None)
def _ln_matrices(irreps: Irreps):
    """M (dim, G) averages scalar-entry components; S (dim, G) averages
    squared components per entry; E (G, dim) entry membership."""
    dim, G = irreps.dim, len(irreps)
    M = np.zeros((dim, G))
    S = np.zeros((dim, G))
    E = np.zeros((G, dim))
    inst_of_comp = np.zeros(dim, dtype=np.int64)
    scalar_comp = np.zeros(dim)
    scalar_inst_of_comp = np.zeros(dim, dtype=np.int64)
    i = iw = ib = 0
    for g, (mul, ir) in enumerate(irreps):
        d = ir.dim
        n = mul * d
        S[i : i + n, g] = 1.0 / n
        E[g, i : i + n] = 1.0
        for u in range(mul):
            inst_of_comp[i + u * d : i + (u + 1) * d] = iw + u
        if ir == _SCALAR:
            M[i : i + n, g] = 1.0 / mul
            scalar_comp[i : i + n] = 1.0
            scalar_inst_of_comp[i : i + n] = np.arange(ib, ib + mul)
            ib += mul
        iw += mul
        i += n
    return M, S, E, inst_of_comp, scalar_comp, scalar_inst_of_comp


class EquivariantLayerNorm(nn.Module):
    """RMS-style norm per irrep entry; scalars are mean-centered; affine
    weight per irrep instance, bias on even scalars."""

    def __init__(self, irreps, eps: float = 1e-5, affine: bool = True):
        super().__init__()
        self.irreps, self.eps, self.affine = Irreps(irreps), eps, affine
        self.num_scalar = sum(mul for mul, ir in self.irreps if ir == _SCALAR)
        if affine:
            self.weight = nn.Parameter(torch.empty(self.irreps.num_irreps))
            self.bias = nn.Parameter(torch.empty(max(self.num_scalar, 1)))

    def forward(self, f: torch.Tensor) -> torch.Tensor:
        irreps = self.irreps
        mats = _ln_matrices(irreps)
        M = constant(("ln_M", irreps), lambda: mats[0], f)
        S = constant(("ln_S", irreps), lambda: mats[1], f)
        E = constant(("ln_E", irreps), lambda: mats[2], f)
        scomp = constant(("ln_sc", irreps), lambda: mats[4], f)
        means = f @ M
        f = f - (means @ E) * scomp
        norm2 = torch.square(f) @ S
        scale = torch.rsqrt(norm2 + self.eps) @ E
        if not self.affine:
            return f * scale
        inst = constant(("ln_inst", irreps), lambda: mats[3], f, dtype=torch.long)
        out = f * (scale * self.weight[inst])
        if self.num_scalar:
            sinst = constant(("ln_sinst", irreps), lambda: mats[5], f, dtype=torch.long)
            out = out + self.bias[sinst] * scomp
        return out


def irreps2gate(irreps) -> Tuple[Irreps, Irreps, Irreps]:
    """Split into (scalars, gates, gated)."""
    irreps = Irreps(irreps)
    scalars = [(mul, ir) for mul, ir in irreps if ir == _SCALAR]
    gated = [(mul, ir) for mul, ir in irreps if ir != _SCALAR]
    scalars_i = Irreps(scalars).simplify()
    gated_i = Irreps(gated).simplify()
    gates_i = Irreps([(mul, _SCALAR) for mul, _ in gated_i]).simplify()
    return scalars_i, gates_i, gated_i


@functools.lru_cache(maxsize=None)
def _gate_expander(gates: Irreps, gated: Irreps, component_major: bool) -> np.ndarray:
    """0/1 ``(num gates, gated dim)`` matrix spreading each gate over the
    components of its gated irrep instance (i-major lanes when
    ``component_major``)."""
    R = np.zeros((gates.num_irreps, gated.dim))
    gi = ci = 0
    for mul, ir in gated:
        if component_major:
            for u in range(mul):
                R[gi + u, ci + u : ci + mul * ir.dim : mul] = 1.0
            gi += mul
        else:
            for u in range(mul):
                R[gi, ci + u * ir.dim : ci + (u + 1) * ir.dim] = 1.0
                gi += 1
        ci += mul * ir.dim
    return R


class GateFromIrreps(nn.Module):
    """Gated nonlinearity for target ``irreps_out``: input layout
    ``scalars + gates + gated``; SiLU on scalars, sigmoid(gates) multiplying
    each gated irrep instance; output ``scalars + gated``.  With
    ``component_major`` the gated lanes are i-major and stay so."""

    def __init__(self, irreps_out, component_major: bool = False):
        super().__init__()
        self.s, self.g, self.t = irreps2gate(Irreps(irreps_out))
        self.component_major = component_major

    def forward(self, f: torch.Tensor) -> torch.Tensor:
        sd, gd, td = self.s.dim, self.g.dim, self.t.dim
        assert f.shape[-1] == sd + gd + td
        scalars = scalar_silu(f[..., :sd])
        if gd == 0:
            return scalars
        gates = norm_sigmoid(f[..., sd : sd + gd])
        key = (self.g, self.t, self.component_major)
        R = constant(("gate_R",) + key, lambda: _gate_expander(*key), f)
        return torch.cat([scalars, f[..., sd + gd :] * (gates @ R)], dim=-1)
