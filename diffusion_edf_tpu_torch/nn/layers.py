"""Core equivariant layers: irreps linear, layer norm, gate and dropout
(counterpart of the JAX package's ``nn/layers.py``)."""
from __future__ import annotations

import functools
from typing import Optional, Tuple

import numpy as np
import torch
from torch import nn

from ..geom.irreps import Irrep, Irreps
from ..parallel.mesh import current_pose_block
from .util import cached, constant, sigmoid_norm, silu_norm

__all__ = [
    "IrrepsLinear",
    "EquivariantLayerNorm",
    "GateFromIrreps",
    "irreps2gate",
    "scalar_silu",
    "norm_sigmoid",
    "EquivariantDropout",
    "keep_mask",
    "drop_irreps",
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

    @functools.cached_property
    def _tables(self) -> Tuple[np.ndarray, np.ndarray]:
        """Where each entry of the dense canonical ``W (dim_in, dim_out)`` and
        ``bias (dim_out,)`` comes from: an index into the concatenated
        flattened weights (biases), or one past the end, which reads 0."""
        irreps_in, irreps_out = self.irreps_in, self.irreps_out
        n_w = sum(mul_in * irreps_out[oi][0] for oi, (_, mul_in) in self.w_names.items())
        n_b = sum(irreps_out[oi][0] for oi in self.b_names)
        W = np.full((irreps_in.dim, irreps_out.dim), n_w, dtype=np.int64)
        B = np.full((irreps_out.dim,), n_b, dtype=np.int64)
        in_slices, out_slices = irreps_in.slices(), irreps_out.slices()
        w_off = b_off = 0
        for oi, (mul_out, ir) in enumerate(irreps_out):
            d, o0 = ir.dim, out_slices[oi].start
            if oi in self.w_names:
                u0 = 0
                for ii in self.in_by_ir[ir]:
                    i0 = in_slices[ii].start
                    for u in range(irreps_in[ii][0]):
                        for w in range(mul_out):
                            for e in range(d):
                                W[i0 + u * d + e, o0 + w * d + e] = w_off + (u0 + u) * mul_out + w
                    u0 += irreps_in[ii][0]
                w_off += self.w_names[oi][1] * mul_out
            if oi in self.b_names:
                B[o0 : o0 + mul_out] = np.arange(b_off, b_off + mul_out)
                b_off += mul_out
        return W, B

    def _gather(self, permuted: bool) -> Tuple[torch.Tensor, torch.Tensor]:
        """``(W, bias)`` gathered from the params by :attr:`_tables`, in the
        permuted layouts of ``input_perm`` / ``output_perm`` or canonical."""
        def tables():
            W_idx, B_idx = self._tables
            if permuted and self.input_perm is not None:
                W_idx = W_idx[list(self.input_perm), :]
            if permuted and self.output_perm is not None:
                op = list(self.output_perm)
                W_idx, B_idx = W_idx[:, op], B_idx[op]
            return W_idx, B_idx

        ref = next(iter(self.parameters()))
        key = ("linear", self.irreps_in, self.irreps_out, bool(self.b_names)) + (
            (self.input_perm, self.output_perm) if permuted else (None, None))
        W_i = constant(key + ("W",), lambda: tables()[0].reshape(-1), ref, dtype=torch.long)
        B_i = constant(key + ("B",), lambda: tables()[1], ref, dtype=torch.long)
        ws = [((getattr(self, name) - 1.0) / float(np.sqrt(mul_in))).reshape(-1) for name, mul_in in self.w_names.values()]
        bs = [getattr(self, name) for name in self.b_names.values()]
        zero = ref.new_zeros(1)
        # index_select, whose backward is an index_add (advanced indexing's sorts its indices on CUDA)
        W = torch.index_select(torch.cat(ws + [zero]), 0, W_i).reshape(self.irreps_in.dim, self.irreps_out.dim)
        return W, torch.index_select(torch.cat(bs + [zero]), 0, B_i)

    def materialize(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """The effective dense ``(W (dim_in, dim_out), bias (dim_out,))`` in
        canonical layouts, built from the same params: ``(w - 1) /
        sqrt(mul_in)`` blocks times the identity of each irrep, and the
        biases of the even scalars (one gather each)."""
        return self._gather(permuted=False)

    def _dense(self) -> Tuple[torch.Tensor, torch.Tensor]:
        return cached(self, "dense", list(self.parameters()), lambda: self._gather(permuted=True))

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


def keep_mask(shape, rate: float, generator: Optional[torch.Generator], device) -> torch.Tensor:
    """The draw of a dropout: a bool mask, True with probability ``1 - rate``
    (``uniform < 1 - rate``, as ``jax.random.bernoulli`` draws it).

    Inside ``parallel/mesh.py::pose_block(R, n, start, size)`` the rows
    (axis 0 of ``shape``) are R requests' ``size`` poses' rows, pose-major:
    the mask is drawn for all ``n`` poses and the block's rows kept, so the
    block is dropped as it is in one call on the whole batch."""
    block = current_pose_block()
    if block is None:
        return torch.rand(shape, generator=generator, device=device) < (1.0 - rate)
    r, n, start, size = block
    rows, rest = shape[0], tuple(shape[1:])
    assert rows % (r * size) == 0, (shape, block)
    full = torch.rand((r, n, rows // (r * size)) + rest, generator=generator, device=device)
    return full.narrow(1, start, size).reshape(shape) < (1.0 - rate)


def drop_irreps(f: torch.Tensor, keep: torch.Tensor, irreps: Irreps, rate: float) -> torch.Tensor:
    """``f`` (..., irreps.dim) with every irrep instance that ``keep`` (...,
    num_irreps) drops zeroed and the rest scaled by ``1 / (1 - rate)``."""
    reps = constant(("irrep_dims", irreps), lambda: [ir.dim for mul, ir in irreps for _ in range(mul)], f,
                    dtype=torch.long)
    # output_size: the sum of reps, known here, so that the op reads nothing back from the device
    return f * torch.repeat_interleave(keep.to(f.dtype), reps, dim=-1, output_size=irreps.dim) / (1.0 - rate)


class EquivariantDropout(nn.Module):
    """Drops whole irrep instances with probability ``rate`` in ``train()``
    mode, the identity in ``eval()`` mode.  The keep mask is drawn from
    ``dropout_generator`` (None: torch's default generator of the device)."""

    def __init__(self, irreps, rate: float):
        super().__init__()
        self.irreps, self.rate = Irreps(irreps), float(rate)
        self.dropout_generator: Optional[torch.Generator] = None
        self.eval()  # deterministic until train()

    def forward(self, f: torch.Tensor) -> torch.Tensor:
        if not self.training or self.rate == 0.0:
            return f
        keep = keep_mask(f.shape[:-1] + (self.irreps.num_irreps,), self.rate, self.dropout_generator, f.device)
        return drop_irreps(f, keep, self.irreps, self.rate)
