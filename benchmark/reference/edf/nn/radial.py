"""Radial bases, soft cutoffs, positional encoders and the radial weight MLP
(counterpart of the JAX package's ``nn/radial.py``)."""
from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple

import torch
from torch import nn

__all__ = [
    "BesselBasis",
    "Dense",
    "LayerNorm",
    "soft_step",
    "soft_square_cutoff",
    "soft_square_cutoff_2",
    "RadialProfile",
    "GaussianRadialBasis",
    "GaussianRadialBasisFiniteCutoff",
    "SinusoidalPositionEmbeddings",
]

CutoffRanges = Tuple[Optional[float], Optional[float], Optional[float], Optional[float]]


class Dense(nn.Module):
    """flax ``nn.Dense``: ``kernel`` is (in, out)."""

    def __init__(self, features_in: int, features: int, use_bias: bool = True):
        super().__init__()
        self.kernel = nn.Parameter(torch.empty(features_in, features))
        self.bias = nn.Parameter(torch.empty(features)) if use_bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = x @ self.kernel
        return y + self.bias if self.bias is not None else y


class LayerNorm(nn.Module):
    """flax ``nn.LayerNorm`` (``scale``/``bias``) with flax's fast variance
    ``mean(x^2) - mean(x)^2``; ``torch.nn.LayerNorm`` uses the two-pass form."""

    def __init__(self, features: int, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.empty(features))
        self.bias = nn.Parameter(torch.empty(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        mu = x.mean(dim=-1, keepdim=True)
        var = (x * x).mean(dim=-1, keepdim=True) - mu * mu
        return (x - mu) * torch.rsqrt(var + self.eps) * self.scale + self.bias


def soft_step(x: torch.Tensor, n: int = 3) -> torch.Tensor:
    xc = torch.clamp(x, 0.0, 1.0)
    core = (n + 1) * xc**n - n * xc ** (n + 1)
    one = torch.ones_like(x)
    return torch.where(x > 0, torch.where(x < 1, core, one), torch.zeros_like(x))


def soft_cutoff(x: torch.Tensor, thr: float = 0.8, n: int = 3) -> torch.Tensor:
    return 1.0 - soft_step((x - thr) / (1.0 - thr), n=n)


def soft_square_cutoff(x: torch.Tensor, thr: float = 0.8, n: int = 3, infinite: bool = False) -> torch.Tensor:
    if infinite:
        return soft_cutoff(x, thr=thr, n=n) * (x > 0.5) + soft_cutoff(1 - x, thr=thr, n=n) * (x <= 0.5)
    return (x > 0.5).to(x.dtype) + soft_cutoff(1 - x, thr=thr, n=n) * (x <= 0.5)


def soft_square_cutoff_2(x: torch.Tensor, ranges: Optional[CutoffRanges], n: int = 3) -> torch.Tensor:
    """Two-sided soft window over ``(left_end, left_begin, right_begin, right_end)``."""
    if ranges is None:
        return x
    left_end, left_begin, right_begin, right_end = ranges
    div_l = (left_begin - left_end) if (left_end is not None and left_begin is not None) else 1.0
    div_r = (right_end - right_begin) if (right_end is not None and right_begin is not None) else 1.0
    if right_begin is not None and left_end is None:
        return 1.0 - soft_step((x - right_begin) / div_r, n=n)
    if left_end is not None and right_begin is None:
        return soft_step((x - left_end) / div_l, n=n)
    if right_begin is not None and left_end is not None:
        mid = 0.5 * (left_begin + right_begin)
        return (1.0 - soft_step((x - right_begin) / div_r, n=n)) * (x > mid) + soft_step(
            (x - left_end) / div_l, n=n
        ) * (x <= mid)
    return torch.ones_like(x)


class RadialProfile(nn.Module):
    """Linear -> [LayerNorm -> SiLU] ... -> Linear(+offset) weight MLP.
    The LayerNorms use eps 1e-5 and flax's fast variance."""

    def __init__(self, ch_list: Sequence[int], use_layer_norm: bool = True, use_offset: bool = True):
        super().__init__()
        self.ch_list = tuple(ch_list)
        self.use_layer_norm = use_layer_norm
        self.use_offset = use_offset
        chs = self.ch_list
        for i in range(1, len(chs)):
            last = i == len(chs) - 1
            self.add_module(f"dense{i}", Dense(chs[i - 1], chs[i], use_bias=not (last and use_offset)))
            if not last and use_layer_norm:
                self.add_module(f"ln{i}", LayerNorm(chs[i], eps=1e-5))
        self.offset = nn.Parameter(torch.empty(chs[-1])) if use_offset else None

    def _offset_row(self) -> torch.Tensor:
        if not self.use_offset:
            return self.dense1.kernel.new_zeros(1, self.ch_list[-1])
        fan_in = self.ch_list[-2]
        bound = 1.0 / math.sqrt(fan_in) if fan_in > 0 else 0.0
        return (self.offset - bound)[None, :]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = x
        n = len(self.ch_list)
        for i in range(1, n):
            h = getattr(self, f"dense{i}")(h)
            if i < n - 1:
                if self.use_layer_norm:
                    h = getattr(self, f"ln{i}")(h)
                h = torch.nn.functional.silu(h)
        return h + self._offset_row()

    def materialize(self):
        """Per-layer ``(W (in, out), b (1, out) | None, ln scale (1, n) | None,
        ln bias | None)`` plus the final ``(1, out)`` offset row — the
        parameters the edge kernel runs the MLP from."""
        layers: List[tuple] = []
        n = len(self.ch_list)
        for i in range(1, n):
            dense = getattr(self, f"dense{i}")
            ln = getattr(self, f"ln{i}", None) if i < n - 1 else None
            layers.append((
                dense.kernel,
                None if dense.bias is None else dense.bias[None, :],
                None if ln is None else ln.scale[None, :],
                None if ln is None else ln.bias[None, :],
            ))
        return layers, self._offset_row()


class GaussianRadialBasis(nn.Module):
    """Learnable Gaussian RBF over [0, max_val]."""

    def __init__(self, dim: int, max_val: float, min_val: float = 0.0, max_weight: float = 4.0):
        super().__init__()
        self.dim, self.max_val, self.min_val, self.max_weight = dim, max_val, min_val, max_weight
        self.mean = nn.Parameter(torch.empty(dim))
        self.std_logit = nn.Parameter(torch.empty(dim))
        self.weight_logit = nn.Parameter(torch.empty(dim))

    def forward(self, dist: torch.Tensor) -> torch.Tensor:
        d = (dist[..., None] - self.min_val) / (self.max_val - self.min_val)
        std = torch.nn.functional.softplus(self.std_logit) + 1e-5
        weight = torch.sigmoid(self.weight_logit) * self.max_weight * math.sqrt(self.dim)
        g = torch.exp(-0.5 * torch.square((d - self.mean) / std))
        return g * weight


class GaussianRadialBasisFiniteCutoff(nn.Module):
    """Gaussian RBF with a soft cutoff near the radius and a small-distance offset."""

    def __init__(self, num_basis: int, cutoff: float, offset: Optional[float] = None,
                 soft_cutoff: bool = True, cutoff_thr_ratio: float = 0.8,
                 infinite: bool = False, max_weight: float = 4.0):
        super().__init__()
        self.num_basis, self.cutoff = num_basis, cutoff
        self.offset_val = 0.01 * cutoff if offset is None else offset
        self.soft_cutoff, self.cutoff_thr_ratio = soft_cutoff, cutoff_thr_ratio
        self.infinite, self.max_weight = infinite, max_weight
        self.mean = nn.Parameter(torch.empty(num_basis))
        self.std_logit = nn.Parameter(torch.empty(num_basis))
        self.weight_logit = nn.Parameter(torch.empty(num_basis))

    def forward(self, dist: torch.Tensor) -> torch.Tensor:
        d = ((dist - self.offset_val) / (self.cutoff - self.offset_val))[..., None]
        std = torch.nn.functional.softplus(self.std_logit) + 1e-5
        weight = torch.sigmoid(self.weight_logit) * self.max_weight
        x = torch.exp(-0.5 * torch.square((d - self.mean) / std)) * weight
        if self.soft_cutoff:
            x = x * soft_square_cutoff(d, thr=self.cutoff_thr_ratio, infinite=self.infinite)
        return x * math.sqrt(self.num_basis)


class BesselBasis(nn.Module):
    """Spherical Bessel basis ``sin(n pi x / c) / (x / c)``, n = 1..dim
    (``BesselBasisEncoder``, ``radial_func.py:72-126``; no shipped config
    uses it)."""

    def __init__(self, dim: int, max_val: float, min_val: float = 0.0, max_cutoff: bool = False, eps: float = 1e-3):
        super().__init__()
        assert min_val == 0.0
        self.dim, self.max_val, self.min_val, self.max_cutoff, self.eps = dim, max_val, min_val, max_cutoff, eps

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        c = self.max_val - self.min_val
        roots = torch.arange(1, self.dim + 1, dtype=x.dtype, device=x.device) * math.pi
        xd = torch.clamp((x[..., None] - self.min_val) / c, min=self.eps)
        out = torch.sin(roots * xd) / xd
        return out * (xd < 1.0) if self.max_cutoff else out


class SinusoidalPositionEmbeddings(nn.Module):
    def __init__(self, dim: int, max_val: float, n: float = 10000.0):
        super().__init__()
        assert dim % 2 == 0
        self.dim, self.max_val, self.n = dim, max_val, n

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        half = self.dim // 2
        xs = x / self.max_val * self.n
        freqs = torch.exp(
            torch.arange(half, dtype=x.dtype, device=x.device) * (-math.log(self.n) / (half - 1))
        )
        emb = xs[..., None] * freqs
        return torch.cat([torch.sin(emb), torch.cos(emb)], dim=-1)
