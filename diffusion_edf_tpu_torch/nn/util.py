"""Small numeric utilities: activation normalization constants, the
smooth leaky ReLU, a cache of constant tables per device, a cache of
tensors derived from parameters, and the test of whether autograd records."""
from __future__ import annotations

import functools
from typing import Callable, Dict, Hashable, Sequence, Tuple

import numpy as np
import torch

__all__ = [
    "normalize2mom_const",
    "silu_norm",
    "sigmoid_norm",
    "smooth_leaky_relu",
    "smooth_leaky_relu_norm",
    "constant",
    "cached",
    "records_grad",
]


@functools.lru_cache(maxsize=None)
def _gauss_hermite(n: int = 201):
    # nodes/weights for E_{x~N(0,1)}[f(x)] = sum w_i f(sqrt(2) x_i) / sqrt(pi)
    x, w = np.polynomial.hermite.hermgauss(n)
    return x * np.sqrt(2.0), w / np.sqrt(np.pi)


def normalize2mom_const(fn: Callable[[np.ndarray], np.ndarray]) -> float:
    """Constant ``c`` with ``E[(c*fn(x))^2] = 1`` for ``x ~ N(0,1)`` (e3nn's
    ``normalize2mom``, by Gauss-Hermite quadrature)."""
    x, w = _gauss_hermite()
    return float(1.0 / np.sqrt(float(np.sum(w * fn(x) ** 2))))


@functools.lru_cache(maxsize=None)
def silu_norm() -> float:
    return normalize2mom_const(lambda x: x / (1.0 + np.exp(-x)))


@functools.lru_cache(maxsize=None)
def sigmoid_norm() -> float:
    return normalize2mom_const(lambda x: 1.0 / (1.0 + np.exp(-x)))


def smooth_leaky_relu(x: torch.Tensor, negative_slope: float = 0.2) -> torch.Tensor:
    """``SmoothLeakyReLU``; ``2*sigmoid(x) - 1 == tanh(x/2)``."""
    a = negative_slope
    return ((1 + a) / 2) * x + ((1 - a) / 2) * x * torch.tanh(x / 2.0)


@functools.lru_cache(maxsize=None)
def smooth_leaky_relu_norm(negative_slope: float = 0.2) -> float:
    a = negative_slope
    return normalize2mom_const(lambda x: ((1 + a) / 2) * x + ((1 - a) / 2) * x * np.tanh(x / 2.0))


_CONSTANTS: Dict[Tuple, torch.Tensor] = {}


def constant(key: Hashable, make: Callable[[], np.ndarray], like: torch.Tensor, dtype=None) -> torch.Tensor:
    """A constant table (built once from numpy by ``make``) on ``like``'s
    device, in ``dtype`` (default ``like.dtype``), cached per key."""
    dtype = like.dtype if dtype is None else dtype
    k = (key, like.device, dtype)
    t = _CONSTANTS.get(k)
    if t is None:
        t = torch.as_tensor(np.asarray(make()), dtype=dtype, device=like.device)
        _CONSTANTS[k] = t
    return t


def cached(module: torch.nn.Module, key: Hashable, deps: Sequence[torch.Tensor], fn: Callable):
    """``fn()`` memoised on ``module`` while none of ``deps`` has been written
    or moved since (tensor version counters and storage pointers).  Derived
    weights (dense irreps-linear matrices, the edge kernel's folded weights)
    are rebuilt only after a checkpoint load.  Bypassed while autograd is on,
    so a cached value never carries a stale graph."""
    if torch.is_grad_enabled():
        return fn()
    stamp = tuple((t.data_ptr(), t._version) for t in deps)
    store = module.__dict__.setdefault("_derived_cache", {})
    hit = store.get(key)
    if hit is not None and hit[0] == stamp:
        return hit[1]
    val = fn()
    store[key] = (stamp, val)
    return val


def records_grad(*tensors) -> bool:
    """Whether autograd would record an op on any of ``tensors`` (tensors,
    None, or tuples and lists of them, nested): grad mode is on and one of
    them requires grad.  The hand-written kernels have no backward."""
    if not torch.is_grad_enabled():
        return False
    stack = list(tensors)
    while stack:
        t = stack.pop()
        if isinstance(t, torch.Tensor):
            if t.requires_grad:
                return True
        elif isinstance(t, (tuple, list)):
            stack.extend(t)
    return False
