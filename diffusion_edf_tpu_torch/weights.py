"""Weights in the JAX package's flat ``.npz`` layout.

A checkpoint maps flat flax keys (``params/a/b/c``) to arrays; the port's
modules keep the flax names, so the parameter ``a.b.c`` is the key
``params/a/b/c`` with the flax layouts (a Dense ``kernel`` is (in, out)).
A numeric path component is an index into a param group that flax stacked
with ``nn.vmap`` (the score head's ``time_mlps`` and ``vel_tps``): the
parameter ``a.3.b`` is row 3 of the key ``params/a/b``.
"""
from __future__ import annotations

import math
from collections import defaultdict
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
from torch import nn

__all__ = ["flax_key", "load_flat_params", "load_params_npz", "flat_arrays", "unflatten_arrays", "init_params"]


def flax_key(name: str):
    """``(flax key, stack indices)`` of a torch parameter name."""
    parts = name.split(".")
    key = "params/" + "/".join(p for p in parts if not p.isdigit())
    return key, tuple(int(p) for p in parts if p.isdigit())


def _groups(model: nn.Module, tensors: Optional[Sequence[torch.Tensor]] = None):
    """Flax key -> ``[(stack indices, tensor)]`` over the model's parameters
    (or over ``tensors``, one for each parameter in its order)."""
    named = list(model.named_parameters())
    tensors = [p for _, p in named] if tensors is None else list(tensors)
    assert len(tensors) == len(named)
    groups = defaultdict(list)
    for (name, _), t in zip(named, tensors):
        key, idx = flax_key(name)
        groups[key].append((idx, t))
    return groups


def unflatten_arrays(model: nn.Module, flat: Dict[str, np.ndarray]) -> List[np.ndarray]:
    """The arrays of a flat flax-keyed dict, one for each parameter of
    ``model`` in its order.  Keys and shapes must match exactly both ways;
    ``__``-prefixed keys (``__meta__``) are skipped."""
    flat = {k: v for k, v in flat.items() if not k.startswith("__")}
    groups = _groups(model)
    missing = sorted(set(groups) - set(flat))
    extra = sorted(set(flat) - set(groups))
    if missing or extra:
        raise KeyError(f"checkpoint keys differ: {len(missing)} missing (e.g. {missing[:3]}), "
                       f"{len(extra)} unknown (e.g. {extra[:3]})")
    out = {}
    for key, items in groups.items():
        arr = np.asarray(flat[key])
        if items[0][0]:
            if arr.shape[0] != len(items):
                raise ValueError(f"{key!r}: stacked axis {arr.shape[0]} vs {len(items)} modules")
        for idx, p in items:
            sub = arr[idx] if idx else arr
            if tuple(sub.shape) != tuple(p.shape):
                raise ValueError(f"shape mismatch for {key!r}{list(idx)}: ckpt {sub.shape} vs model {tuple(p.shape)}")
            out[id(p)] = sub
    return [out[id(p)] for p in model.parameters()]


def flat_arrays(model: nn.Module, tensors: Optional[Sequence[torch.Tensor]] = None) -> Dict[str, np.ndarray]:
    """The inverse of :func:`unflatten_arrays`: the model's parameters (or
    ``tensors``, one for each parameter) as a flat flax-keyed dict, stacked
    groups stacked again along their first axis; copies, never views of the
    tensors."""
    out = {}
    for key, items in _groups(model, tensors).items():
        arrs = [t.detach().cpu().numpy() for _, t in sorted(items, key=lambda it: it[0])]
        out[key] = np.stack(arrs) if items[0][0] else arrs[0].copy()
    return out


def load_flat_params(model: nn.Module, flat: Dict[str, np.ndarray]) -> nn.Module:
    """Copy a flat flax-keyed dict into ``model`` (see
    :func:`unflatten_arrays`); every array is cast to the parameter's dtype
    (f16 -> f32)."""
    arrays = unflatten_arrays(model, flat)
    with torch.no_grad():
        for p, a in zip(model.parameters(), arrays):
            p.copy_(torch.as_tensor(np.asarray(a, dtype=np.float32)).to(p.dtype))
    return model


def load_params_npz(model: nn.Module, path: str) -> nn.Module:
    with np.load(path) as z:
        flat = {k: z[k] for k in z.files}
    return load_flat_params(model, flat)


def init_params(model: nn.Module, generator: Optional[torch.Generator] = None) -> nn.Module:
    """Seeded random parameters of the flax initializers' families, for a
    model that runs without a checkpoint."""
    from .models.keypoint import StaticKeypointModel
    from .nn.attention import GraphAttention
    from .nn.layers import EquivariantLayerNorm, IrrepsLinear
    from .nn.radial import Dense, GaussianRadialBasis, GaussianRadialBasisFiniteCutoff, LayerNorm, RadialProfile
    from .nn.tp_modules import DepthwiseTP, FullyConnectedTP

    g = generator

    def uni(p, lo, hi):
        p.copy_(torch.rand(p.shape, generator=g) * (hi - lo) + lo)

    with torch.no_grad():
        for m in model.modules():
            own = dict(m.named_parameters(recurse=False))
            if isinstance(m, IrrepsLinear):
                for n, p in own.items():
                    uni(p, 0.0, 2.0) if n.startswith("w") else p.zero_()
            elif isinstance(m, Dense):
                m.kernel.copy_(torch.randn(m.kernel.shape, generator=g) / math.sqrt(m.kernel.shape[0]))
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, (LayerNorm, EquivariantLayerNorm)):
                for n, p in own.items():
                    p.fill_(1.0) if n in ("scale", "weight") else p.zero_()
            elif isinstance(m, DepthwiseTP) and m.internal_weights:
                uni(m.tp_weight, -1.0, 1.0)
            elif isinstance(m, FullyConnectedTP):
                uni(m.tp_weight, -1.0, 1.0)
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, RadialProfile) and m.offset is not None:
                uni(m.offset, 0.0, 2.0 / math.sqrt(m.ch_list[-2]))
            elif isinstance(m, GraphAttention):
                bound = math.sqrt(6.0 / sum(m.alpha_dot.shape))
                uni(m.alpha_dot, -bound, bound)
            elif isinstance(m, (GaussianRadialBasis, GaussianRadialBasisFiniteCutoff)):
                dim = m.mean.shape[0]
                m.mean.copy_(torch.linspace(0.0, 1.0, dim + 2)[1:-1])
                m.std_logit.fill_(math.log(math.exp(2.0 / dim) - 1.0))
                m.weight_logit.fill_(-math.log(m.max_weight - 1.0))
            elif isinstance(m, StaticKeypointModel):
                for p in own.values():
                    p.copy_(torch.randn(p.shape, generator=g))
    return model
