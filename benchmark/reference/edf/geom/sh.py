"""Real spherical harmonics, component-normalized, by the CG recursion

    Y_0 = 1,  Y_1(u) = sqrt(3) u,
    Y_l(u) = c_l * einsum('a,b,abm->m', Y_1, Y_{l-1}, w3j(1, l-1, l))

with ``c_l`` fixed so ``|Y_l(u)| = sqrt(2l+1)`` on the unit sphere — the same
construction as the JAX package's ``geom/sh.py``, so SH, Wigner-D and tensor
products stay mutually equivariant.
"""
from __future__ import annotations

from typing import List, Union

import numpy as np
import torch

from ..nn.util import constant
from .cg import sh_recursion_norm, w3j
from .irreps import Irreps

__all__ = ["spherical_harmonics"]


def spherical_harmonics(
    irreps: Union[str, Irreps, int],
    vec: torch.Tensor,
    normalize: bool = True,
    eps: float = 1e-12,
) -> torch.Tensor:
    """Component-normalized real SH of ``vec`` (..., 3); ``irreps`` is an int
    ``lmax`` or multiplicity-1 irreps like ``"1x0e+1x1e+1x2e"``."""
    if isinstance(irreps, int):
        ls = list(range(irreps + 1))
    else:
        ls = []
        for mul, ir in Irreps(irreps):
            assert mul == 1, f"SH irreps must have multiplicity 1, got {irreps}"
            ls.append(ir.l)
    lmax = max(ls)

    if normalize:
        # max() instead of +eps: the floor cuts the derivative path at 0
        norm = torch.sqrt(torch.clamp(torch.sum(vec * vec, dim=-1, keepdim=True), min=eps))
        u = vec / norm
    else:
        u = vec

    ys: List[torch.Tensor] = [torch.ones(u.shape[:-1] + (1,), dtype=u.dtype, device=u.device)]
    if lmax >= 1:
        ys.append(float(np.sqrt(3.0)) * u)  # cartesian l=1 basis
    for l in range(2, lmax + 1):
        C = constant(("sh_rec", l), lambda l=l: np.asarray(w3j(1, l - 1, l)) * sh_recursion_norm(l), u)
        ys.append(torch.einsum("...a,...b,abm->...m", ys[1], ys[l - 1], C))
    return torch.cat([ys[l] for l in ls], dim=-1)
