"""Parity utilities (reference ``utils.py:26-47`` ``ParityInversionSh``;
counterpart of the JAX package's ``geom/parity.py``).

The UNet's up path recomputes the SH of the negated edge vector rather than
flipping the odd degrees of the down edges' SH (the same numbers); the flip
is kept for API parity and outside use.
"""
from __future__ import annotations

import numpy as np
import torch

from .irreps import Irreps

__all__ = ["parity_inversion_sh", "parity_sign_vector"]


def parity_sign_vector(irreps) -> np.ndarray:
    """+1 on the components of even-l blocks, -1 on those of odd-l blocks."""
    irreps = Irreps(irreps)
    sign = np.ones(irreps.dim)
    i = 0
    for mul, ir in irreps:
        n = mul * ir.dim
        if ir.l % 2 == 1:
            sign[i : i + n] = -1.0
        i += n
    return sign


def parity_inversion_sh(irreps, f: torch.Tensor) -> torch.Tensor:
    """The spatial-inversion sign flip ``Y_l(-r) = (-1)^l Y_l(r)`` of SH
    features ``f`` (..., dim)."""
    return f * torch.as_tensor(parity_sign_vector(irreps), dtype=f.dtype, device=f.device)
