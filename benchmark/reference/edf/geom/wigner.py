"""Wigner-D matrices from quaternions and irreps feature rotation.

``D^l`` is built as polynomials in the rotation matrix by the CG recursion
``D^l = (2l+1) M^T (D^1 ⊗ D^{l-1}) M`` with ``M = w3j(1, l-1, l)`` — exact
and branch-free, as in the JAX package's ``geom/wigner.py``.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ..nn.util import constant
from .cg import w3j_matrix
from .irreps import Irreps
from .so3 import quaternion_to_matrix

__all__ = ["wigner_D_blocks", "wigner_D_from_quaternion", "rotate_irreps"]


def wigner_D_blocks(q: torch.Tensor, lmax: int) -> Dict[int, torch.Tensor]:
    """``{l: D^l(q)}`` for ``l = 0..lmax``; ``q`` is (..., 4) unit; each
    matrix is (..., 2l+1, 2l+1)."""
    batch = q.shape[:-1]
    out: Dict[int, torch.Tensor] = {0: torch.ones(batch + (1, 1), dtype=q.dtype, device=q.device)}
    if lmax == 0:
        return out
    D1 = quaternion_to_matrix(q)  # cartesian l=1 basis: D^1 == R
    out[1] = D1
    for l in range(2, lmax + 1):
        d_prev = 2 * l - 1
        M = constant(("wigner_rec", l), lambda l=l: np.asarray(w3j_matrix(1, l - 1, l)), q)
        Mr = M.reshape(3, d_prev, 2 * l + 1)
        K = torch.einsum("...ij,bjn->...ibn", out[l - 1], Mr)
        L = torch.einsum("...ab,...ibn->...ain", D1, K)
        out[l] = torch.einsum("aim,...ain->...mn", Mr, L) * (2 * l + 1)
    return out


def wigner_D_from_quaternion(l: int, q: torch.Tensor) -> torch.Tensor:
    """``D^l(q)`` alone, (..., 2l+1, 2l+1)."""
    return wigner_D_blocks(q, l)[l]


def rotate_irreps(irreps: Irreps, f: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """Per request: features ``f`` (R, nQ, dim) rotated by that request's
    quaternions ``q`` (R, nT, 4) -> (R, nT, nQ, dim)."""
    irreps = Irreps(irreps)
    D = wigner_D_blocks(q, irreps.lmax)
    r, nq = f.shape[:2]
    nt = q.shape[1]
    outs = []
    i = 0
    for mul, ir in irreps:
        d = ir.dim
        blk = f[..., i : i + mul * d].reshape(r, nq, mul, d)
        i += mul * d
        if ir.l == 0:
            rot = blk[:, None].expand(r, nt, nq, mul, d)
        else:
            rot = torch.einsum("rtij,rquj->rtqui", D[ir.l], blk)
        outs.append(rot.reshape(r, nt, nq, mul * d))
    return torch.cat(outs, dim=-1)
