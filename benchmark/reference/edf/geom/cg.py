"""Trace-time group-theory constants: real Wigner-D matrices and real
Clebsch-Gordan (Wigner 3j) coupling tensors.

The reference obtains these from e3nn (cached ``_Jd`` matrices,
``diffusion_edf/w3j.py:6-11``; ``o3.TensorProduct`` codegen,
``equiformer/tensor_product_rescale.py:38-42``).  Here we derive everything
from first principles in float64 numpy **once at import/trace time** and bake
the results into the network as constant tensors — there is no runtime group
theory on the device.  (A copy of the JAX package's ``geom/cg.py``; the port
keeps its own so that it never imports the JAX package.)

Conventions (self-consistent; anchored to make l=1 match e3nn's (y,z,x)
component ordering so a future torch-checkpoint importer stays a reshape):

* The real l=1 irrep basis is ``(y, z, x)``:  ``D1(R)[i,j] = R[axis_i,axis_j]``
  with ``axis = (1, 2, 0)``.
* Higher-l representation matrices are built recursively:
  ``D^l = (2l+1) * M^T (D^1 ⊗ D^{l-1}) M`` with ``M = w3j(1, l-1, l)``
  reshaped to ``(3*(2l-1), 2l+1)`` (an isometry up to the factor ``1/(2l+1)``).
* ``w3j(l1,l2,l3)`` is the (unique, for SO(3)) invariant 3-tensor with unit
  Frobenius norm, solved numerically as the null space of the equivariance
  constraints for a fixed set of deterministic rotations.  Sign is fixed by
  making the first entry with magnitude > 1e-8 positive.

All functions cache results in module-level dicts.
"""
from __future__ import annotations

import functools
from typing import Dict, Tuple

import numpy as np

__all__ = ["real_wigner_D", "w3j", "w3j_matrix", "sh_recursion_norm"]

# Real l=1 basis is CARTESIAN (x, y, z): D^1(R) == R and Y_1 = sqrt(3)(x,y,z),
# matching e3nn's convention so that 1e feature triples can be used directly as
# vectors (the reference's score head does exactly this,
# ``score_head.py:198-209``).  Higher-l bases come from the m-ordered real-SH
# construction conjugated accordingly; only self-consistency matters there.
_AXIS_PERM = (0, 1, 2)


def rand_rotation(rng: np.random.RandomState) -> np.ndarray:
    """Haar-ish random rotation via QR of a gaussian matrix."""
    m = rng.randn(3, 3)
    q, r = np.linalg.qr(m)
    q = q * np.sign(np.diag(r))
    if np.linalg.det(q) < 0:
        q[:, 0] = -q[:, 0]
    return q


# --------------------------------------------------------------------------- #
# Real irrep matrices via explicit complex Wigner-d + real basis change
# --------------------------------------------------------------------------- #
def d1_from_rotation(R: np.ndarray) -> np.ndarray:
    """Real l=1 irrep matrix in the (y,z,x) basis."""
    P = np.zeros((3, 3))
    for i, a in enumerate(_AXIS_PERM):
        P[i, a] = 1.0
    return P @ R @ P.T


@functools.lru_cache(maxsize=None)
def _factorials(n: int) -> Tuple[float, ...]:
    import math

    return tuple(float(math.factorial(k)) for k in range(n + 1))


def _wigner_small_d(l: int, beta: float) -> np.ndarray:
    """Complex Wigner small-d matrix d^l_{m'm}(beta), indices m', m = -l..l."""
    f = _factorials(2 * l)
    d = np.zeros((2 * l + 1, 2 * l + 1), dtype=np.float64)
    cb, sb = np.cos(beta / 2.0), np.sin(beta / 2.0)
    for mp in range(-l, l + 1):
        for m in range(-l, l + 1):
            pref = np.sqrt(f[l + mp] * f[l - mp] * f[l + m] * f[l - m])
            k_min = max(0, m - mp)
            k_max = min(l + m, l - mp)
            s = 0.0
            for k in range(k_min, k_max + 1):
                num = (-1.0) ** (mp - m + k)
                den = f[k] * f[l + m - k] * f[l - mp - k] * f[mp - m + k]
                pow_c = 2 * l + m - mp - 2 * k
                pow_s = mp - m + 2 * k
                s += num / den * (cb ** pow_c) * (sb ** pow_s)
            d[mp + l, m + l] = pref * s
    return d


def _euler_zyz(R: np.ndarray) -> Tuple[float, float, float]:
    """Extract (alpha, beta, gamma) with R = Rz(alpha) Ry(beta) Rz(gamma)."""
    beta = float(np.arccos(np.clip(R[2, 2], -1.0, 1.0)))
    if abs(R[2, 2]) > 1.0 - 1e-12:
        # gimbal: fold everything into alpha
        alpha = float(np.arctan2(R[1, 0], R[0, 0]))
        if R[2, 2] < 0:
            alpha = -alpha
        gamma = 0.0
    else:
        alpha = float(np.arctan2(R[1, 2], R[0, 2]))
        gamma = float(np.arctan2(R[2, 1], -R[2, 0]))
    return alpha, beta, gamma


def _complex_wigner_D(l: int, R: np.ndarray) -> np.ndarray:
    a, b, g = _euler_zyz(R)
    m = np.arange(-l, l + 1)
    d = _wigner_small_d(l, b)
    return np.exp(-1j * m[:, None] * a) * d * np.exp(-1j * m[None, :] * g)


@functools.lru_cache(maxsize=None)
def _real_basis_Q(l: int) -> np.ndarray:
    """Unitary change of basis: rows = real index mu=-l..l, cols = complex m."""
    q = np.zeros((2 * l + 1, 2 * l + 1), dtype=np.complex128)
    for m in range(-l, 0):
        q[l + m, l + abs(m)] = 1.0 / np.sqrt(2.0)
        q[l + m, l - abs(m)] = -1j / np.sqrt(2.0)
    q[l, l] = 1.0
    for m in range(1, l + 1):
        q[l + m, l + abs(m)] = ((-1.0) ** m) / np.sqrt(2.0)
        q[l + m, l - abs(m)] = (1j * (-1.0) ** m) / np.sqrt(2.0)
    return ((-1j) ** l) * q


def real_wigner_D(l: int, R: np.ndarray) -> np.ndarray:
    """Real-basis Wigner-D matrix of degree ``l`` for rotation matrix ``R``.

    ``D_real = Q^† conj(D_complex) Q`` — the variant is anchored so that
    l=1 equals ``P R P^T`` in the (y,z,x) basis (verified in tests).
    """
    if l == 0:
        return np.ones((1, 1), dtype=np.float64)
    if l == 1:
        return d1_from_rotation(R)  # cartesian basis: D^1 == R
    Q = _real_basis_Q(l)
    X = Q.conj().T @ _complex_wigner_D(l, R).conj() @ Q
    assert np.abs(X.imag).max() < 1e-9, f"non-real Wigner D at l={l}"
    return np.ascontiguousarray(X.real)


# --------------------------------------------------------------------------- #
# Wigner 3j (real basis) via invariant-subspace solve
# --------------------------------------------------------------------------- #
_W3J_CACHE: Dict[Tuple[int, int, int], np.ndarray] = {}


def _solve_invariant(l1: int, l2: int, l3: int) -> np.ndarray:
    d1, d2, d3 = 2 * l1 + 1, 2 * l2 + 1, 2 * l3 + 1
    dim = d1 * d2 * d3
    rng = np.random.RandomState(12345)
    rows = []
    for _ in range(6):
        R = rand_rotation(rng)
        K = np.kron(np.kron(real_wigner_D(l1, R), real_wigner_D(l2, R)), real_wigner_D(l3, R))
        rows.append(K - np.eye(dim))
    A = np.concatenate(rows, axis=0)
    _, s, vt = np.linalg.svd(A)
    null_mask = s < 1e-8
    n_null = int(np.sum(null_mask)) + max(0, dim - len(s))
    if n_null != 1:
        raise ValueError(f"w3j({l1},{l2},{l3}): invariant subspace has dim {n_null}, expected 1")
    v = vt[-1]
    # deterministic sign: first entry with |v|>1e-8 made positive
    for x in v:
        if abs(x) > 1e-8:
            if x < 0:
                v = -v
            break
    v = v / np.linalg.norm(v)
    return v.reshape(d1, d2, d3)


def w3j(l1: int, l2: int, l3: int) -> np.ndarray:
    """Real Wigner-3j tensor, shape (2l1+1, 2l2+1, 2l3+1), unit Frobenius norm.

    Zero tensor if the selection rule |l1-l2| <= l3 <= l1+l2 fails.
    """
    key = (l1, l2, l3)
    if key not in _W3J_CACHE:
        if not (abs(l1 - l2) <= l3 <= l1 + l2):
            _W3J_CACHE[key] = np.zeros((2 * l1 + 1, 2 * l2 + 1, 2 * l3 + 1))
        else:
            _W3J_CACHE[key] = _solve_invariant(l1, l2, l3)
    return _W3J_CACHE[key]


def w3j_matrix(l1: int, l2: int, l3: int) -> np.ndarray:
    """w3j reshaped to ((2l1+1)*(2l2+1), 2l3+1)."""
    return w3j(l1, l2, l3).reshape(-1, 2 * l3 + 1)


# --------------------------------------------------------------------------- #
# Spherical-harmonic normalization constants
# --------------------------------------------------------------------------- #
@functools.lru_cache(maxsize=None)
def sh_recursion_norm(l: int) -> float:
    """Constant ``c_l`` such that ``Y_l = c_l * einsum('a,b,abm->m', Y_1, Y_{l-1}, w3j(1,l-1,l))``
    yields component-normalized SH with ``|Y_l(u)| = sqrt(2l+1)`` on the unit
    sphere (e3nn ``normalization='component'``, cf. ``graph_parser.py:135``)."""
    assert l >= 2
    u = np.array([0.3, -0.5, 0.81240384])  # arbitrary unit-ish vector
    u = u / np.linalg.norm(u)
    y = _sh_oracle(l - 1, u)
    y1 = _sh_oracle(1, u)
    raw = np.einsum("a,b,abm->m", y1, y, w3j(1, l - 1, l))
    norm = np.linalg.norm(raw)
    return float(np.sqrt(2 * l + 1) / norm)


def _sh_oracle(l: int, u: np.ndarray) -> np.ndarray:
    """Reference (numpy) real SH of a unit vector, component-normalized."""
    if l == 0:
        return np.ones(1)
    if l == 1:
        return np.sqrt(3.0) * u[list(_AXIS_PERM)]
    c = sh_recursion_norm(l)
    return c * np.einsum("a,b,abm->m", _sh_oracle(1, u), _sh_oracle(l - 1, u), w3j(1, l - 1, l))
