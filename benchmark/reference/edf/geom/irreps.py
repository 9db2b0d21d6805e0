"""Static irreps metadata for O(3)-equivariant features.

A feature array carrying irreps ``irreps = ((mul_0, l_0, p_0), ...)`` has its
last axis laid out as the concatenation of blocks ``mul_i * (2*l_i + 1)``,
each block stored as ``[mul, 2l+1]`` flattened row-major (multiplicity-major,
matching e3nn's layout so that a future checkpoint importer is a pure
reshape).

Everything here is *static* python metadata resolved at trace time: irreps
never appear as runtime data on the device.  This mirrors the role of
``e3nn.o3.Irreps`` in the reference (used throughout, e.g.
``diffusion_edf/equiformer/tensor_product_rescale.py:30-32``)
but is a plain hashable tuple type so it can key caches of constant tables.
(A copy of the JAX package's ``geom/irreps.py``; the port keeps its own so
that it never imports the JAX package.)
"""
from __future__ import annotations

import re
from typing import Iterable, List, Sequence, Tuple, Union

__all__ = [
    "Irrep",
    "Irreps",
    "multiply_irreps",
    "sort_irreps_even_first",
]


class Irrep(tuple):
    """A single irrep ``(l, p)`` with degree ``l >= 0`` and parity ``p ∈ {1,-1}``."""

    def __new__(cls, l: int, p: int):
        assert l >= 0 and p in (1, -1), (l, p)
        return super().__new__(cls, (int(l), int(p)))

    @property
    def l(self) -> int:  # noqa: E743
        return self[0]

    @property
    def p(self) -> int:
        return self[1]

    @property
    def dim(self) -> int:
        return 2 * self[0] + 1

    def __mul__(self, other: "Irrep") -> List["Irrep"]:
        """Selection rule: l ∈ |l1-l2| .. l1+l2, p = p1*p2."""
        l1, p1 = self
        l2, p2 = other
        return [Irrep(l, p1 * p2) for l in range(abs(l1 - l2), l1 + l2 + 1)]

    def __repr__(self) -> str:
        return f"{self.l}{'e' if self.p == 1 else 'o'}"


_IRREP_RE = re.compile(r"^(?:(\d+)x)?(\d+)([eo])$")


def _parse(spec) -> Tuple[Tuple[int, Irrep], ...]:
    if spec is None:
        return ()
    if isinstance(spec, Irreps):
        return tuple(spec)
    if isinstance(spec, str):
        out = []
        spec = spec.strip()
        if not spec:
            return ()
        for term in spec.split("+"):
            m = _IRREP_RE.match(term.strip())
            if not m:
                raise ValueError(f"Cannot parse irreps term {term!r}")
            mul = int(m.group(1)) if m.group(1) else 1
            l = int(m.group(2))
            p = 1 if m.group(3) == "e" else -1
            out.append((mul, Irrep(l, p)))
        return tuple(out)
    # iterable of (mul, Irrep) or (mul, (l, p))
    out = []
    for item in spec:
        mul, ir = item
        if not isinstance(ir, Irrep):
            ir = Irrep(*ir)
        out.append((int(mul), ir))
    return tuple(out)


class Irreps(tuple):
    """An ordered sequence of ``(mul, Irrep)`` pairs.  Hashable and static.

    Accepts e3nn-style strings: ``"64x0e+32x1e+16x2e"``.
    """

    def __new__(cls, spec: Union[str, "Irreps", Iterable, None] = ()):  # type: ignore[override]
        return super().__new__(cls, _parse(spec))

    # ---- structure ----
    @property
    def dim(self) -> int:
        return sum(mul * ir.dim for mul, ir in self)

    @property
    def num_irreps(self) -> int:
        return sum(mul for mul, _ in self)

    @property
    def lmax(self) -> int:
        return max((ir.l for _, ir in self), default=0)

    @property
    def ls(self) -> List[int]:
        return [ir.l for _, ir in self]

    def slices(self) -> List[slice]:
        out, i = [], 0
        for mul, ir in self:
            out.append(slice(i, i + mul * ir.dim))
            i += mul * ir.dim
        return out

    def count(self, ir) -> int:  # type: ignore[override]
        if not isinstance(ir, Irrep):
            if isinstance(ir, str):
                (_, parsed), = _parse(ir)
                ir = parsed
            else:
                ir = Irrep(*ir)
        return sum(mul for mul, i in self if i == ir)

    @property
    def mul_0(self) -> int:
        """Number of even scalars (``get_mul_0`` in the reference,
        ``equiformer/graph_attention_transformer.py:51-56``)."""
        return self.count(Irrep(0, 1))

    # ---- algebra ----
    def __add__(self, other) -> "Irreps":  # type: ignore[override]
        return Irreps(tuple(self) + tuple(Irreps(other)))

    def __mul__(self, k: int) -> "Irreps":  # type: ignore[override]
        """Multiply multiplicities (NOT repetition): ``2 * "4x1e" = "8x1e"``
        matches e3nn's ``Irreps.__mul__`` used by ``irreps_mlp_mid``
        (``gnn_block.py:106``) -- e3nn repeats the list; we repeat then rely on
        simplify() at call sites.  To stay faithful we repeat the sequence."""
        return Irreps(tuple(self) * int(k))

    __rmul__ = __mul__

    def repeat(self, k: int) -> "Irreps":
        return Irreps(tuple(self) * int(k))

    def simplify(self) -> "Irreps":
        out: List[Tuple[int, Irrep]] = []
        for mul, ir in self:
            if mul == 0:
                continue
            if out and out[-1][1] == ir:
                out[-1] = (out[-1][0] + mul, ir)
            else:
                out.append((mul, ir))
        return Irreps(out)

    def __repr__(self) -> str:
        return "+".join(f"{mul}x{ir}" for mul, ir in self) or "(empty)"


def multiply_irreps(irreps: Union[str, Irreps], mult: float, strict: bool = True) -> Irreps:
    """Scale every multiplicity (reference: ``irreps_utils.py:7-17``)."""
    irreps = Irreps(irreps)
    out = []
    for mul, ir in irreps:
        if strict and round(mul * mult) != mul * mult:
            raise ValueError(f"{irreps} cannot be multiplied by {mult}")
        out.append((round(mul * mult), ir))
    return Irreps(out)


def sort_irreps_even_first(irreps: Union[str, Irreps]):
    """Sort by (l, even-before-odd); returns (sorted_irreps, perm, inv).

    ``perm[i]`` gives the new position of original entry ``i`` (matching the
    usage in ``DepthwiseTensorProduct``,
    ``equiformer/tensor_product_rescale.py:374-376``).
    """
    irreps = Irreps(irreps)
    keyed = [(ir.l, -ir.p, i, mul, ir) for i, (mul, ir) in enumerate(irreps)]
    keyed.sort(key=lambda t: (t[0], t[1], t[2]))
    inv = [t[2] for t in keyed]
    perm = [0] * len(inv)
    for new_pos, orig in enumerate(inv):
        perm[orig] = new_pos
    sorted_irreps = Irreps([(mul, ir) for _, _, _, mul, ir in keyed])
    return sorted_irreps, tuple(perm), tuple(inv)
