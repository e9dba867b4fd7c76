"""O(3) irreducible-representation algebra.

A small, self-contained replacement for the e3nn ``Irreps`` machinery the
reference builds on (reference: sevenn/nn/convolution.py:72-95,
sevenn/util.py:289-313).  Conventions are chosen to be bit-compatible with
e3nn so that weights exported from reference checkpoints/TorchScript can be
imported directly:

- an irrep is ``(l, p)`` with ``l >= 0`` and parity ``p in {+1, -1}``
- irreps are ordered like e3nn: for each l the "spherical-harmonics-like"
  parity ``p = (-1)**l`` sorts first
- string syntax ``"128x0e+64x1o"`` round-trips with e3nn
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Iterable, Iterator, List, Sequence, Tuple, Union


@dataclass(frozen=True, order=False)
class Irrep:
    l: int
    p: int

    def __post_init__(self):
        if self.l < 0 or self.p not in (1, -1):
            raise ValueError(f'invalid irrep l={self.l} p={self.p}')

    @property
    def dim(self) -> int:
        return 2 * self.l + 1

    @staticmethod
    def parse(s: Union[str, 'Irrep', Tuple[int, int]]) -> 'Irrep':
        if isinstance(s, Irrep):
            return s
        if isinstance(s, tuple):
            return Irrep(int(s[0]), int(s[1]))
        s = s.strip()
        m = re.fullmatch(r'(\d+)([eo])', s)
        if m is None:
            raise ValueError(f'cannot parse irrep: {s!r}')
        return Irrep(int(m.group(1)), 1 if m.group(2) == 'e' else -1)

    def __mul__(self, other: 'Irrep') -> Iterator['Irrep']:
        """Selection rule of the tensor product (list of output irreps)."""
        other = Irrep.parse(other)
        p = self.p * other.p
        for l in range(abs(self.l - other.l), self.l + other.l + 1):
            yield Irrep(l, p)

    def is_scalar(self) -> bool:
        return self.l == 0 and self.p == 1

    # e3nn sort order: (l, p) with odd parity before even for every l
    # (verified against the layouts of the reference's frozen TorchScript
    # models: 0o sorts before 0e, 1o before 1e)
    def _key(self):
        return (self.l, self.p)

    def __lt__(self, other):
        return self._key() < Irrep.parse(other)._key()

    def __eq__(self, other):
        try:
            other = Irrep.parse(other)
        except (ValueError, TypeError):
            return NotImplemented
        return self.l == other.l and self.p == other.p

    def __hash__(self):
        return hash((self.l, self.p))

    def __repr__(self):
        return f'{self.l}{"e" if self.p == 1 else "o"}'


@dataclass(frozen=True)
class MulIrrep:
    mul: int
    ir: Irrep

    @property
    def dim(self) -> int:
        return self.mul * self.ir.dim

    def __repr__(self):
        return f'{self.mul}x{self.ir}'

    def __iter__(self):
        # allow destructuring: mul, ir = mul_irrep
        yield self.mul
        yield self.ir


IrrepsLike = Union[str, 'Irreps', Sequence]


class Irreps(tuple):
    """Ordered direct sum of multiplicities of irreps, e.g. 128x0e+64x1o."""

    def __new__(cls, irreps: IrrepsLike = ()):
        if isinstance(irreps, Irreps):
            return super().__new__(cls, irreps)
        out: List[MulIrrep] = []
        if isinstance(irreps, str):
            if irreps.strip():
                for token in irreps.split('+'):
                    token = token.strip()
                    if 'x' in token:
                        mul_s, ir_s = token.split('x')
                        out.append(MulIrrep(int(mul_s), Irrep.parse(ir_s)))
                    else:
                        out.append(MulIrrep(1, Irrep.parse(token)))
        elif isinstance(irreps, Irrep):
            out.append(MulIrrep(1, irreps))
        elif isinstance(irreps, MulIrrep):
            out.append(irreps)
        else:
            for item in irreps:
                if isinstance(item, MulIrrep):
                    out.append(item)
                elif isinstance(item, Irrep):
                    out.append(MulIrrep(1, item))
                else:
                    mul, ir = item
                    out.append(MulIrrep(int(mul), Irrep.parse(ir)))
        return super().__new__(cls, out)

    # ---- properties ----
    @property
    def dim(self) -> int:
        return sum(mi.dim for mi in self)

    @property
    def num_irreps(self) -> int:
        return sum(mi.mul for mi in self)

    @property
    def lmax(self) -> int:
        if len(self) == 0:
            raise ValueError('empty irreps has no lmax')
        return max(mi.ir.l for mi in self)

    @property
    def ls(self) -> List[int]:
        return [mi.ir.l for mi in self for _ in range(mi.mul)]

    def slices(self) -> List[slice]:
        out = []
        pos = 0
        for mi in self:
            out.append(slice(pos, pos + mi.dim))
            pos += mi.dim
        return out

    def count(self, ir) -> int:  # type: ignore[override]
        ir = Irrep.parse(ir)
        return sum(mi.mul for mi in self if mi.ir == ir)

    def __contains__(self, ir) -> bool:
        try:
            ir = Irrep.parse(ir)
        except (ValueError, TypeError):
            return False
        return any(mi.ir == ir for mi in self)

    # ---- algebra ----
    def __add__(self, other) -> 'Irreps':
        return Irreps(tuple.__add__(self, Irreps(other)))

    def __radd__(self, other) -> 'Irreps':
        return Irreps(tuple.__add__(Irreps(other), self))

    def sort(self):
        """Stable sort by irrep; returns (sorted irreps, permutation, inverse).

        ``perm[i]`` is the new position of original entry i (matching e3nn's
        ``Irreps.sort().p`` inverse convention used by the reference conv
        instruction remap, reference: sevenn/nn/convolution.py:82-87).
        """
        order = sorted(range(len(self)), key=lambda i: self[i].ir._key())
        sorted_irreps = Irreps([self[i] for i in order])
        inv = [0] * len(self)
        for new_pos, old_pos in enumerate(order):
            inv[old_pos] = new_pos
        return sorted_irreps, inv, order

    def simplify(self) -> 'Irreps':
        out: List[MulIrrep] = []
        for mi in self:
            if out and out[-1].ir == mi.ir:
                out[-1] = MulIrrep(out[-1].mul + mi.mul, mi.ir)
            elif mi.mul > 0:
                out.append(mi)
        return Irreps(out)

    def filter(self, keep) -> 'Irreps':
        keep = [Irrep.parse(k) for k in keep]
        return Irreps([mi for mi in self if mi.ir in keep])

    @staticmethod
    def spherical_harmonics(lmax: int, p: int = -1) -> 'Irreps':
        return Irreps([(1, Irrep(l, p ** l)) for l in range(lmax + 1)])

    def __repr__(self):
        return '+'.join(repr(mi) for mi in self) if len(self) else ''


def tp_out_irreps(
    irreps_a: Irreps,
    irreps_b: Irreps,
    drop_l: Union[bool, int] = False,
    parity_mode: str = 'full',
    fix_multiplicity: Union[bool, int] = False,
) -> Irreps:
    """Infer simplified tensor-product output irreps with filters.

    Semantics follow the reference's irreps-inference helper used by the
    model builder (reference: sevenn/util.py:289-313): the full tensor
    product output is simplified, then filtered by max l and parity mode
    ('full' | 'even' | 'sph'), optionally overriding the multiplicity.
    """
    assert parity_mode in ('full', 'even', 'sph')
    # full tensor product output irreps, e3nn-sorted and simplified
    prods: List[MulIrrep] = []
    for mul_a, ir_a in irreps_a:
        for mul_b, ir_b in irreps_b:
            for ir_out in ir_a * ir_b:
                prods.append(MulIrrep(mul_a * mul_b, ir_out))
    out = Irreps(prods).sort()[0].simplify()

    kept: List[MulIrrep] = []
    for mul, ir in out:
        if drop_l is not False and ir.l > drop_l:
            continue
        if parity_mode == 'even' and ir.p == -1:
            continue
        if parity_mode == 'sph' and ir.p != (-1) ** ir.l:
            continue
        if fix_multiplicity:
            mul = int(fix_multiplicity)
        kept.append(MulIrrep(mul, ir))
    return Irreps(kept)
