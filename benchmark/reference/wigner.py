"""Clebsch-Gordan / Wigner-3j machinery for real O(3) irreps.

Computed from first principles (Racah's formula + real<->complex basis
change), with phase conventions chosen to be numerically identical to the
coupling tensors the reference inherits from e3nn (used by its CG
tensor-product convolution, reference: sevenn/nn/convolution.py:88-95).
All coefficients are computed host-side in float64 with exact integer
arithmetic underneath, and cached.
"""

from __future__ import annotations

import math
from fractions import Fraction
from functools import lru_cache

import numpy as np


def _f(n: int) -> int:
    return math.factorial(n)


@lru_cache(maxsize=None)
def su2_cg_coeff(j1: int, j2: int, j3: int, m1: int, m2: int, m3: int) -> float:
    """<j1 m1 j2 m2 | j3 m3> via Racah's formula (exact rationals under sqrt)."""
    if m3 != m1 + m2:
        return 0.0
    if not (abs(j1 - j2) <= j3 <= j1 + j2):
        return 0.0
    if abs(m1) > j1 or abs(m2) > j2 or abs(m3) > j3:
        return 0.0
    pref = Fraction(
        (2 * j3 + 1)
        * _f(j3 + j1 - j2) * _f(j3 - j1 + j2) * _f(j1 + j2 - j3)
        * _f(j3 + m3) * _f(j3 - m3),
        _f(j1 + j2 + j3 + 1)
        * _f(j1 - m1) * _f(j1 + m1) * _f(j2 - m2) * _f(j2 + m2),
    )
    vmin = max(0, j2 + m3 - j1, m1 - j1)
    vmax = min(j2 + j3 + m1, j3 - j1 + j2, j3 + m3)
    total = Fraction(0)
    for v in range(vmin, vmax + 1):
        total += Fraction(
            (-1) ** (v + j2 + m2)
            * _f(j2 + j3 + m1 - v) * _f(j1 - m1 + v),
            _f(v) * _f(j3 - j1 + j2 - v) * _f(j3 + m3 - v)
            * _f(v + j1 - j2 - m3),
        )
    if total == 0:
        return 0.0
    sign = 1.0 if total > 0 else -1.0
    # C = sqrt(pref) * total = sign * sqrt(pref * total^2), kept exact
    return sign * math.sqrt(float(pref * total * total))


@lru_cache(maxsize=None)
def su2_clebsch_gordan(j1: int, j2: int, j3: int) -> np.ndarray:
    """CG tensor in the complex |j m> basis, shape (2j1+1, 2j2+1, 2j3+1)."""
    C = np.zeros((2 * j1 + 1, 2 * j2 + 1, 2 * j3 + 1))
    for m1 in range(-j1, j1 + 1):
        for m2 in range(-j2, j2 + 1):
            m3 = m1 + m2
            if abs(m3) <= j3:
                C[j1 + m1, j2 + m2, j3 + m3] = su2_cg_coeff(
                    j1, j2, j3, m1, m2, m3
                )
    return C


@lru_cache(maxsize=None)
def change_basis_real_to_complex(l: int) -> np.ndarray:
    """Unitary Q with Y_complex = Q @ Y_real (e3nn phase convention)."""
    q = np.zeros((2 * l + 1, 2 * l + 1), dtype=np.complex128)
    inv_sqrt2 = 1.0 / math.sqrt(2.0)
    for m in range(-l, 0):
        q[l + m, l + abs(m)] = inv_sqrt2
        q[l + m, l - abs(m)] = -1j * inv_sqrt2
    q[l, l] = 1.0
    for m in range(1, l + 1):
        q[l + m, l + abs(m)] = (-1) ** m * inv_sqrt2
        q[l + m, l - abs(m)] = 1j * (-1) ** m * inv_sqrt2
    # global phase that makes the real-basis 3j symbols real
    return (-1j) ** l * q


@lru_cache(maxsize=None)
def wigner_3j(l1: int, l2: int, l3: int) -> np.ndarray:
    """Real-basis Wigner 3j tensor, normalized to unit Frobenius norm.

    Symmetric under the combined exchange of (axis, l) pairs and invariant
    under real rotations: contract with D_l1 x D_l2 x D_l3 gives it back.
    """
    if not (abs(l1 - l2) <= l3 <= l1 + l2):
        return np.zeros((2 * l1 + 1, 2 * l2 + 1, 2 * l3 + 1))
    Q1 = change_basis_real_to_complex(l1)
    Q2 = change_basis_real_to_complex(l2)
    Q3 = change_basis_real_to_complex(l3)
    C = su2_clebsch_gordan(l1, l2, l3).astype(np.complex128)
    C = np.einsum('ij,kl,mn,ikn->jlm', Q1, Q2, np.conj(Q3.T), C)
    assert np.abs(C.imag).max() < 1e-10, 'phase convention broken'
    C = C.real
    # e3nn's overall sign convention per triple: relative to the plain
    # Condon-Shortley construction above, e3nn's tensors are negated
    # exactly when l1+l2+l3 is odd with (J+1)/2 odd, i.e. J = 1 (mod 4)
    # (verified bit-exact against every coupling tensor in the
    # reference's frozen TorchScript artifacts, all triples with l <= 2)
    J = l1 + l2 + l3
    if J % 2 == 1 and ((J + 1) // 2) % 2 == 1:
        C = -C
    return C / np.linalg.norm(C)
