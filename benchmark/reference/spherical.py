"""Real spherical harmonics in the e3nn basis.

Frozen copy of the port's plain ``ops/spherical.py`` for the benchmark's
reference, which imports nothing of the program (that module is a port of
the JAX package's ``ops/spherical.py``).  The basis comes
from the Wigner-3j recursion

    Y_l  propto  w3j(l-1, 1, l) : (Y_{l-1} x Y_1),      Y_1 = (x, y, z)

normalized so that the m=0 component equals +1 at the pole (0, 1, 0),
which reproduces e3nn's polynomial basis (y is the polar axis).
"""

from __future__ import annotations

from functools import lru_cache
from typing import Callable

import numpy as np
import torch

from .util import safe_norm
from .wigner import wigner_3j

_POLE = np.array([0.0, 1.0, 0.0])


@lru_cache(maxsize=None)
def _recursion_scales(lmax: int) -> tuple:
    """Per-l scale c_l s.t. sh_l = c_l * w3j-combine(sh_{l-1}, sh_1)."""
    scales = []
    prev = np.array([1.0])  # l=0 value at pole
    y1 = _POLE.copy()
    for l in range(1, lmax + 1):
        w = wigner_3j(l - 1, 1, l)
        raw = np.einsum('abk,a,b->k', w, prev, y1)
        c = 1.0 / raw[l]  # m=0 component at pole must be +1
        scales.append(c)
        prev = raw * c
    return tuple(scales)


def spherical_harmonics(
    lmax: int,
    normalize: bool = True,
    normalization: str = 'component',
) -> Callable[[torch.Tensor], torch.Tensor]:
    """Returns f(vec[..., 3]) -> sh[..., (lmax+1)^2] in e3nn layout/order."""
    assert normalization in ('component', 'norm', 'integral')
    scales = _recursion_scales(lmax) if lmax >= 1 else ()
    w3js = [np.asarray(wigner_3j(l - 1, 1, l)) for l in range(1, lmax + 1)]

    comp_mult = []
    for l in range(lmax + 1):
        if normalization == 'component':
            m = np.sqrt(2 * l + 1)
        elif normalization == 'norm':
            m = 1.0
        else:  # integral
            m = np.sqrt((2 * l + 1) / (4 * np.pi))
        comp_mult.append(np.full(2 * l + 1, m))
    comp_mult = np.concatenate(comp_mult)

    def f(vec: torch.Tensor) -> torch.Tensor:
        if normalize:
            vec = vec / safe_norm(vec, keepdim=True)
        blocks = [torch.ones(vec.shape[:-1] + (1,), dtype=vec.dtype,
                             device=vec.device)]
        if lmax >= 1:
            prev = vec
            blocks.append(prev)
            for l in range(2, lmax + 1):
                w = torch.as_tensor(w3js[l - 1] * scales[l - 1],
                                    dtype=vec.dtype, device=vec.device)
                prev = torch.einsum('...a,...b,abk->...k', prev, vec, w)
                blocks.append(prev)
        sh = torch.cat(blocks, dim=-1)
        return sh * torch.as_tensor(comp_mult, dtype=vec.dtype,
                                    device=vec.device)

    return f
