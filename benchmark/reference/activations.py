"""Activation functions with second-moment normalization.

Frozen copy of the port's plain ``ops/activations.py`` for the benchmark's
reference, which imports nothing of the program (that module is a port of
the JAX package's ``ops/activations.py``): e3nn-compatible
non-linearities rescaled so that E[act(z)^2] = 1 for z ~ N(0,1), with the
constant estimated the way e3nn does (1e6 standard normals from a fixed
seed), so imported weights give identical outputs.
"""

from __future__ import annotations

import math
from functools import lru_cache
from typing import Callable

import numpy as np
import torch
import torch.nn.functional as F

_LOG2 = math.log(2.0)


def shifted_softplus(x):
    return F.softplus(x) - _LOG2


_ACTS = {
    'silu': F.silu,
    'ssp': shifted_softplus,
    'tanh': torch.tanh,
    'abs': torch.abs,
    'relu': F.relu,
    'sigmoid': torch.sigmoid,
    'elu': F.elu,
}

_NP_ACTS = {
    'silu': lambda x: x / (1.0 + np.exp(-x)),
    'ssp': lambda x: np.logaddexp(0.0, x) - _LOG2,
    'tanh': np.tanh,
    'abs': np.abs,
    'relu': lambda x: np.maximum(x, 0.0),
    'sigmoid': lambda x: 1.0 / (1.0 + np.exp(-x)),
    'elu': lambda x: np.where(x > 0, x, np.expm1(x)),
}


@lru_cache(maxsize=None)
def moment2_const(name: str) -> float:
    """1/sqrt(E[f(z)^2]), z from the same fixed-seed draw e3nn uses."""
    gen = torch.Generator(device='cpu').manual_seed(0)
    z = torch.randn(1_000_000, generator=gen, dtype=torch.float64).numpy()
    m2 = float(np.mean(_NP_ACTS[name](z) ** 2))
    return m2 ** (-0.5)


@lru_cache(maxsize=None)
def get_activation(name: str, normalized: bool = False) -> Callable:
    """Plain or second-moment-normalized activation by name (cached, so
    specs that embed activations stay value-comparable)."""
    base = _ACTS[name]
    if not normalized:
        return base
    c = moment2_const(name)
    return lambda x: base(x) * c
