"""Scalar MLP with e3nn FullyConnectedNet semantics.

Frozen copy of the port's plain ``ops/mlp.py`` for the benchmark's
reference, which imports nothing of the program (that module is a port of
the JAX package's ``ops/mlp.py``): each layer computes
act(x @ W / sqrt(fan_in)) with a second-moment normalized activation; the
final layer has no activation.
"""

from __future__ import annotations

import math
from typing import List, Sequence

import numpy as np
import torch

from .activations import get_activation


def mlp_init(hs: Sequence[int], rng: np.random.Generator) -> List[np.ndarray]:
    """Standard-normal weights (the variance is the 1/sqrt(fan_in) of
    ``mlp_apply``), drawn as the JAX package draws them."""
    return [
        rng.standard_normal((h_in, h_out)).astype(np.float32)
        for h_in, h_out in zip(hs[:-1], hs[1:])
    ]


def mlp_apply(
    weights: Sequence[torch.Tensor],
    x: torch.Tensor,
    act_name: str,
) -> torch.Tensor:
    act = get_activation(act_name, normalized=True)
    n = len(weights)
    for i, w in enumerate(weights):
        x = x @ (w.to(x.dtype) / math.sqrt(w.shape[0]))
        if i < n - 1:
            x = act(x)
    return x
