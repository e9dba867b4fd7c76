"""Scalar MLP with e3nn FullyConnectedNet semantics.

Port of ``sevennet_finetuning_tpu/ops/mlp.py``: each layer computes
act(x @ W / sqrt(fan_in)) with a second-moment normalized activation; the
final layer has no activation.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch

from .activations import get_activation


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
