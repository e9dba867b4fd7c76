"""Equivariant linear layers over irreps (e3nn-Linear-compatible).

Frozen copy of the port's plain ``ops/linear.py`` for the benchmark's
reference, which imports nothing of the program (that module is a port of
the JAX package's ``ops/linear.py``): block-diagonal mixing
of equal irreps with 'element' path normalization 1/sqrt(fan_in) and
optional biases on scalar outputs.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np
import torch

from .irreps import Irreps


@dataclass(frozen=True)
class LinearInstruction:
    i_in: int      # -1 for bias
    i_out: int
    coeff: float
    weight_shape: Tuple[int, ...]


@dataclass(frozen=True)
class LinearSpec:
    irreps_in: Irreps
    irreps_out: Irreps
    instructions: Tuple[LinearInstruction, ...]
    biases: bool


def linear_spec(
    irreps_in: Irreps,
    irreps_out: Irreps,
    biases: bool = False,
) -> LinearSpec:
    irreps_in = Irreps(irreps_in)
    irreps_out = Irreps(irreps_out)
    raw: List[dict] = []
    for i, (mul_in, ir_in) in enumerate(irreps_in):
        for j, (mul_out, ir_out) in enumerate(irreps_out):
            if ir_in == ir_out:
                raw.append(dict(i_in=i, i_out=j, shape=(mul_in, mul_out)))
    if biases:
        for j, (mul_out, ir_out) in enumerate(irreps_out):
            if ir_out.is_scalar():
                raw.append(dict(i_in=-1, i_out=j, shape=(mul_out,)))

    instructions = []
    for ins in raw:
        # element path normalization: fan = sum of input muls into this
        # output (bias paths count 1)
        fan = sum(
            (irreps_in[o['i_in']].mul if o['i_in'] >= 0 else 1)
            for o in raw
            if o['i_out'] == ins['i_out']
        )
        coeff = 1.0 / math.sqrt(fan) if ins['i_in'] >= 0 else 1.0
        instructions.append(
            LinearInstruction(ins['i_in'], ins['i_out'], coeff, ins['shape'])
        )
    return LinearSpec(irreps_in, irreps_out, tuple(instructions), biases)


def init_linear_weights(spec: LinearSpec, rng: np.random.Generator):
    """e3nn init: standard-normal weights, zero biases (the JAX package's
    draws, in its order, from the same generator)."""
    out = []
    for ins in spec.instructions:
        if ins.i_in >= 0:
            out.append(rng.standard_normal(ins.weight_shape).astype(np.float32))
        else:
            out.append(np.zeros(ins.weight_shape, dtype=np.float32))
    return out


def apply_linear(
    spec: LinearSpec,
    weights,
    x: torch.Tensor,
    out_stride: bool = False,
) -> torch.Tensor:
    """x: [..., irreps_in.dim] -> [..., irreps_out.dim].

    ``out_stride=True`` emits each output chunk in the stride layout
    [ir.dim, mul] (i-major) instead of e3nn's [mul, ir.dim] -- the layout
    the fused convolution consumes (ops/fused_conv.py).
    """
    sl_in = spec.irreps_in.slices()
    n_out = len(spec.irreps_out)
    chunks: List[Optional[torch.Tensor]] = [None] * n_out
    for ins, w in zip(spec.instructions, weights):
        mo = spec.irreps_out[ins.i_out]
        w = w.to(x.dtype)
        if ins.i_in >= 0:
            mi = spec.irreps_in[ins.i_in]
            a = x[..., sl_in[ins.i_in]].reshape(
                x.shape[:-1] + (mi.mul, mi.ir.dim)
            )
            res = ins.coeff * torch.einsum('...ui,uv->...iv', a, w)
            if not out_stride:
                res = res.transpose(-1, -2)
            res = res.reshape(res.shape[:-2] + (mo.dim,))
        else:  # bias on scalars (d == 1: both layouts coincide)
            res = w.expand(x.shape[:-1] + (mo.mul,))
        chunks[ins.i_out] = res if chunks[ins.i_out] is None \
            else chunks[ins.i_out] + res
    out = []
    for k, mo in enumerate(spec.irreps_out):
        if chunks[k] is None:
            out.append(x.new_zeros(x.shape[:-1] + (mo.dim,)))
        else:
            out.append(chunks[k])
    return torch.cat(out, dim=-1)
