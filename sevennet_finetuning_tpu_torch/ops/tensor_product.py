"""Clebsch-Gordan tensor-product specs (host-side, static).

The spec half of ``sevennet_finetuning_tpu/ops/tensor_product.py``: the
'uvu' per-edge weighted TP of the convolution, with e3nn's 'component'
irrep normalization and 'element' path normalization so reference weights
import unchanged.  The fused convolution (``ops/fused_conv.py``) builds its
layout from these specs; evaluating a TP outside it waits for a later
slice.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Tuple

import numpy as np

from ..irreps import Irreps, MulIrrep


@dataclass(frozen=True)
class TPInstruction:
    i_in1: int
    i_in2: int
    i_out: int
    mode: str                 # 'uvu' | 'uvw'
    has_weight: bool
    coeff: float              # sqrt(alpha): irrep + path normalization
    weight_shape: Tuple[int, ...]
    weight_offset: int = 0    # into flat weight vector (uvu only)


def _num_elements(mode: str, mul1: int, mul2: int) -> int:
    if mode == 'uvw':
        return mul1 * mul2
    if mode == 'uvu':
        return mul2
    if mode == 'uvv':
        return mul1
    if mode == 'uuu':
        return 1
    raise ValueError(mode)


def _normalize(
    instructions: List[dict],
    irreps_in1: Irreps,
    irreps_in2: Irreps,
    irreps_out: Irreps,
) -> List[TPInstruction]:
    """Attach sqrt(alpha) coefficients (component/element normalization)."""
    out = []
    offset = 0
    for ins in instructions:
        mul1 = irreps_in1[ins['i_in1']].mul
        mul2 = irreps_in2[ins['i_in2']].mul
        ir_out = irreps_out[ins['i_out']].ir
        alpha = ir_out.dim
        x = sum(
            _num_elements(
                other['mode'],
                irreps_in1[other['i_in1']].mul,
                irreps_in2[other['i_in2']].mul,
            )
            for other in instructions
            if other['i_out'] == ins['i_out']
        )
        if x > 0:
            alpha /= x
        coeff = math.sqrt(alpha)
        if ins['mode'] == 'uvu':
            wshape = (mul1,) if mul2 == 1 else (mul1, mul2)
        elif ins['mode'] == 'uvw':
            wshape = (mul1, mul2, irreps_out[ins['i_out']].mul)
        else:
            raise ValueError(ins['mode'])
        out.append(
            TPInstruction(
                ins['i_in1'], ins['i_in2'], ins['i_out'], ins['mode'],
                ins['has_weight'], coeff, wshape, offset,
            )
        )
        offset += int(np.prod(wshape))
    return out


@dataclass(frozen=True)
class TensorProductSpec:
    irreps_in1: Irreps
    irreps_in2: Irreps
    irreps_out: Irreps
    instructions: Tuple[TPInstruction, ...]
    shared_weights: bool

    @property
    def weight_numel(self) -> int:
        return sum(int(np.prod(i.weight_shape)) for i in self.instructions)


def uvu_tp_spec(
    irreps_in1: Irreps,
    irreps_in2: Irreps,
    irreps_out_filter: Irreps,
) -> TensorProductSpec:
    """The convolution TP: one 'uvu' path per (in1, in2, allowed l_out),
    outputs e3nn-sorted (reference: sevenn/nn/convolution.py:72-87)."""
    raw: List[dict] = []
    mid: List[MulIrrep] = []
    for i, (mul_x, ir_x) in enumerate(irreps_in1):
        for j, (_, ir_f) in enumerate(irreps_in2):
            for ir_out in ir_x * ir_f:
                if ir_out in irreps_out_filter:
                    k = len(mid)
                    mid.append(MulIrrep(mul_x, ir_out))
                    raw.append(
                        dict(i_in1=i, i_in2=j, i_out=k, mode='uvu',
                             has_weight=True)
                    )
    irreps_mid = Irreps(mid)
    irreps_mid, perm, _ = irreps_mid.sort()
    for ins in raw:
        ins['i_out'] = perm[ins['i_out']]
    instructions = _normalize(raw, irreps_in1, irreps_in2, irreps_mid)
    return TensorProductSpec(
        Irreps(irreps_in1), Irreps(irreps_in2), irreps_mid,
        tuple(instructions), shared_weights=False,
    )
