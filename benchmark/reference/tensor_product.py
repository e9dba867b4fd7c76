"""Clebsch-Gordan tensor products over irreps.

Frozen copy of the port's plain ``ops/tensor_product.py`` for the benchmark's
reference, which imports nothing of the program (that module is a port of
the JAX package's ``ops/tensor_product.py``), with e3nn's
'component' irrep normalization and 'element' path normalization so
reference weights import unchanged:

- ``uvu_tp_spec``: the per-edge weighted TP of the convolution (the
  reference evaluates it in ``model.uvu_conv``);
- ``fctp_spec``: the fully connected 'uvw' TP with shared weights, the
  NequIP self-connection (x with the one-hot species embedding);
- ``apply_tp``: plain PyTorch evaluation of the 'uvw' TP;
- ``init_tp_weights``: standard-normal weights drawn in the JAX order.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Tuple

import numpy as np
import torch

from .irreps import Irreps, MulIrrep
from .wigner import wigner_3j


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


def fctp_spec(
    irreps_in1: Irreps,
    irreps_in2: Irreps,
    irreps_out: Irreps,
) -> TensorProductSpec:
    """FullyConnectedTensorProduct: 'uvw' paths, internal shared weights."""
    raw: List[dict] = []
    for i, (_, ir_1) in enumerate(irreps_in1):
        for j, (_, ir_2) in enumerate(irreps_in2):
            for k, (_, ir_o) in enumerate(irreps_out):
                if ir_o in ir_1 * ir_2:
                    raw.append(
                        dict(i_in1=i, i_in2=j, i_out=k, mode='uvw',
                             has_weight=True)
                    )
    instructions = _normalize(raw, irreps_in1, irreps_in2, Irreps(irreps_out))
    return TensorProductSpec(
        Irreps(irreps_in1), Irreps(irreps_in2), Irreps(irreps_out),
        tuple(instructions), shared_weights=True,
    )


def apply_tp(spec: TensorProductSpec, x1: torch.Tensor, x2: torch.Tensor,
             weights) -> torch.Tensor:
    """Evaluate a fully connected ('uvw', shared weights) TP in plain
    PyTorch: x1 [..., irreps_in1.dim], x2 [..., irreps_in2.dim],
    ``weights`` a list of per-instruction tensors.  The per-edge 'uvu' TP
    of the convolution is ``model.uvu_conv``."""
    if not spec.shared_weights:
        raise NotImplementedError(
            "per-edge 'uvu' TPs are model.uvu_conv, not apply_tp")
    sl1 = spec.irreps_in1.slices()
    sl2 = spec.irreps_in2.slices()
    chunks: List = [None] * len(spec.irreps_out)
    for ins, w in zip(spec.instructions, weights):
        mi1 = spec.irreps_in1[ins.i_in1]
        mi2 = spec.irreps_in2[ins.i_in2]
        mo = spec.irreps_out[ins.i_out]
        a = x1[..., sl1[ins.i_in1]].reshape(
            x1.shape[:-1] + (mi1.mul, mi1.ir.dim))
        b = x2[..., sl2[ins.i_in2]].reshape(
            x2.shape[:-1] + (mi2.mul, mi2.ir.dim))
        C = torch.as_tensor(
            wigner_3j(mi1.ir.l, mi2.ir.l, mo.ir.l) * ins.coeff,
            dtype=x1.dtype, device=x1.device)
        res = torch.einsum('...ui,...vj,ijk,uvw->...wk', a, b, C,
                           w.to(x1.dtype))
        res = res.reshape(res.shape[:-2] + (mo.dim,))
        chunks[ins.i_out] = (res if chunks[ins.i_out] is None
                             else chunks[ins.i_out] + res)
    out = [chunks[k] if chunks[k] is not None else
           x1.new_zeros(x1.shape[:-1] + (mo.dim,))
           for k, mo in enumerate(spec.irreps_out)]
    return torch.cat(out, dim=-1)


def init_tp_weights(spec: TensorProductSpec, rng: np.random.Generator):
    """e3nn-style standard-normal internal weights (uvw/shared only)."""
    assert spec.shared_weights
    return [
        rng.standard_normal(ins.weight_shape).astype(np.float32)
        for ins in spec.instructions
    ]
