"""The model's floating-point work, counted from the configuration's
layouts and the live edge and node counts, whatever implements it.

One forward pass (an energy) counts, with a multiply-add as 2:

- per live edge: the radial MLP (2 h_in h_out a layer); each path of
  each convolution's 'uvu' product (l1 x l2 -> l_out, mul channels):
  2 nnz(C) for sh x C, then mul (2 nnz(C) + 2 d_out) for the channel
  contraction, the per-edge weight and the sum into the destination;
- per node: each equivariant linear (2 mul_in mul_out d per path),
  the self-connection (a linear, or the fully connected product with the
  one-hot species: 2 mul1 mul2 mul_out d a path), the gate (3 an
  element), the symmetric contraction (2 numel(U_nu) C per order and
  output irrep, and 2 k_nu C n_species for the per-species weights), and
  the readout.

The Bessel basis, the cutoff and the spherical harmonics are a few dozen
operations an edge and are left out.  By the usual convention a backward
costs twice its forward: a force evaluation (energy, forces, stress) is
3 forwards, a train step (that, and the backward through both) 9.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from ..reference.model import Spec, build_spec
from ..reference.symmetric_contraction import u_matrix
from ..reference.wigner import wigner_3j

FORCE_PASSES = 3
TRAIN_PASSES = 9


def _nnz(l1: int, l2: int, lo: int) -> int:
    return int(np.count_nonzero(np.abs(wigner_3j(l1, l2, lo)) > 1e-12))


def _linear(s) -> int:
    return sum(2 * s.irreps_in[i.i_in].mul * s.irreps_out[i.i_out].mul
               * s.irreps_out[i.i_out].ir.dim
               for i in s.instructions if i.i_in >= 0)


def _fctp(s) -> int:
    return sum(2 * s.irreps_in1[i.i_in1].mul * s.irreps_in2[i.i_in2].mul
               * s.irreps_out[i.i_out].mul * s.irreps_out[i.i_out].ir.dim
               for i in s.instructions)


def edge_flops(spec: Spec) -> int:
    """Work of one forward pass per live edge."""
    total = 0
    for b in spec.blocks:
        total += sum(2 * a * c for a, c in zip(b.radial[:-1], b.radial[1:]))
        for ins in b.tp.instructions:
            m1 = b.tp.irreps_in1[ins.i_in1]
            m2 = b.tp.irreps_in2[ins.i_in2]
            mo = b.tp.irreps_out[ins.i_out]
            nnz = _nnz(m1.ir.l, m2.ir.l, mo.ir.l)
            total += 2 * nnz + m1.mul * (2 * nnz + 2 * mo.ir.dim)
    return total


def node_flops(spec: Spec) -> int:
    """Work of one forward pass per node."""
    total = _linear(spec.embed) + _linear(spec.lin1) + _linear(spec.lin2)
    for b in spec.blocks:
        total += _linear(b.si1) + _linear(b.si2)
        if b.sc_kind == 'nequip':
            total += _fctp(b.sc)
        elif b.sc_kind == 'linear':
            total += _linear(b.sc)
        if b.kind == 'mace':
            pb = b.pb
            C = pb.num_features
            for mo in pb.irreps_out:
                for nu in range(1, pb.correlation + 1):
                    U = u_matrix(pb.coupling, mo.ir, nu)
                    total += 2 * U.size * C + 2 * U.shape[-1] * C \
                        * pb.num_elements
            total += _linear(b.si3)
        else:
            total += 3 * b.gate.irreps_out.dim
    return total


class FlopCounter:
    """Forward work of a configuration: ``forward(edges, nodes)``."""

    def __init__(self, cfg: Dict):
        spec = build_spec(cfg)
        self.per_edge = edge_flops(spec)
        self.per_node = node_flops(spec)

    def forward(self, edges: int, nodes: int) -> int:
        return self.per_edge * int(edges) + self.per_node * int(nodes)
