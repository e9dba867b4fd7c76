"""The 'gaunt' family's work and the Gaunt stage's byte floor, counted from
the configuration and the live edge and node counts, whatever implements
them.

FLOPs of one forward pass (a multiply-add 2; a force evaluation 3 passes,
``flops.FORCE_PASSES``), with the Gaunt products counted as their dense
couplings: G[i, j, k] = (1 / 4 pi) int Y_i Y_j Y_k over the real
harmonics, nnz(G) its entries that are not zero (``reference/gaunt``'s
quadrature).

- per live edge: the radial MLP (2 h_in h_out a layer); a CG layer's 'uvu'
  paths as ``flops.edge_flops`` counts them; a Gaunt layer's product
  (l <= L_x) x (l <= L_f) -> (l <= L_out): 2 nnz(G) for the harmonics
  against G, then mul (2 nnz(G) + 2 d_out) for the channel contraction,
  the per-edge weight and the sum into the destination;
- per node: the embedding, the self-connection and both linears of each
  layer, the readout (2 mul_in mul_out d a path); the self-product basis a
  channel: 2 (L_x + 1)^2 for each order's weighting, 2 nnz(G) for the
  product (l <= L_x) x (l <= L_x) -> (l <= 2 L_x) and for (l <= 2 L_x) x
  (l <= L_x) -> (l <= L_out), and 2 d_out for the sums and the path
  weights.

The byte floor of the Gaunt stage (the ``gaunt.conv`` and ``gaunt.pb``
spans of the program, forward and the force backward), float32, what any
implementation must move at the live sizes:

- a Gaunt convolution's forward reads, per live edge, the gathered source
  features (mul (L_x + 1)^2), the harmonics ((L_f + 1)^2) and the radial
  weights (mul (L_out + 1)), and writes the messages summed at their
  destinations (mul (L_out + 1)^2 a node); its backward reads the
  messages' cotangent gathered by destination and the three inputs again,
  and writes the cotangents of the features (summed at their sources), the
  harmonics and the weights;
- a product basis reads its node features and weights and writes its
  output; its backward reads the output's cotangent and the features and
  writes their cotangent.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Dict

import numpy as np

from ..reference import gaunt as rg
from .bounds import F32
from .flops import _linear, _nnz


@lru_cache(maxsize=None)
def gaunt_nnz(L1: int, L2: int, L3: int) -> int:
    """Entries of G (l <= L1) x (l <= L2) -> (l <= L3) that are not
    zero."""
    deg = L1 + L2 + L3
    A = rg._sh_at(L1, deg)
    B = rg._sh_at(L2, deg)
    _, w = rg.quadrature(deg)
    C = rg._sh_at(L3, deg) * (w / (4 * np.pi))[:, None]
    G = np.einsum('qi,qj,qk->ijk', A, B, C)
    return int(np.count_nonzero(np.abs(G) > 1e-10))


def _cg_edge(tp) -> int:
    total = 0
    for ins in tp.instructions:
        m1 = tp.irreps_in1[ins.i_in1]
        m2 = tp.irreps_in2[ins.i_in2]
        mo = tp.irreps_out[ins.i_out]
        nnz = _nnz(m1.ir.l, m2.ir.l, mo.ir.l)
        total += 2 * nnz + m1.mul * (2 * nnz + 2 * mo.ir.dim)
    return total


class GauntWork:
    """Per-edge and per-node FLOPs of a forward pass and the Gaunt stage's
    byte floor of a force evaluation, for a 'gaunt' configuration."""

    def __init__(self, cfg: Dict):
        spec = rg.build_spec(cfg)
        L_f = spec.lmax_edge
        self.per_edge = 0
        self.per_node = _linear(spec.embed) + _linear(spec.lin1) \
            + _linear(spec.lin2)
        # the stage's byte floor: [forward, backward] per edge and node
        self.floor_edge = [0, 0]
        self.floor_node = [0, 0]
        for b in spec.blocks:
            mul, Lo = b.mul, b.irreps_mid.lmax
            self.per_edge += sum(2 * a * c for a, c
                                 in zip(b.radial[:-1], b.radial[1:]))
            self.per_node += _linear(b.sc) + _linear(b.si1) + _linear(b.si2)
            if b.cg:
                self.per_edge += _cg_edge(b.tp)
            else:
                Lx = b.irreps_x.lmax
                d_x, d_f, d_o = (Lx + 1) ** 2, (L_f + 1) ** 2, (Lo + 1) ** 2
                nnz = gaunt_nnz(Lx, L_f, Lo)
                self.per_edge += 2 * nnz + mul * (2 * nnz + 2 * d_o)
                ins = mul * d_x + d_f + mul * (Lo + 1)
                # forward: the inputs, then the node sums; backward: the
                # cotangent by destination, the inputs, their cotangents
                self.floor_edge[0] += F32 * ins
                self.floor_node[0] += F32 * mul * d_o
                self.floor_edge[1] += F32 * (mul * d_o + 2 * ins)
                self.floor_node[1] += F32 * mul * d_x
            Lx, Lb = b.irreps_mid.lmax, b.irreps_out.lmax
            d_x, d_b = (Lx + 1) ** 2, (Lb + 1) ** 2
            nu = b.correlation
            pb = nu * 2 * d_x + 2 * d_b
            for k in range(1, nu):
                pb += 2 * gaunt_nnz(k * Lx, Lx,
                                    (k + 1) * Lx if k < nu - 1 else Lb)
            self.per_node += mul * pb
            self.floor_node[0] += F32 * mul * (d_x + d_b)
            self.floor_node[1] += F32 * mul * (d_b + 2 * d_x)

    def forward(self, edges: int, nodes: int) -> int:
        return self.per_edge * int(edges) + self.per_node * int(nodes)

    def stage_bytes(self, edges: int, nodes: int, part: int) -> int:
        """The Gaunt stage's byte floor of one force evaluation's forward
        (``part`` 0) or backward (1)."""
        return (self.floor_edge[part] * int(edges)
                + self.floor_node[part] * int(nodes))
