"""The 'equiformer_v2' family's work: the FLOPs and the byte floor of each
part of a force evaluation, counted from the configuration and the live
edge and node counts, whatever implements them.

A multiply-add is 2 FLOPs.  ``force_flops``, which ``mfu.eqv2`` reads, is
the repo's convention for every family: a force evaluation is
``flops.FORCE_PASSES`` (3) forward passes, so the share compares with
``mfu.serve`` and ``mfu.gaunt``.  The floor of ``eqv2_roofline`` counts
the work any implementation must do instead: the forward and the
backward to the edge vectors with the weights fixed, where a map by a
fixed matrix costs its forward again (the input's cotangent; no weight
gradient) and a product of two operands that both depend on the
positions twice (the rotation by D: D's cotangent and the features'), so
about two forwards (1,152 atoms, 23,040 edges: 2.31 TFLOP forward, 2.33
backward; 6.93 TFLOP a force evaluation by the convention).

Parts, each edge of each block (K = the kept coefficients, |m| <= mmax;
rotation cost: the block-diagonal D, sum_l min(2l + 1, K_l) (2l + 1) a
channel):

- ``radial``: the radial MLP, n_rad -> E -> E -> (sum of the orders'
  degrees) 2C, from the scalars it reads to the weights it writes;
- ``rotate``: D x of the source's and target's coefficients (2C channels)
  and D^T back of the messages (heads x value channels);
- ``so2``: both SO(2) convolutions (m = 0 with the extra scalars, each m > 0
  as the 2 x 2 complex form of two real maps);
- ``s2act``: to the grid and back, 64 channels (no grid in memory);
- ``softmax``: the alpha LayerNorm, SmoothLeakyReLU and dot, the softmax
  and the heads' product (a few FLOPs an element, memory bound);
- per node and block ``node``: both norms, the SO(3) linears (the
  projection and the FFN's two), the scalar MLP, the FFN's grid
  projections and its three grid linears;
- once: the edge-degree embedding (its radial MLP and D^T of the m = 0
  rows), the final norm and the head's FFN.

A part's floor is max(FLOPs / 67 TFLOP/s, bytes / 3.35 TB/s) with its
float32 inputs and outputs; ``floor_seconds`` sums the parts.
"""

from __future__ import annotations

from typing import Dict, Tuple

from ..reference.equiformer_v2 import Spec
from .bounds import F32, FP32_FLOP_PER_S, HBM_BYTES_PER_S
from .flops import FORCE_PASSES


def _rot(sp: Spec) -> int:
    """Multiply-adds of D (or D^T) on one channel, block diagonal."""
    return sum(sum(1 for l2, m in sp.lm if l2 == l) * (2 * l + 1)
               for l in range(sp.lmax + 1))


class EqV2Work:
    """FLOPs and bytes of each part, [forward, backward], per live edge,
    per node and per request."""

    def __init__(self, cfg: Dict):
        sp = Spec(cfg)
        self.sp = sp
        c, E, hid = sp.c, sp.edge, sp.hid
        K, d = len(sp.lm), (sp.lmax + 1) ** 2
        L = sp.layers
        n_m = [sp.lmax + 1 - m for m in range(sp.mmax + 1)]
        v = sp.heads * sp.value
        extra = sp.heads * sp.alpha + hid
        n_rad = sp.gauss + 2 * E
        P = sp.res * sp.res
        rot = _rot(sp)
        # (multiply-adds forward, backward factor, bytes forward)
        edge: Dict[str, Tuple[int, float, int]] = {}
        rad_out = sum(n_m) * 2 * c
        edge['radial'] = (L * (n_rad * E + E * E + E * rad_out), 1.0,
                          L * F32 * (n_rad + rad_out))
        edge['rotate'] = (L * rot * (2 * c + v), 2.0,
                          L * F32 * (d * 2 * c + K * 2 * c + K * v + rot))
        so2 = n_m[0] * 2 * c * (extra + n_m[0] * hid) \
            + n_m[0] * hid * n_m[0] * v
        for m in range(1, sp.mmax + 1):
            so2 += 2 * (n_m[m] * 2 * c) * (2 * n_m[m] * hid) \
                + 2 * (n_m[m] * hid) * (2 * n_m[m] * v)
        edge['so2'] = (L * so2, 1.0, L * F32 * (K * 2 * c + rad_out
                                                 + K * hid + extra
                                                 + K * hid + K * v))
        edge['s2act'] = (L * 2 * P * K * hid, 1.0, L * F32 * 2 * K * hid)
        edge['softmax'] = (L * (4 * sp.heads * sp.alpha + K * v), 1.0,
                           L * F32 * (extra + 2 * K * v))
        m0 = n_m[0] * c
        edge['degree'] = (n_rad * E + E * E + E * m0
                          + sum(2 * l + 1 for l in range(sp.lmax + 1)) * c,
                          1.0, F32 * (n_rad + m0 + d * c))
        h = sp.ffn
        ffn = d * c * h + c * h + 2 * P * d * h + 3 * P * h * h + d * h * c
        node = L * (d * v * c + ffn + 2 * 3 * d * c)
        node_bytes = L * F32 * (2 * d * c + 2 * d * c + 3 * d * c)
        head = ffn - d * h * c + d * h + 3 * d * c
        self.edge, self.node = edge, {
            'node': (node, 1.0, node_bytes),
            'head': (head, 1.0, F32 * 2 * d * c)}

    def parts(self, edges: int, nodes: int, part: int
              ) -> Dict[str, Tuple[float, float]]:
        """{part: (FLOPs, bytes)} of the forward (``part`` 0) or the
        backward (1) of one force evaluation."""
        out = {}
        for table, n in ((self.edge, edges), (self.node, nodes)):
            for k, (mac, back, by) in table.items():
                f = 2.0 * mac * n * (back if part else 1.0)
                b = by * n * (2.0 if part else 1.0)
                out[k] = (f, b)
        return out

    def force_flops(self, edges: int, nodes: int) -> float:
        """A force evaluation by the convention: ``FORCE_PASSES``
        forwards."""
        return FORCE_PASSES * sum(
            f for f, _ in self.parts(edges, nodes, 0).values())

    def floor_seconds(self, edges: int, nodes: int, part: int) -> float:
        return sum(max(f / FP32_FLOP_PER_S, b / HBM_BYTES_PER_S)
                   for f, b in self.parts(edges, nodes, part).values())
