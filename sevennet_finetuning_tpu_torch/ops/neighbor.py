"""MD's neighbor rebuild on the card: the cell list of ``csrc/neighbor_cells.cu``.

``CellList`` holds one structure's geometry (its float64 cell, periodic
axes, atom count and cutoff + skin) and the kernel's work buffers, which
live as long as it does.  A rebuild is ``count`` (the wrapping, the
images' bins and each home atom's neighbor count, then one read of the
edge total), ``fill`` (the edges of atoms 0..n-1 into slots [0, total)
of the batch's buffers, grouped by ascending destination) and
``pack_edges`` (the collate layout past them).  A configuration with
``max_neighbors`` counts with ``cap`` (the same read also brings the
capped total), fills the candidates into buffers of their own and keeps
each destination's nearest (``nearest_edges``) before ``pack_edges``.
Its plain version is the
host core it follows, ``data.native.neighbor_list_native``: the same
algorithm, the same inputs, the same edges.

The geometry is the host core's: its inverse by cofactors in Python's
float64, the image repeats of ``data.neighborlist``.  The grid's bins are sized from the structure's positions when
the list is made; a grid that outgrows them (atoms drifting along a
non-periodic axis) is reported by the count pass, and ``count`` grows the
bins and counts again.
"""

from __future__ import annotations

import ctypes
import itertools
import math
from typing import Tuple

import numpy as np
import torch

from ..data.neighborlist import _max_repeats
from . import _cuda
from .scatter import sort_perm

# the kernel's buffers, in the order of neighbor_cells.cu's ``Buf``:
# (name, dtype, length from n atoms, n_img images, b bin capacity and
# p wrap blocks)
WRAP_THREADS = 256
BUFFERS = (
    ('wpos', torch.float64, lambda n, ni, b, p: 3 * n),
    ('wrap', torch.int32, lambda n, ni, b, p: 3 * n),
    ('part', torch.float64, lambda n, ni, b, p: 6 * p),
    ('grid_d', torch.float64, lambda n, ni, b, p: 3),
    ('grid_i', torch.int32, lambda n, ni, b, p: 4),
    ('bin_count', torch.int32, lambda n, ni, b, p: b),
    ('bin_start', torch.int32, lambda n, ni, b, p: b + 1),
    ('img_bin', torch.int32, lambda n, ni, b, p: ni),
    ('img_tmp', torch.int32, lambda n, ni, b, p: ni),
    ('img_id', torch.int32, lambda n, ni, b, p: ni),
    ('img_xyz', torch.float64, lambda n, ni, b, p: 3 * ni),
    ('atom_cnt', torch.int32, lambda n, ni, b, p: n),
    ('atom_off', torch.int32, lambda n, ni, b, p: n + 1),
    ('status', torch.int64, lambda n, ni, b, p: 2),
)
# spare bins when the grid outgrows them
BIN_GROWTH = 1.25


def _invert3(m: np.ndarray):
    """The host core's ``invert3``: the inverse by cofactors, or None for
    a degenerate cell."""
    a, b, c, d, e, f, g, h, i = (float(x) for x in m.reshape(-1))
    det = a * (e * i - f * h) - b * (d * i - f * g) + c * (d * h - e * g)
    if abs(det) < 1e-14:
        return None
    s = 1.0 / det
    return [(e * i - f * h) * s, (c * h - b * i) * s, (b * f - c * e) * s,
            (f * g - d * i) * s, (a * i - c * g) * s, (c * d - a * f) * s,
            (d * h - e * g) * s, (b * g - a * h) * s, (a * e - b * d) * s]


class CellList:
    """The card's neighbor list of ``n`` atoms in one cell at ``cutoff``
    (``pos``: the host positions that size the grid's bins)."""

    def __init__(self, cell, pbc, cutoff: float, pos: np.ndarray, device):
        cell = np.asarray(cell, np.float64).reshape(3, 3)
        self.pbc = tuple(bool(p) for p in (
            (pbc,) * 3 if isinstance(pbc, bool) else pbc))
        self.n = len(pos)
        if self.n == 0:
            raise ValueError('CellList needs at least one atom')
        inv = [1.0, 0.0, 0.0, 0.0, 1.0, 0.0, 0.0, 0.0, 1.0]
        if any(self.pbc):
            inv = _invert3(cell)
            if inv is None:
                raise ValueError('degenerate cell with periodic axes')
        self.cell = cell
        self.inv = np.array(inv).reshape(3, 3)
        self.reps = tuple(int(r) for r in _max_repeats(cell, self.pbc,
                                                       cutoff))
        self.n_img = self.n * math.prod(2 * r + 1 for r in self.reps)
        self.side = cutoff if cutoff > 1e-6 else 1.0
        self.device = torch.device(device)
        self.geom = (ctypes.c_double * 20)(
            *cell.reshape(-1), *inv, self.side, cutoff * cutoff)
        self.bins = self.bin_estimate(pos)
        self.bufs = {}
        self._alloc()

    def bin_estimate(self, pos: np.ndarray) -> int:
        """Bins of the grid over the images' box for atoms at ``pos``, two
        spare a side for rounding: the box's corners in fractional
        coordinates (the repeats along the periodic axes, the atoms'
        extent along the others) taken to Cartesian."""
        pos = np.asarray(pos, np.float64)
        if any(self.pbc):
            frac = pos @ self.inv
            lo, hi = frac.min(0), frac.max(0)
            for k in range(3):
                if self.pbc[k]:
                    lo[k], hi[k] = -self.reps[k], self.reps[k] + 1
            corners = np.array(list(itertools.product(*zip(lo, hi))))
            cart = corners @ self.cell
            extent = cart.max(0) - cart.min(0)
        else:
            extent = pos.max(0) - pos.min(0)
        return int(np.prod(np.floor(extent / self.side).astype(np.int64) + 3))

    def _alloc(self):
        """(Re)allocate the work buffers for the current bin capacity,
        keeping those that do not depend on it."""
        p = -(-self.n // WRAP_THREADS)
        for name, dtype, size in BUFFERS:
            want = size(self.n, self.n_img, self.bins, p)
            have = self.bufs.get(name)
            if have is None or have.numel() != want:
                self.bufs[name] = torch.empty(want, dtype=dtype,
                                              device=self.device)
        self.ptrs = _cuda.host_ptrs([self.bufs[name]
                                     for name, _, _ in BUFFERS])
        self.dims = _cuda.host_ints((self.n, self.n_img, self.bins,
                                     *map(int, self.pbc), *self.reps))

    def count(self, pos: torch.Tensor, cap=None) -> Tuple[int, int]:
        """The count pass over the first ``n`` rows of ``pos`` ([>= n, 3]
        float32 on the card), then the read of the edge total: (edges,
        reads), a second read where the grid outgrew its bins.  With
        ``cap``, edges counts at most ``cap`` an atom, read with the
        total, which ``candidates`` keeps."""
        _cuda.require(pos, 'pos', torch.float32)
        if pos.dim() != 2 or pos.shape[1] != 3 or pos.shape[0] < self.n:
            raise ValueError(f'pos: expected [>= {self.n}, 3], got '
                             f'{tuple(pos.shape)}')
        fn = _cuda.kernel('neighbor_count')
        reads = 0
        while True:
            _cuda.LAUNCHES['neighbor_count'] += 1
            _cuda.check('neighbor_count', fn(
                pos.data_ptr(), self.ptrs, self.geom, self.dims,
                _cuda.stream_ptr(pos.device)))
            status = self.bufs['status']
            if cap is not None:
                status = torch.cat([status, self.bufs['atom_cnt'].clamp(
                    max=cap).sum().view(1)])
            total, need, *capped = status.tolist()
            reads += 1
            if not need:
                if cap is None:
                    return int(total), reads
                self.candidates = int(total)
                return int(capped[0]), reads
            self.bins = int(need * BIN_GROWTH) + 1
            self._alloc()

    def fill(self, edge_idx: torch.Tensor, shift: torch.Tensor) -> None:
        """The fill pass after ``count``: edges into slots [0, total) of
        ``edge_idx`` [2, cap] int32 and ``shift`` [cap, 3] float32."""
        cap = edge_idx.shape[1]
        _cuda.require(edge_idx, 'edge_idx', torch.int32, (2, cap))
        _cuda.require(shift, 'shift', torch.float32, (cap, 3))
        fn = _cuda.kernel('neighbor_fill')
        _cuda.LAUNCHES['neighbor_fill'] += 1
        _cuda.check('neighbor_fill', fn(
            self.ptrs, self.geom, self.dims, edge_idx.data_ptr(),
            shift.data_ptr(), cap, _cuda.stream_ptr(edge_idx.device)))


def pack_edges(edge_idx: torch.Tensor, shift: torch.Tensor,
               mask: torch.Tensor, n_live: int, n_node: int):
    """Slots [n_live, cap) of a dst-sorted edge list as ``collate`` pads
    them (the sentinel ``(n_node, n_node)``, zero shift, mask 0; mask 1
    before them), in place, and (``EDGE_SRC_PERM``, its inverse): the
    stable sort of the sources, sentinels last, and the inverse by a
    scatter.  Plain torch on the tensors' device."""
    edge_idx[:, n_live:] = n_node
    shift[n_live:] = 0.0
    mask[:n_live] = 1.0
    mask[n_live:] = 0.0
    return sort_perm(edge_idx[1])


# the largest |shift| component the image key of ``nearest_edges`` orders
IMAGE_RANGE = 1024


def nearest_edges(cand_idx: torch.Tensor, cand_shift: torch.Tensor,
                  pos: torch.Tensor, cell: torch.Tensor, counts: torch.Tensor,
                  offsets: torch.Tensor, k: int, edge_idx: torch.Tensor,
                  shift: torch.Tensor, n_live: int) -> None:
    """Each destination's ``k`` nearest of the candidates (grouped by
    ascending destination, atom a's at ``offsets[a]``, ``counts[a]`` of
    them), ordered by (destination, distance, source, image), into slots
    [0, n_live) of ``edge_idx`` / ``shift`` (``n_live`` = sum min(counts,
    k)); the rest go to slot ``n_live``, which ``pack_edges`` overwrites.
    The distance is the squared length in float64 of pos[j] - pos[i] +
    shift . cell from the float32 positions (the model's) and the float64
    cell; images order by the shift, lexicographically.  Three stable
    sorts on the tensors' device, no read (the host build runs it too)."""
    w = 2 * IMAGE_RANGE + 1
    img = (cand_shift.long() + IMAGE_RANGE)
    tie = (cand_idx[1].long() * w + img[:, 0]) * w * w \
        + img[:, 1] * w + img[:, 2]
    dst, src = cand_idx[0].long(), cand_idx[1].long()
    p, s = pos.double(), cand_shift.double()
    v = p[src] - p[dst] + (s[:, 0:1] * cell[0] + s[:, 1:2] * cell[1]
                           + s[:, 2:3] * cell[2])
    d2 = (v[:, 0] * v[:, 0] + v[:, 1] * v[:, 1]) + v[:, 2] * v[:, 2]
    order = torch.sort(tie, stable=True).indices
    order = order[torch.sort(d2[order], stable=True).indices]
    order = order[torch.sort(dst[order], stable=True).indices]
    dst = dst[order]
    rank = torch.arange(order.shape[0], device=order.device) \
        - offsets.long()[dst]
    kept = counts.clamp(max=k).long()
    start = torch.cumsum(kept, 0) - kept
    slot = torch.where(rank < k, start[dst] + rank,
                       torch.full_like(rank, n_live))
    edge_idx[:, slot] = cand_idx[:, order]
    shift[slot] = cand_shift[order]
