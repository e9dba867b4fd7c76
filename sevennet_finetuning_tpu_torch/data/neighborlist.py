"""Periodic-boundary neighbor lists (host-side numpy + scipy).

Copy of ``sevennet_finetuning_tpu/data/neighborlist.py``: full
(both-direction) edge lists within a cutoff, with integer cell-shift
vectors, excluding only the trivial self-edge at zero shift.  The native
C++ cell-list core (``data/native.py``) builds them unless
``SEVENN_NO_NATIVE`` is set; otherwise replicate atoms into every lattice
image that can fall within the cutoff of the home cell, then query a
cKDTree of the images against the home positions.  The two builders
find the same edges but order them differently (within an i, the native
core goes bin by bin), so a comparison of graphs edge by edge uses the
same builder on both sides.
"""

from __future__ import annotations

import itertools
import os
from typing import Tuple

import numpy as np
from scipy.spatial import cKDTree


def _max_repeats(cell: np.ndarray, pbc, cutoff: float) -> np.ndarray:
    """Images needed per axis so every point within cutoff is covered."""
    reps = np.zeros(3, dtype=np.int64)
    vol = abs(np.linalg.det(cell))
    if vol < 1e-12:
        return reps
    for i in range(3):
        if not pbc[i]:
            continue
        j, k = (i + 1) % 3, (i + 2) % 3
        # perpendicular height of axis i over the plane of (j, k)
        h = vol / np.linalg.norm(np.cross(cell[j], cell[k]))
        reps[i] = int(np.ceil(cutoff / h))
    return reps


def neighbor_list(
    pos: np.ndarray,
    cell: np.ndarray,
    pbc,
    cutoff: float,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Returns (idx_i, idx_j, shift, edge_vec) with
    edge_vec = pos[j] + shift . cell - pos[i], |edge_vec| < cutoff.

    Both (i, j, S) and (j, i, -S) are present; (i, i, 0) is excluded.
    Uses the native C++ cell-list core when available (set
    SEVENN_NO_NATIVE=1 to force the pure-Python path).
    """
    if not os.environ.get('SEVENN_NO_NATIVE'):
        from .native import neighbor_list_native

        out = neighbor_list_native(pos, cell, pbc, cutoff)
        if out is not None:
            return out
    pos = np.asarray(pos, dtype=np.float64)
    cell = np.asarray(cell, dtype=np.float64).reshape(3, 3)
    if isinstance(pbc, bool):
        pbc = (pbc, pbc, pbc)
    n = len(pos)
    if n == 0:
        z = np.zeros(0, dtype=np.int64)
        return z, z, np.zeros((0, 3)), np.zeros((0, 3))

    # wrap positions into the home cell along periodic axes so the image
    # bound below is valid for arbitrary input coordinates; the integer
    # wrap offsets are folded back into the reported shifts
    wrap = np.zeros((n, 3), dtype=np.float64)
    if any(pbc) and abs(np.linalg.det(cell)) > 1e-12:
        frac = pos @ np.linalg.inv(cell)
        for ax in range(3):
            if pbc[ax]:
                wrap[:, ax] = np.floor(frac[:, ax])
        pos = pos - wrap @ cell

    reps = _max_repeats(cell, pbc, cutoff)
    shift_ranges = [
        range(-int(r), int(r) + 1) if pbc[i] else range(0, 1)
        for i, r in enumerate(reps)
    ]
    shifts = np.array(list(itertools.product(*shift_ranges)), dtype=np.float64)
    # images: [n_shift, n, 3]
    images = pos[None, :, :] + (shifts @ cell)[:, None, :]
    flat = images.reshape(-1, 3)

    tree = cKDTree(flat)
    pairs = tree.query_ball_point(pos, r=cutoff)

    idx_i, idx_j, out_shift, out_vec = [], [], [], []
    for i, lst in enumerate(pairs):
        if not lst:
            continue
        arr = np.asarray(lst, dtype=np.int64)
        s_idx = arr // n
        j_idx = arr % n
        vec = flat[arr] - pos[i]
        d2 = np.einsum('ij,ij->i', vec, vec)
        keep = d2 > 1e-16  # drop the trivial self edge (i, i, 0)
        keep &= d2 < cutoff * cutoff
        if not np.any(keep):
            continue
        jk = j_idx[keep]
        idx_i.append(np.full(keep.sum(), i, dtype=np.int64))
        idx_j.append(jk)
        # shift in terms of the caller's raw coordinates
        out_shift.append(shifts[s_idx[keep]] - wrap[jk] + wrap[i])
        out_vec.append(vec[keep])
    if not idx_i:
        z = np.zeros(0, dtype=np.int64)
        return z, z, np.zeros((0, 3)), np.zeros((0, 3))
    return (
        np.concatenate(idx_i),
        np.concatenate(idx_j),
        np.concatenate(out_shift),
        np.concatenate(out_vec),
    )
