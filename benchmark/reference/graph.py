"""The reference's own graph build: every periodic image pair within the
cutoff, found by brute force on the device over the lattice translations
that can reach it, in blocks of rows.

An edge (i <- j, shift) carries pos[j] + shift - pos[i]; a structure's
edges are those with 0 < |r| < cutoff.  ``batch_graphs`` concatenates
structures into one graph with per-atom graph ids.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence

import numpy as np
import torch


def _images(cell: np.ndarray, cutoff: float, pbc) -> np.ndarray:
    """Integer translations n with any point of the cell within cutoff of
    a point of the cell after n: |n_k| <= ceil(cutoff / height_k)."""
    vol = abs(np.linalg.det(cell))
    reps = []
    for k in range(3):
        if not pbc[k]:
            reps.append(0)
            continue
        a, b = cell[(k + 1) % 3], cell[(k + 2) % 3]
        height = vol / np.linalg.norm(np.cross(a, b))
        reps.append(int(math.ceil(cutoff / height)))
    grid = np.stack(np.meshgrid(*[np.arange(-r, r + 1) for r in reps],
                                indexing='ij'), -1).reshape(-1, 3)
    return grid.astype(np.float64)


def neighbor_edges(pos: np.ndarray, cell: np.ndarray, pbc, cutoff: float,
                   device):
    """(dst, src, shift [E, 3] cartesian) of every pair within ``cutoff``,
    sorted by (dst, src, shift).  Positions are wrapped into the cell
    first (the translation is added back to the shift), so the image
    search covers every pair whatever the atoms' drift."""
    pos = np.asarray(pos, np.float64)
    cell = np.asarray(cell, np.float64)
    frac = np.linalg.solve(cell.T, pos.T).T
    wrap = np.where(np.asarray(pbc, bool)[None, :], np.floor(frac), 0.0)
    p = torch.as_tensor(pos - wrap @ cell, device=device)
    imgs = _images(cell, cutoff, pbc)
    trans = torch.as_tensor(imgs @ cell, device=device)       # [T, 3]
    n = p.shape[0]
    c2 = cutoff * cutoff
    # rows a block: some 2e7 candidate pairs at a time
    block = max(1, int(2e7 // (len(imgs) * n)))
    dsts, srcs, tids = [], [], []
    for lo in range(0, n, block):
        pi = p[lo:lo + block]                                   # [b, 3]
        # r[b, T, n] = p[j] + t - p[i]
        r = (p[None, None, :, :] + trans[None, :, None, :]
             - pi[:, None, None, :])
        d2 = (r * r).sum(-1)
        hit = (d2 < c2) & (d2 > 1e-16)
        i, t, j = torch.nonzero(hit, as_tuple=True)
        dsts.append(i + lo)
        tids.append(t)
        srcs.append(j)
    dst = torch.cat(dsts)
    src = torch.cat(srcs)
    tid = torch.cat(tids)
    # r = p_w[j] + t - p_w[i] with p_w = pos - W: pos[j] - pos[i] + (t -
    # W[j] + W[i])
    wrap_t = torch.as_tensor(wrap @ cell, device=device)
    shift = trans[tid] - wrap_t[src] + wrap_t[dst]
    return dst, src, shift


def batch_graphs(structures: Sequence[Dict], cutoff: float,
                 type_map: Dict[int, int], device,
                 dtype=torch.float32) -> Dict[str, torch.Tensor]:
    """Structures ({'numbers', 'pos', 'cell', 'pbc'}) as one graph:
    ``pos`` [N, 3], ``types``, ``batch``, ``src``, ``dst``, ``shift``
    [E, 3], ``volume`` and ``n_graph``."""
    pos, types, batch, src, dst, shift, vol = [], [], [], [], [], [], []
    off = 0
    for b, s in enumerate(structures):
        d, j, sh = neighbor_edges(s['pos'], s['cell'], s['pbc'], cutoff,
                                  device)
        n = len(s['numbers'])
        pos.append(torch.as_tensor(np.asarray(s['pos'], np.float64),
                                   device=device))
        types.append(torch.as_tensor([type_map[int(z)] for z in s['numbers']],
                                     device=device))
        batch.append(torch.full((n,), b, device=device, dtype=torch.long))
        dst.append(d + off)
        src.append(j + off)
        shift.append(sh)
        vol.append(abs(float(np.linalg.det(np.asarray(s['cell'])))))
        off += n
    return {'pos': torch.cat(pos).to(dtype), 'types': torch.cat(types),
            'batch': torch.cat(batch), 'src': torch.cat(src),
            'dst': torch.cat(dst), 'shift': torch.cat(shift).to(dtype),
            'volume': torch.tensor(vol, dtype=dtype, device=device),
            'n_graph': len(structures)}


def edge_counts(structures: Sequence[Dict], cutoff: float,
                device) -> List[int]:
    """Edges within ``cutoff`` of each structure."""
    return [int(neighbor_edges(s['pos'], s['cell'], s['pbc'], cutoff,
                               device)[0].shape[0]) for s in structures]
