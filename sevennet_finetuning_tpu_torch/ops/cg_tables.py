"""Host-built term tables that drive the cg_node CUDA kernels.

Every output column of the fused convolution is a short sum of
triple products of staged row entries,

    out[col] = sum_t  coef_t * row[a_t] * row[b_t] * row[c_t],

where ``row`` is one edge's legs concatenated in shared memory.  The
tables are built once per ``CGLayout`` from its nonzero Wigner-3j terms
(``CGPath.nnz``) and stored as CSR: ``start[col]..start[col + 1]`` index
``terms``, an int32 ``[T, 4]`` array of ``(a, b, c, float bits of coef)``.

- agg: row = [x | sh | w]; one CSR row per msg column (stride layout).
- multi: row = [g | x | sh | w] with g = ybar[dst[e]]; outputs are the
  requested jobs' columns concatenated in job order.  The xn and wn
  columns are one work item each.  An shn column sums every term of its
  filter component (hundreds to thousands), so its terms are cut into
  chunks of at most ``SH_CHUNK``; each chunk is one item writing a
  partial sum, and a second pass adds a column's partials in order --
  a fixed-order reduction, so results do not vary from run to run.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Dict, List, Tuple

import numpy as np
import torch

from .fused_conv import CGLayout

SH_CHUNK = 64

_JOB_DIM = {'xn': 'dim_x', 'shn': 'dim_sh', 'wn': 'dim_w'}


def _pack(terms: List[List[Tuple[int, int, int, float]]]):
    """Per-column term lists -> (start [n+1] int32, terms [T, 4] int32)."""
    start = np.zeros(len(terms) + 1, np.int32)
    start[1:] = np.cumsum([len(t) for t in terms])
    flat = [t for col in terms for t in col]
    arr = np.zeros((max(len(flat), 1), 4), np.int32)
    if flat:
        abc = np.array([t[:3] for t in flat], np.int32)
        coef = np.array([t[3] for t in flat], np.float32)
        arr[:len(flat), :3] = abc
        arr[:len(flat), 3] = coef.view(np.int32)
    return start, arr


def _iter_terms(layout: CGLayout):
    """(grp, path, k, i, j, coef, u) for every nonzero scalar coupling."""
    for grp in layout.groups:
        for p in grp.paths:
            for (k, i, j, c) in p.nnz:
                for u in range(grp.mul):
                    yield grp, p, k, i, j, c, u


@functools.lru_cache(maxsize=None)
def agg_table(layout: CGLayout) -> Tuple[np.ndarray, np.ndarray]:
    """CSR over msg columns; row = [x | sh | w]."""
    X0, S0, W0 = 0, layout.dim_x, layout.dim_x + layout.dim_sh
    cols: List[list] = [[] for _ in range(layout.dim_msg)]
    for grp, p, k, i, j, c, u in _iter_terms(layout):
        cols[p.msg_off + k * grp.mul + u].append((
            X0 + grp.x_off + i * grp.mul + u,
            S0 + grp.sh_off + j,
            W0 + p.w_off + u,
            c,
        ))
    return _pack(cols)


@dataclass(frozen=True)
class MultiTable:
    item_start: np.ndarray   # [n_items + 1]
    item_out: np.ndarray     # [n_items]: >= 0 output column, < 0 partial
    terms: np.ndarray        # [T, 4]
    red_start: np.ndarray    # [n_red + 1] into the partials
    red_out: np.ndarray      # [n_red] output column of each reduction
    n_part: int
    out_dims: Tuple[int, ...]


@functools.lru_cache(maxsize=None)
def multi_table(layout: CGLayout, jobs: Tuple[str, ...]) -> MultiTable:
    """Work items for the requested backward jobs; row = [g | x | sh | w]."""
    G0 = 0
    X0 = layout.dim_msg
    S0 = X0 + layout.dim_x
    W0 = S0 + layout.dim_sh
    per_job: Dict[str, List[list]] = {
        j: [[] for _ in range(getattr(layout, _JOB_DIM[j]))] for j in jobs}
    for grp, p, k, i, j, c, u in _iter_terms(layout):
        xa = X0 + grp.x_off + i * grp.mul + u
        sa = S0 + grp.sh_off + j
        ga = G0 + p.msg_off + k * grp.mul + u
        wa = W0 + p.w_off + u
        if 'xn' in per_job:
            per_job['xn'][grp.x_off + i * grp.mul + u].append(
                (sa, ga, wa, c))
        if 'shn' in per_job:
            per_job['shn'][grp.sh_off + j].append((xa, ga, wa, c))
        if 'wn' in per_job:
            per_job['wn'][p.w_off + u].append((xa, sa, ga, c))

    items: List[list] = []
    item_out: List[int] = []
    red_start = [0]
    red_out: List[int] = []
    n_part = 0
    base = 0
    for job in jobs:
        for col, terms in enumerate(per_job[job]):
            if job != 'shn':
                items.append(terms)
                item_out.append(base + col)
                continue
            for s in range(0, len(terms), SH_CHUNK):
                items.append(terms[s:s + SH_CHUNK])
                item_out.append(-(n_part + 1))
                n_part += 1
            red_start.append(n_part)
            red_out.append(base + col)
        base += len(per_job[job])
    item_start, packed = _pack(items)
    return MultiTable(
        item_start=item_start,
        item_out=np.asarray(item_out, np.int32),
        terms=packed,
        red_start=np.asarray(red_start, np.int32),
        red_out=np.asarray(red_out if red_out else [0], np.int32),
        n_part=n_part,
        out_dims=tuple(getattr(layout, _JOB_DIM[j]) for j in jobs),
    )


_DEVICE_CACHE: Dict[tuple, tuple] = {}


def on_device(key, arrays, device: torch.device):
    """Device copies of host tables, cached per (key, device)."""
    ck = (key, str(device))
    if ck not in _DEVICE_CACHE:
        _DEVICE_CACHE[ck] = tuple(
            torch.as_tensor(a).to(device) for a in arrays)
    return _DEVICE_CACHE[ck]
