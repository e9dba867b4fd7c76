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
- gagg (the double backward's ybar cotangent, a sum of agg terms):
  row = [pool_0 | pool_1 | ...]; a CSR over (msg column, agg term), so
  the kernel keeps one sum per term and adds them left to right.
- gmulti (every edge-side cotangent of the double backward): row =
  [g | pool_0 | pool_1 | ...]; jobs (emit mode, two pool legs, group)
  write grouped outputs.  An xn or wn item of a group is a list of
  segments, one per job in job order, each summed on its own and then
  added; shn columns are chunked as in multi, job after job.
- quad (the per-edge modes, no aggregation): row = the mode's three
  legs in ``_MODE_LEGS`` order.  'msg' is agg's table, one item per msg
  column; 'x', 'sh' and 'w' are multi's single xn / shn / wn job with its
  row [g | x | sh | w] mapped onto the mode's row (g is the per-edge
  cotangent itself, no ybar[dst] gather).
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Dict, List, Tuple

import numpy as np
import torch

from .fused_conv import _MODE_LEGS, CGLayout

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


_QUAD_JOB = {'x': 'xn', 'sh': 'shn', 'w': 'wn'}


@functools.lru_cache(maxsize=None)
def quad_table(layout: CGLayout, mode: str) -> MultiTable:
    """Work items of one per-edge mode; row = the mode's legs in
    ``_MODE_LEGS[mode]`` order, outputs the mode's [E, dim] columns."""
    if mode == 'msg':
        start, terms = agg_table(layout)
        return MultiTable(
            item_start=start,
            item_out=np.arange(layout.dim_msg, dtype=np.int32),
            terms=terms, red_start=np.zeros(1, np.int32),
            red_out=np.zeros(1, np.int32), n_part=0,
            out_dims=(layout.dim_msg,))
    tab = multi_table(layout, (_QUAD_JOB[mode],))
    dims = layout.mode_dims
    # multi's row offsets -> the mode's row offsets (-1: a leg it lacks)
    remap = np.full(sum(dims.values()), -1, np.int64)
    old = dict(zip(('g', 'x', 'sh', 'w'),
                   np.cumsum([0] + [dims[k] for k in ('g', 'x', 'sh')])))
    pos = 0
    for leg in _MODE_LEGS[mode]:
        remap[old[leg]:old[leg] + dims[leg]] = np.arange(pos,
                                                         pos + dims[leg])
        pos += dims[leg]
    terms = tab.terms.copy()
    n = int(tab.item_start[-1])
    terms[:n, :3] = remap[tab.terms[:n, :3]]
    if (terms[:n, :3] < 0).any():
        raise AssertionError(f'quad {mode}: a term reads a leg the mode '
                             'does not take')
    return MultiTable(
        item_start=tab.item_start, item_out=tab.item_out, terms=terms,
        red_start=tab.red_start, red_out=tab.red_out, n_part=tab.n_part,
        out_dims=tab.out_dims)


def _pool_offsets(pool_dims: Tuple[int, ...], base: int = 0):
    offs = [base]
    for d in pool_dims[:-1]:
        offs.append(offs[-1] + d)
    return offs


@functools.lru_cache(maxsize=None)
def gagg_table(layout: CGLayout, terms: Tuple[Tuple[int, int, int], ...],
               pool_dims: Tuple[int, ...]) -> Tuple[np.ndarray, np.ndarray]:
    """CSR over (msg column, agg term): ``start[col * n_terms + t]`` ..
    ``start[col * n_terms + t + 1]`` are term t's entries of column col,
    indexing row = [pool_0 | pool_1 | ...]; ``terms`` are (x, sh, w) pool
    indices."""
    start, entries = agg_table(layout)
    P = _pool_offsets(pool_dims)
    S0 = layout.dim_x
    W0 = layout.dim_x + layout.dim_sh
    cols: List[list] = []
    for col in range(layout.dim_msg):
        ents = entries[start[col]:start[col + 1]]
        coef = ents[:, 3].copy().view(np.float32)
        for (xi, si, wi) in terms:
            cols.append([
                (P[xi] + int(a), P[si] + int(b) - S0, P[wi] + int(c) - W0,
                 float(cf))
                for (a, b, c, _), cf in zip(ents, coef)])
    return _pack(cols)


@dataclass(frozen=True)
class GMultiTable:
    item_seg: np.ndarray     # [n_items + 1] into the segments
    seg_start: np.ndarray    # [n_seg + 1] into the terms
    item_out: np.ndarray     # [n_items]: >= 0 output column, < 0 partial
    terms: np.ndarray        # [T, 4]
    red_start: np.ndarray    # [n_red + 1] into the partials
    red_out: np.ndarray      # [n_red] output column of each reduction
    n_part: int
    out_dims: Tuple[int, ...]


_EMIT_DIM = {'x': 'dim_x', 'sh': 'dim_sh', 'w': 'dim_w'}


@functools.lru_cache(maxsize=None)
def gmulti_table(layout: CGLayout, jobs: Tuple[Tuple[str, int, int, int], ...],
                 n_groups: int, pool_dims: Tuple[int, ...]) -> GMultiTable:
    """Work items for grouped jobs (emit mode, b pool index, c pool index,
    group index), row = [g | pool_0 | ...]; outputs are the groups'
    columns concatenated in group order."""
    P = _pool_offsets(pool_dims, base=layout.dim_msg)
    emit = [None] * n_groups
    per_job: List[List[list]] = []
    for (m, bi, ci, grp) in jobs:
        if emit[grp] not in (None, m):
            raise ValueError(f'group {grp} mixes emit modes {emit[grp]}, {m}')
        emit[grp] = m
        cols: List[list] = [[] for _ in range(getattr(layout, _EMIT_DIM[m]))]
        for g, p, k, i, j, c, u in _iter_terms(layout):
            ga = p.msg_off + k * g.mul + u
            xo = g.x_off + i * g.mul + u
            so = g.sh_off + j
            wo = p.w_off + u
            if m == 'x':
                cols[xo].append((P[bi] + so, ga, P[ci] + wo, c))
            elif m == 'sh':
                cols[so].append((P[bi] + xo, ga, P[ci] + wo, c))
            else:
                cols[wo].append((P[bi] + xo, P[ci] + so, ga, c))
        per_job.append(cols)
    if None in emit:
        raise ValueError('a group has no job')

    segs: List[list] = []
    item_seg = [0]
    item_out: List[int] = []
    red_start = [0]
    red_out: List[int] = []
    n_part = 0
    base = 0
    for grp, m in enumerate(emit):
        mine = [per_job[q] for q, job in enumerate(jobs) if job[3] == grp]
        dim = getattr(layout, _EMIT_DIM[m])
        for col in range(dim):
            if m != 'sh':
                segs.extend(cols[col] for cols in mine)
                item_seg.append(len(segs))
                item_out.append(base + col)
                continue
            for cols in mine:
                terms = cols[col]
                for s in range(0, len(terms), SH_CHUNK):
                    segs.append(terms[s:s + SH_CHUNK])
                    item_seg.append(len(segs))
                    item_out.append(-(n_part + 1))
                    n_part += 1
            red_start.append(n_part)
            red_out.append(base + col)
        base += dim
    seg_start, packed = _pack(segs)
    return GMultiTable(
        item_seg=np.asarray(item_seg, np.int32),
        seg_start=seg_start,
        item_out=np.asarray(item_out, np.int32),
        terms=packed,
        red_start=np.asarray(red_start, np.int32),
        red_out=np.asarray(red_out if red_out else [0], np.int32),
        n_part=n_part,
        out_dims=tuple(getattr(layout, _EMIT_DIM[m]) for m in emit),
    )


_DEVICE_CACHE: Dict[tuple, tuple] = {}


def on_device(key, arrays, device: torch.device):
    """Device copies of host tables, cached per (key, device)."""
    ck = (key, str(device))
    if ck not in _DEVICE_CACHE:
        _DEVICE_CACHE[ck] = tuple(
            torch.as_tensor(a).to(device) for a in arrays)
    return _DEVICE_CACHE[ck]
