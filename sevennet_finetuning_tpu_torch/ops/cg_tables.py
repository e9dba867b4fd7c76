"""Host-built term tables that drive the cg_node CUDA kernels.

Every output column of the fused convolution is a short sum of
triple products of staged row entries,

    out[col] = sum_t  coef_t * row[a_t] * row[b_t] * row[c_t],

where ``row`` is one edge's legs concatenated in shared memory.  The
tables are built once per ``CGLayout`` from its nonzero Wigner-3j terms
(``CGPath.nnz``) and stored as CSR: ``start[col]..start[col + 1]`` index
``terms``, an int32 ``[T, 4]`` array of ``(a, b, c, float bits of coef)``.

- agg: row = [x | sh | w]; one CSR row per msg column (stride layout);
  ``quad_table`` runs it as cg_quad.cu's msg mode.  cg_agg.cu is driven
  by ``agg_plan`` instead: the paths and couplings of gagg's plan as B
  entries (formed once per edge, shared by every channel) and (node,
  unit) items spread over a block's warps, with its shared memory
  ``agg_smem`` and its bulk-copy spans ``agg_span``.
- multi (cg_quad's x / sh / w modes): row = [g | x | sh | w] with
  g = ybar[dst[e]]; outputs are the requested jobs' columns concatenated
  in job order.  The xn and wn columns are one work item each.  An shn
  column sums every term of its filter component (hundreds to
  thousands), so its terms are cut into
  chunks of at most ``SH_CHUNK``; each chunk is one item writing a
  partial sum, and a second pass adds a column's partials in order --
  a fixed-order reduction, so results do not vary from run to run.
- gmulti (every edge-side cotangent of the double backward, and through
  it multi, the first-order edge cotangents) is not a term table:
  ``gmulti_plan`` lists each path's couplings (k, i, j, c) once, for
  every channel u and every job, and the kernel's threads are the
  channels (see ``GMultiPlan``); ``gmulti_passes`` lays the jobs (emit
  mode, two pool legs, group) into its slots.  ``multi_table`` no longer
  drives a kernel of its own: ``quad_table`` builds cg_quad's table from
  it.
- gagg (the double backward's ybar cotangent, a sum of agg terms over a
  pool of edge arrays) is driven by ``gagg_plan``: the same chunks,
  groups, paths and couplings, re-sorted so that a lane can form each
  output component k from its own segment (k, i) (see ``GAggPlan``).
- quad (the per-edge modes, no aggregation): row = the mode's three
  legs in ``_MODE_LEGS`` order.  'msg' is agg's table, one item per msg
  column; 'x', 'sh' and 'w' are multi's single xn / shn / wn job with its
  row [g | x | sh | w] mapped onto the mode's row (g is the per-edge
  cotangent itself, no ybar[dst] gather).
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

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


# --- gmulti: the path-level coupling list of csrc/cg_gmulti.cu ---

_EMIT_DIM = {'x': 'dim_x', 'sh': 'dim_sh', 'w': 'dim_w'}
GMULTI_MODES = ('x', 'sh', 'w')
GMULTI_SLOTS = 2          # jobs of one emit mode in one kernel pass
GMULTI_MAX_D = 7          # irrep dims the kernel is compiled for (l <= 3)
# phases of every chunk (a work unit: one slice and the tile's edges e
# with e % n_phase == phase), measured at SevenNet-0's blocks against 1-16
# (tools/gmulti_phases.py): chunks of one irrep dim (block 0's one scalar
# chunk) run fastest at 2 phases, chunks of several dims (blocks 1-4:
# 0e / 1 / 2, unequal costs) at one edge a unit, which spreads the costs
# evenly over a block's warps
GMULTI_PHASES_ONE_DIM = 2
WARP = 32


@dataclass(frozen=True)
class GMultiPlan:
    """A layout's couplings for csrc/cg_gmulti.cu, one entry per path
    coupling (k, i, j, c), shared by every job and every channel u.

    A chunk is one x irrep (its groups share d1 and mul); a lane of a
    warp is one channel u of it.  Channels run in slices of 32 (one warp
    each, ``n_slice`` in all), and a work unit (``descs``) is a slice and
    the edges e of a tile with e % n_phase == phase.  x columns no group
    reads form chunks without groups (zero cotangents)."""

    chunks: np.ndarray      # [n_chunk, 6] x_off, d1, mul, group begin, end,
                            #   id of the chunk's first slice
    groups: np.ndarray      # [n_group, 4] sh_off, d2, path begin, end
    paths: np.ndarray       # [n_path, 4] msg_off, w_off, pair begin, d_out
    pair_start: np.ndarray  # per path d1 * d2 + 1 coupling offsets, one
                            #   segment per (i, j), i-major
    couplings: np.ndarray   # [n_coup, 2] k * mul, float bits of c
    descs: np.ndarray       # [n_desc, 4] chunk, first channel, phase,
                            #   n_phase
    n_slice: int

    def packed(self) -> Tuple[np.ndarray, Tuple[int, ...]]:
        """(one int32 array of every section, meta): meta = (n_chunk,
        n_desc, n_slice, offsets of chunks, groups, paths, pair_start,
        couplings, descs, total length)."""
        flat, offs = [], []
        for a in (self.chunks, self.groups, self.paths, self.pair_start,
                  self.couplings, self.descs):
            if a is self.couplings and sum(map(len, flat)) % 2:
                flat.append(np.zeros(1, np.int32))   # 8-byte aligned
            offs.append(sum(map(len, flat)))
            flat.append(a.reshape(-1))
        flat = np.concatenate(flat).astype(np.int32)
        return flat, (len(self.chunks), len(self.descs), self.n_slice,
                      *offs, len(flat))


@functools.lru_cache(maxsize=None)
def _path_list(layout: CGLayout):
    """The layout's chunks, groups, paths, pair starts and couplings (the
    sections of ``GMultiPlan`` but its descs), and the x chunks as
    (x_off, d1, mul, groups) with chunks of no group between them."""
    by_x: Dict[int, list] = {}
    for grp in layout.groups:
        if max(grp.d1, grp.d2) > GMULTI_MAX_D:
            raise ValueError(f'cg_gmulti takes irreps of dim <= '
                             f'{GMULTI_MAX_D}, got {grp.d1} x {grp.d2}')
        by_x.setdefault(grp.x_off, []).append(grp)
    # x columns outside every group: chunks without groups
    spans = sorted((off, gs[0].d1, gs[0].mul, gs) for off, gs in by_x.items())
    full, pos = [], 0
    for off, d1, mul, gs in spans:
        if off > pos:
            full.append((pos, 1, off - pos, []))
        full.append((off, d1, mul, gs))
        pos = off + d1 * mul
    if pos < layout.dim_x:
        full.append((pos, 1, layout.dim_x - pos, []))

    chunks, groups, paths, pair_start, coups = [], [], [], [], []
    n_slice = 0
    w_cover = np.zeros(layout.dim_w, np.int64)
    for off, d1, mul, gs in full:
        chunks.append((off, d1, mul, len(groups), len(groups) + len(gs),
                       n_slice))
        n_slice += -(-mul // WARP)
        for grp in gs:
            groups.append((grp.sh_off, grp.d2, len(paths),
                           len(paths) + len(grp.paths)))
            for p in grp.paths:
                paths.append((p.msg_off, p.w_off, len(pair_start), p.d_out))
                w_cover[p.w_off:p.w_off + mul] += 1
                pairs: List[list] = [[] for _ in range(d1 * grp.d2)]
                for (k, i, j, c) in p.nnz:
                    pairs[i * grp.d2 + j].append((k * mul, c))
                for seg in pairs:
                    pair_start.append(len(coups))
                    coups.extend(seg)
                pair_start.append(len(coups))
    if not (w_cover == 1).all():
        raise ValueError('cg_gmulti: the paths do not cover every w column '
                         'exactly once')
    coup = np.zeros((max(len(coups), 1), 2), np.int32)
    if coups:
        coup[:len(coups), 0] = [c[0] for c in coups]
        coup[:len(coups), 1] = np.asarray([c[1] for c in coups],
                                          np.float32).view(np.int32)
    return (full, np.asarray(chunks, np.int32).reshape(-1, 6),
            np.asarray(groups, np.int32).reshape(-1, 4),
            np.asarray(paths, np.int32).reshape(-1, 4),
            np.asarray(pair_start, np.int32), coup, n_slice)


@functools.lru_cache(maxsize=None)
def gmulti_plan(layout: CGLayout, edges_per_block: int,
                n_phase: Optional[int] = None) -> GMultiPlan:
    """The layout's coupling list, its tiles of ``edges_per_block`` edges
    split into ``n_phase`` phases for every chunk (None: the measured
    rule, ``GMULTI_PHASES_ONE_DIM`` or one edge a work unit)."""
    full, chunks, groups, paths, pair_start, coup, n_slice = _path_list(
        layout)
    if n_phase is None:
        n_phase = (GMULTI_PHASES_ONE_DIM if len({f[1] for f in full}) == 1
                   else edges_per_block)
    if not 1 <= n_phase <= edges_per_block:
        raise ValueError(f'cg_gmulti: {n_phase} phases for tiles of '
                         f'{edges_per_block} edges')
    descs = [(q, sl * WARP, ph, n_phase)
             for q, (_, _, mul, _) in enumerate(full)
             for sl in range(-(-mul // WARP)) for ph in range(n_phase)]
    return GMultiPlan(
        chunks=chunks, groups=groups, paths=paths, pair_start=pair_start,
        couplings=coup, descs=np.asarray(descs, np.int32).reshape(-1, 4),
        n_slice=n_slice)


# the legs each emit mode's slot s reads, as (leg, leg slot) pairs
_SLOT_LEGS = {'x': lambda s: (('S', s), ('W', s)),
              'sh': lambda s: (('X', s), ('W', s)),
              'w': lambda s: (('X', s), ('S', 1 - s))}
PASS_LEN = 6 + 3 * GMULTI_SLOTS * 2


@functools.lru_cache(maxsize=None)
def gmulti_passes(jobs: Tuple[Tuple[str, int, int, int], ...],
                  n_groups: int) -> np.ndarray:
    """The kernel passes of grouped jobs (emit mode, b pool index, c pool
    index, group index): int32 [n_pass, PASS_LEN], the pool indices of
    the legs X0, X1, S0, S1, W0, W1, then (group, add) of slots 0 and 1
    of the x, sh and w modes; -1 where unused.

    Slot s of the x mode reads (S[s], W[s]), of sh (X[s], W[s]), of w
    (X[s], S[1 - s]): the pairing of CGNodeMulti.backward's six jobs,
    which fill one pass and load each leg once.  A job takes the first
    slot of its mode whose legs are unset or already its own; where none
    is, the pass closes and the next begins.  ``add`` is 1 where an
    earlier pass wrote the group, whose jobs the kernel then adds to it;
    two slots of one pass and group are added in slot order."""
    emit: List[str] = [None] * n_groups
    for (m, _, _, grp) in jobs:
        if m not in GMULTI_MODES:
            raise ValueError(f'gmulti emit mode {m}')
        if emit[grp] not in (None, m):
            raise ValueError(f'group {grp} mixes emit modes {emit[grp]}, {m}')
        emit[grp] = m
    if None in emit:
        raise ValueError('a group has no job')

    def fresh():
        return ({leg: [-1] * GMULTI_SLOTS for leg in 'XSW'},
                {m: [-1] * GMULTI_SLOTS for m in GMULTI_MODES})

    def place(cur, m, b, c, grp):
        legs, slots = cur
        for s in range(GMULTI_SLOTS):
            (lb, sb), (lc, sc) = _SLOT_LEGS[m](s)
            if (slots[m][s] < 0 and legs[lb][sb] in (-1, b)
                    and legs[lc][sc] in (-1, c)):
                legs[lb][sb], legs[lc][sc], slots[m][s] = b, c, grp
                return True
        return False

    opened = [fresh()]
    for (m, b, c, grp) in jobs:
        if not place(opened[-1], m, b, c, grp):
            opened.append(fresh())
            place(opened[-1], m, b, c, grp)
    out = np.full((len(opened), PASS_LEN), -1, np.int32)
    written: set = set()
    for q, (legs, slots) in enumerate(opened):
        out[q, :6] = legs['X'] + legs['S'] + legs['W']
        for mi, m in enumerate(GMULTI_MODES):
            for s, grp in enumerate(slots[m]):
                if grp >= 0:
                    col = 6 + (mi * GMULTI_SLOTS + s) * 2
                    out[q, col:col + 2] = (grp, int(grp in written))
        written.update(g for m in GMULTI_MODES for g in slots[m] if g >= 0)
    return out


def gmulti_out_dims(layout: CGLayout,
                    jobs: Tuple[Tuple[str, int, int, int], ...],
                    n_groups: int) -> Tuple[int, ...]:
    """Width of each group's output: its emit mode's leg."""
    emit = {grp: m for (m, _, _, grp) in jobs}
    return tuple(getattr(layout, _EMIT_DIM[emit[g]]) for g in range(n_groups))


def gmulti_term_count(layout: CGLayout, n_jobs: int) -> int:
    """Scalar couplings (one per path coupling and channel u) times jobs:
    the triple products the function sums per edge, which the kernel
    table's bound counts."""
    return n_jobs * sum(len(p.nnz) * g.mul for g in layout.groups
                        for p in g.paths)


# --- gagg: the same couplings, one output component k a lane segment ---

GAGG_UNIT = 12            # ints of a GAggPlan unit


@dataclass(frozen=True)
class GAggPlan:
    """The layout's couplings for csrc/cg_gagg.cu.  A unit is one path and
    one 32-channel slice of its x chunk (a warp per node and unit); a lane
    is a channel u.  A message component k of a path is
    w[u] * sum_i x[i, u] * B[k][i] with B[k][i] = sum c * sh[j] over the
    path's couplings (k, i, j, c), which does not depend on u: lane
    ``k * d1 + i`` (mod 32, in ``ceil(d1 * d3 / 32)`` halves) forms that
    segment's B from its own coupling list, in steps, and the warp
    exchanges the B values by shuffles."""

    units: np.ndarray       # [n_unit, GAGG_UNIT] x_off, d1, mul, first
                            #   channel, sh_off, d2, msg_off, w_off, d3,
                            #   first coupling, steps, 0
    couplings: np.ndarray   # [n, 2] j, float bits of c; per path a block
                            #   [steps][halves][32 lanes], zero-padded

    def packed(self) -> Tuple[np.ndarray, Tuple[int, ...]]:
        """(one int32 array, meta = (n_unit, offset of the couplings,
        total length)); the couplings start 8-byte aligned."""
        head = self.units.reshape(-1)
        pad = np.zeros(len(head) % 2, np.int32)
        flat = np.concatenate([head, pad, self.couplings.reshape(-1)])
        return (flat.astype(np.int32),
                (len(self.units), len(head) + len(pad), len(flat)))


@functools.lru_cache(maxsize=None)
def _path_segments(layout: CGLayout):
    """Every path of gmulti_plan's list as (x_off, d1, mul, sh_off, d2,
    msg_off, w_off, d3, segs), chunk by chunk: segs[k * d1 + i] lists the
    couplings (j, c) of output component k and x component i, j
    ascending.  Checks that the paths cover every msg column once."""
    _, chunks, groups, paths, pair_start, coup, _ = _path_list(layout)
    coef = coup[:, 1].copy().view(np.float32)
    out = []
    msg_cover = np.zeros(layout.dim_msg, np.int64)
    for (x_off, d1, mul, gb, ge, _) in chunks:
        for (sh_off, d2, pb, pe) in groups[gb:ge]:
            for (msg_off, w_off, pair, d3) in paths[pb:pe]:
                segs: List[list] = [[] for _ in range(d1 * d3)]
                for i in range(d1):
                    for j in range(d2):
                        q0, q1 = pair_start[pair + i * d2 + j:
                                            pair + i * d2 + j + 2]
                        for q in range(q0, q1):
                            k = int(coup[q, 0]) // mul
                            segs[k * d1 + i].append((j, coef[q]))
                out.append((int(x_off), int(d1), int(mul), int(sh_off),
                            int(d2), int(msg_off), int(w_off), int(d3),
                            segs))
                for k in range(d3):
                    msg_cover[msg_off + k * mul:msg_off + (k + 1) * mul] += 1
    if not (msg_cover == 1).all():
        raise ValueError('cg_gagg / cg_agg: the paths do not cover every '
                         'msg column exactly once')
    return out


@functools.lru_cache(maxsize=None)
def gagg_plan(layout: CGLayout) -> GAggPlan:
    """gmulti_plan's chunks, groups, paths and couplings as cg_gagg.cu's
    units: each (i, j) segment's couplings (k * mul, c) of a path become
    the (j, c) entries of segment (k, i), j ascending."""
    units, entries = [], []
    for (x_off, d1, mul, sh_off, d2, msg_off, w_off, d3,
         segs) in _path_segments(layout):
        steps = max(len(sg) for sg in segs)
        lanes = -(-d1 * d3 // WARP) * WARP
        block = np.zeros((steps, lanes, 2), np.int32)
        for sgi, sg in enumerate(segs):
            for st, (j, c) in enumerate(sg):
                block[st, sgi] = (j, np.float32(c).view(np.int32))
        first = sum(len(e) for e in entries)
        entries.append(block.reshape(-1, 2))
        for u0 in range(0, mul, WARP):
            units.append((x_off, d1, mul, u0, sh_off, d2, msg_off,
                          w_off, d3, first, steps, 0))
    return GAggPlan(
        units=np.asarray(units, np.int32).reshape(-1, GAGG_UNIT),
        couplings=(np.concatenate(entries) if entries
                   else np.zeros((0, 2), np.int32)))


# --- agg: csrc/cg_agg.cu, a block per node group fed by bulk copies ---

AGG_ITEM = 10             # ints of an AggPlan item
AGG_MAX_STEPS = 7         # couplings of one B entry: at most d2 <= 7
AGG_ENTRY = 2 + 2 * AGG_MAX_STEPS
AGG_MAX_STAGES = 8        # ring stages (the kernel's mbarriers)
AGG_MAX_NODES = 8         # nodes of one block
AGG_MAX_WARPS = 16
# bytes of dynamic shared memory a block may ask for: the card's 232,448
# less the kernel's static 128 (its mbarriers and node offsets)
AGG_SMEM_MAX = 232448 - 128


@dataclass(frozen=True)
class AggConfig:
    """A launch of cg_agg.cu: ``tile`` edges a ring stage, ``stages``
    stages, ``nodes`` destination nodes a block, ``warps`` warps a
    block."""

    tile: int
    stages: int
    nodes: int
    warps: int


@dataclass(frozen=True)
class AggPlan:
    """A layout's work for csrc/cg_agg.cu at a node count and warp count.

    An item is one (node of the block, unit): a unit is one path and a
    32-channel slice of its x chunk, as in ``GAggPlan``; a lane is a
    channel u.  Per edge, a path's message component k is
    w[u] * sum_i x[i, u] * B[k][i] with B[k][i] = sum_j c * sh[j], which
    does not depend on u: the block forms each edge's B row once (an
    entry a (path, k, i), its couplings in steps) in shared memory, and
    the warps read it by broadcast.  A path's B block starts 16-byte
    aligned (``b_off``, a multiple of 4 floats), so it loads as float4s.
    The items go to the warps by estimated cost (longest first, to the
    least loaded warp); each item is one warp's, so every output column
    has one writer and one order."""

    items: np.ndarray       # [n_item, AGG_ITEM] node, x_off, d1, mul, first
                            #   channel, w_off, d3, msg_off, b_off, 0
    warp_start: np.ndarray  # [warps + 1] each warp's items
    entries: np.ndarray     # [n_entry, AGG_ENTRY] B column, steps, then
                            #   (sh column j, float bits of c) per step
    b_row: int              # floats of one edge's B row (a multiple of 4)

    def packed(self) -> Tuple[np.ndarray, Tuple[int, ...]]:
        """(one int32 array, meta = (n_entry, offsets of warp_start, items
        and entries, total length))."""
        flat, offs = [], []
        for a in (self.warp_start, self.items, self.entries):
            offs.append(sum(map(len, flat)))
            flat.append(a.reshape(-1))
        flat = np.concatenate(flat).astype(np.int32)
        return flat, (len(self.entries), *offs, len(flat))


def _agg_item_cost(d1: int, d3: int) -> int:
    """Instructions a lane spends on one edge of a unit: d1 x loads, the
    w load, the B row's float4 loads, d1 * d3 + d3 multiply-adds."""
    return d1 + 1 + -(-d1 * d3 // 4) + d1 * d3 + d3


@functools.lru_cache(maxsize=None)
def agg_plan(layout: CGLayout, nodes: int, warps: int) -> AggPlan:
    """``_path_segments`` as cg_agg.cu's items and B entries for blocks of
    ``nodes`` nodes and ``warps`` warps."""
    if not (1 <= nodes <= AGG_MAX_NODES and 1 <= warps <= AGG_MAX_WARPS):
        raise ValueError(f'cg_agg: {nodes} nodes, {warps} warps a block')
    units, entries = [], []
    b_row = 0
    for (x_off, d1, mul, sh_off, _, msg_off, w_off, d3,
         segs) in _path_segments(layout):
        for q, sg in enumerate(segs):
            if len(sg) > AGG_MAX_STEPS:
                raise ValueError(f'cg_agg: {len(sg)} couplings of one B '
                                 f'entry (at most {AGG_MAX_STEPS})')
            ent = np.zeros(AGG_ENTRY, np.int32)
            ent[:2] = (b_row + q, len(sg))
            for st, (j, c) in enumerate(sg):
                ent[2 + 2 * st:4 + 2 * st] = (
                    sh_off + j, np.float32(c).view(np.int32))
            entries.append(ent)
        for u0 in range(0, mul, WARP):
            units.append((x_off, d1, mul, u0, w_off, d3, msg_off, b_row))
        b_row += -(-d1 * d3 // 4) * 4
    items = [(g, *unit, 0) for g in range(nodes) for unit in units]
    cost = [_agg_item_cost(it[2], it[6]) for it in items]
    load = [0] * warps
    mine: List[list] = [[] for _ in range(warps)]
    for q in sorted(range(len(items)), key=lambda q: (-cost[q], q)):
        w = min(range(warps), key=lambda w: (load[w], w))
        load[w] += cost[q]
        mine[w].append(q)
    order = [q for w in range(warps) for q in sorted(mine[w])]
    warp_start = np.cumsum([0] + [len(m) for m in mine]).astype(np.int32)
    return AggPlan(
        items=np.asarray([items[q] for q in order],
                         np.int32).reshape(-1, AGG_ITEM),
        warp_start=warp_start,
        entries=np.asarray(entries, np.int32).reshape(-1, AGG_ENTRY),
        b_row=max(b_row, 4))


@dataclass(frozen=True)
class AggSmem:
    """cg_agg.cu's dynamic shared memory, in floats: ``stages`` stages of
    [x span | sh span | w span] (each span a 16-byte aligned copy of a
    tile's rows, ``*_cap`` floats), then two B buffers of ``tile`` rows,
    then the block's accumulators [nodes, dim_msg].  Every section starts
    16-byte aligned."""

    x_cap: int
    sh_cap: int
    w_cap: int
    stage: int
    b_base: int
    acc_base: int
    total: int

    @property
    def nbytes(self) -> int:
        return 4 * self.total


def _cap(tile: int, dim: int) -> int:
    """Floats of a staging buffer: a tile's rows start up to 3 floats
    past the 16-byte boundary the copy starts at, and the copy ends up to
    3 floats past them."""
    return -(-(tile * dim + 6) // 4) * 4


def agg_smem(layout: CGLayout, cfg: AggConfig, b_row: int) -> AggSmem:
    if not (cfg.tile >= 1 and 2 <= cfg.stages <= AGG_MAX_STAGES):
        # a tile is issued stages - 1 tiles ahead of its use
        raise ValueError(f'cg_agg: tiles of {cfg.tile} edges, '
                         f'{cfg.stages} stages')
    x_cap = _cap(cfg.tile, layout.dim_x)
    sh_cap = _cap(cfg.tile, layout.dim_sh)
    w_cap = _cap(cfg.tile, layout.dim_w)
    stage = x_cap + sh_cap + w_cap
    b_base = cfg.stages * stage
    acc_base = b_base + 2 * cfg.tile * b_row
    acc = -(-cfg.nodes * layout.dim_msg // 4) * 4
    return AggSmem(x_cap=x_cap, sh_cap=sh_cap, w_cap=w_cap, stage=stage,
                   b_base=b_base, acc_base=acc_base, total=acc_base + acc)


def agg_span(e0: int, ne: int, dim: int, total: int):
    """The staging of one edge array's rows [e0, e0 + ne) of width
    ``dim`` (``total`` floats in the array), as cg_agg.cu computes it:
    (a0, bulk, tail_end, off).  Floats [a0, a0 + bulk) come by one bulk
    copy (16-byte aligned start and size: a0 and bulk are multiples of 4;
    the copy never reads past the array's last whole 16 bytes), floats
    [a0 + bulk, tail_end) by plain loads (only where the rows reach into
    the array's last partial 16 bytes), each float f to buffer position
    f - a0; row r of the tile starts at buffer position off + r * dim."""
    f0, f1 = e0 * dim, (e0 + ne) * dim
    a0 = f0 // 4 * 4
    a1 = min(-(-f1 // 4) * 4, total // 4 * 4)
    bulk = max(a1 - a0, 0)
    return a0, bulk, max(f1, a0 + bulk), f0 - a0


_DEVICE_CACHE: Dict[tuple, tuple] = {}


def on_device(key, arrays, device: torch.device):
    """Device copies of host tables, cached per (key, device)."""
    ck = (key, str(device))
    if ck not in _DEVICE_CACHE:
        _DEVICE_CACHE[ck] = tuple(
            torch.as_tensor(a).to(device) for a in arrays)
    return _DEVICE_CACHE[ck]
