"""Host-built plans that drive the convolution's CUDA kernels.

Every plan lists the layout's couplings (the nonzero Wigner-3j terms of
each path, ``CGPath.nnz``) once per path, not unrolled over the
multiplicity: a kernel's lane is one channel u of an x chunk, and the
lanes of a warp read the same coupling by broadcast.

- gmulti (every edge-side cotangent of the double backward, and through
  it multi, the first-order edge cotangents): ``gmulti_plan`` lists each
  path's couplings (k, i, j, c) once, for every channel u and every job
  (see ``GMultiPlan``); ``gmulti_passes`` lays the jobs (emit mode, two
  pool legs, group) into its slots.
- gagg (the double backward's ybar cotangent, a sum of agg terms over a
  pool of edge arrays) is driven by ``gagg_plan``: the same chunks,
  groups, paths and couplings, re-sorted so that a lane can form each
  output component k from its own segment (k, i) (see ``GAggPlan``).
- agg (cg_agg.cu, the forward): ``agg_plan``, the paths' B entries
  (``_b_rows``: B[k][i] = sum_j c sh[j], formed once per edge and shared
  by every channel) and (node, unit) items spread over a block's warps,
  with its shared memory ``agg_smem`` and its bulk-copy spans
  ``agg_span``.
- quad (cg_quad.cu, the per-edge modes msg / x / sh / w, no
  aggregation): ``quad_plan``, the same B entries and units of a chunk
  slice as (unit, edge) items, the sh mode's coefficients at the
  selection rule's entries (``w3j_pattern``) and
  the order of its column sums, with its shared memory ``quad_smem``.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from .fused_conv import _MODE_LEGS, CGLayout

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


@functools.lru_cache(maxsize=None)
def _b_rows(layout: CGLayout):
    """The B entries of every path (``_path_segments`` order) as
    [n_entry, AGG_ENTRY] int32 rows (B column, steps, then (sh column j,
    float bits of c) per step), each path's B block offset (a multiple of
    4 floats) and the floats of one edge's B row (a multiple of 4)."""
    entries, b_offs = [], []
    b_row = 0
    for (_, d1, _, sh_off, _, _, _, d3, segs) in _path_segments(layout):
        for q, sg in enumerate(segs):
            if len(sg) > AGG_MAX_STEPS:
                raise ValueError(f'{len(sg)} couplings of one B entry (at '
                                 f'most {AGG_MAX_STEPS})')
            ent = np.zeros(AGG_ENTRY, np.int32)
            ent[:2] = (b_row + q, len(sg))
            for st, (j, c) in enumerate(sg):
                ent[2 + 2 * st:4 + 2 * st] = (
                    sh_off + j, np.float32(c).view(np.int32))
            entries.append(ent)
        b_offs.append(b_row)
        b_row += -(-d1 * d3 // 4) * 4
    return (np.asarray(entries, np.int32).reshape(-1, AGG_ENTRY),
            tuple(b_offs), max(b_row, 4))


def _agg_item_cost(d1: int, d3: int) -> int:
    """Instructions a lane spends on one edge of a unit: d1 x loads, the
    w load, the B row's float4 loads, d1 * d3 + d3 multiply-adds."""
    return d1 + 1 + -(-d1 * d3 // 4) + d1 * d3 + d3


def _spread(cost: List[int], warps: int):
    """Items to warps by cost, longest first to the least loaded warp:
    (the items' order, warp by warp and ascending within a warp, and each
    warp's start in it, [warps + 1] int32)."""
    load = [0] * warps
    mine: List[list] = [[] for _ in range(warps)]
    for q in sorted(range(len(cost)), key=lambda q: (-cost[q], q)):
        w = min(range(warps), key=lambda w: (load[w], w))
        load[w] += cost[q]
        mine[w].append(q)
    order = [q for w in range(warps) for q in sorted(mine[w])]
    return order, np.cumsum([0] + [len(m) for m in mine]).astype(np.int32)


@functools.lru_cache(maxsize=None)
def agg_plan(layout: CGLayout, nodes: int, warps: int) -> AggPlan:
    """``_path_segments`` as cg_agg.cu's items and B entries for blocks of
    ``nodes`` nodes and ``warps`` warps."""
    if not (1 <= nodes <= AGG_MAX_NODES and 1 <= warps <= AGG_MAX_WARPS):
        raise ValueError(f'cg_agg: {nodes} nodes, {warps} warps a block')
    entries, b_offs, b_row = _b_rows(layout)
    units = [(x_off, d1, mul, u0, w_off, d3, msg_off, b_off)
             for (x_off, d1, mul, _, _, msg_off, w_off, d3, _), b_off
             in zip(_path_segments(layout), b_offs)
             for u0 in range(0, mul, WARP)]
    items = [(g, *unit, 0) for g in range(nodes) for unit in units]
    order, warp_start = _spread(
        [_agg_item_cost(it[2], it[6]) for it in items], warps)
    return AggPlan(
        items=np.asarray([items[q] for q in order],
                         np.int32).reshape(-1, AGG_ITEM),
        warp_start=warp_start, entries=entries, b_row=b_row)


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


# --- quad: csrc/cg_quad.cu, the per-edge modes fed by bulk copies ---

QUAD_MODES = ('msg', 'x', 'sh', 'w')
QUAD_UNIT = 7             # ints of a QuadPlan unit
QUAD_PATH = 5             # ints of a QuadPlan path
QUAD_MAX_STAGES = 8       # ring stages (the kernel's mbarriers)
QUAD_MAX_WARPS = 16
QUAD_MAX_TILE = 64
QUAD_SH_EDGES = 2         # edges of an sh item
# bytes of dynamic shared memory a block may ask for: the card's 232,448
# less the kernel's static 64 (its mbarriers)
QUAD_SMEM_MAX = 232448 - 64


@dataclass(frozen=True)
class QuadConfig:
    """A launch of cg_quad.cu: ``tile`` edges a ring stage, ``stages``
    stages, ``warps`` warps a block."""

    tile: int
    stages: int
    warps: int


@dataclass(frozen=True)
class QuadPlan:
    """A layout's work in one per-edge mode for csrc/cg_quad.cu, for tiles
    of ``tile`` edges and blocks of ``warps`` warps.

    A unit is 32 channels (a slice) of one x chunk, a lane one channel u:
    for msg and w one path of the chunk (``lo`` = the path, ``hi`` = lo +
    1), for x every group of the chunk (``lo``..``hi``; a chunk without
    groups writes zeros), for sh one group (``lo``, ``hi`` = lo + 1), its
    lanes' partial sums added by the warp into ``red``..``red + d2`` of
    the edge's row of partials.  An item is a unit and an edge of the
    tile (in the sh mode an edge pair: the edge and the next, if the tile
    has it); the items go to the warps by estimated cost (``_spread``),
    so every output column of an edge has one writer.  The sh columns are
    then summed from the partials in a fixed order (``col_start`` /
    ``col_parts``): per group covering the column, in group order, its
    slices in order.  B entries (msg, x, w) are ``_b_rows``'.  The sh
    mode reads each path's couplings as ``coef``: the float bits of
    C[i][j][k] at every entry of ``w3j_pattern(d1, d2, d3)`` in its
    order (zero where the pattern has an entry the path lacks), padded
    to a multiple of 4 floats, at ``paths``' c_off; the kernel knows
    the pattern at compile time and its lanes read the values by
    broadcast as float4s."""

    units: np.ndarray       # [n_unit, QUAD_UNIT] x_off, d1, mul, first
                            #   channel, lo, hi, red
    groups: np.ndarray      # [n_group, 4] sh_off, d2, path begin, end
    paths: np.ndarray       # [n_path, QUAD_PATH] msg_off, w_off, d3,
                            #   b_off, c_off (sh: its coefficients)
    entries: np.ndarray     # [n_entry, AGG_ENTRY] (msg, x, w; else empty)
    warp_start: np.ndarray  # [warps + 1] each warp's items
    items: np.ndarray       # [n_item, 2] unit, edge of the tile
    col_start: np.ndarray   # [dim_sh + 1] (sh; else [1]) into col_parts
    col_parts: np.ndarray   # [n_part, 3] first partial, slices, stride
    coef: np.ndarray        # [n_coef] float bits (sh; else empty)
    b_row: int              # floats of an edge's B row (0 in the sh mode)
    n_red: int              # floats of an edge's partials (sh; else 0)

    def packed(self) -> Tuple[np.ndarray, Tuple[int, ...]]:
        """(one int32 array of every section, meta = (n_entry, offsets of
        units, groups, paths, entries, warp_start, items, col_start,
        col_parts, coef, coef length, total length)); the items start
        8-byte aligned (read as int2), the coefficients 16-byte aligned
        (float4)."""
        flat, offs = [], []
        for a in (self.units, self.groups, self.paths, self.entries,
                  self.warp_start, self.items, self.col_start,
                  self.col_parts, self.coef):
            pad = {id(self.items): 2, id(self.coef): 4}.get(id(a), 1)
            n = sum(map(len, flat))
            if n % pad:
                flat.append(np.zeros(pad - n % pad, np.int32))
            offs.append(sum(map(len, flat)))
            flat.append(a.reshape(-1))
        flat = np.concatenate(flat).astype(np.int32)
        return flat, (len(self.entries), *offs, len(self.coef), len(flat))


@functools.lru_cache(maxsize=None)
def w3j_pattern(d1: int, d2: int, d3: int) -> Tuple[Tuple[int, int, int],
                                                    ...]:
    """The entries (i, j, k) at which a real-basis Wigner-3j block of
    irrep dims d1 x d2 -> d3 may be nonzero, in (i, j, k) order: with
    l = (d - 1) / 2 and m = index - l, |m3| is |m1| + |m2| or
    ||m1| - |m2||, and the negative m's and l1 + l2 + l3 have an even
    sum (the product of cos / sin harmonics).  It is every l <= 2 block's
    nonzero set exactly and holds every l <= 3 block's (a few accidental
    zeros more); csrc/cg_quad.cu compiles the same rule (quad_nz)."""
    l1, l2, l3 = (int(d) // 2 for d in (d1, d2, d3))
    out = []
    for i in range(d1):
        for j in range(d2):
            for k in range(d3):
                m1, m2, m3 = abs(i - l1), abs(j - l2), abs(k - l3)
                odd = (i < l1) + (j < l2) + (k < l3) + l1 + l2 + l3
                if m3 in (m1 + m2, abs(m1 - m2)) and odd % 2 == 0:
                    out.append((i, j, k))
    return tuple(out)


def quad_max_dim(layout: CGLayout) -> int:
    """The largest irrep dim of the layout's paths (x, sh and output
    irreps): cg_quad.cu runs a kernel built for dims up to 5 where it is
    at most 5, else one built for dims up to 7 (``GMULTI_MAX_D``)."""
    d = max((max(g.d1, g.d2, *(p.d_out for p in g.paths))
             for g in layout.groups), default=1)
    if d > GMULTI_MAX_D:
        raise ValueError(f'cg_quad takes irreps of dim <= {GMULTI_MAX_D}, '
                         f'got {d}')
    return d


def _quad_unit_cost(mode: str, d1: int, paths) -> int:
    """Instructions a lane spends on one edge of a unit over its paths
    ((d2, d3, selection-rule entries) each): loads, products, adds,
    stores."""
    if mode in ('msg', 'w'):
        (_, d3, _), = paths
        return d1 + 2 + -(-d1 * d3 // 4) + 2 * d1 * d3 + 3 * d3
    if mode == 'x':
        return 2 * d1 + sum(1 + 2 * d3 + -(-d1 * d3 // 4) + d1 * d3
                            for (_, d3, _) in paths)
    d2 = paths[0][0]
    return d1 + 10 * d2 + sum(1 + 2 * d3 + -(-n // 4) + n + d1 * d2
                              for (_, d3, n) in paths)


@functools.lru_cache(maxsize=None)
def quad_plan(layout: CGLayout, mode: str, tile: int,
              warps: int) -> QuadPlan:
    """``_path_list`` as cg_quad.cu's units and items in ``mode``."""
    if mode not in QUAD_MODES:
        raise ValueError(f'cg_quad mode {mode}')
    if not (1 <= tile <= QUAD_MAX_TILE and 1 <= warps <= QUAD_MAX_WARPS):
        raise ValueError(f'cg_quad: tiles of {tile} edges, {warps} warps')
    quad_max_dim(layout)
    _, chunks, groups, paths, pair_start, coup, _ = _path_list(layout)
    entries, b_offs, b_row = _b_rows(layout)
    # per path: (d2, d3, selection-rule entries), its row and (sh) its
    # coefficients at the rule's entries
    info, coefs = [], []
    path_rows = np.zeros((len(paths), QUAD_PATH), np.int32)
    n_coef = 0
    cval = coup[:, 1].copy().view(np.float32)
    for gi, (_, d2, pb, pe) in enumerate(groups):
        d1, mul = next((int(c[1]), int(c[2])) for c in chunks
                       if c[3] <= gi < c[4])
        d2 = int(d2)
        for p in range(pb, pe):
            msg_off, w_off, pair, d3 = (int(v) for v in paths[p])
            at = {e: q for q, e in enumerate(w3j_pattern(d1, d2, d3))}
            info.append((d2, d3, len(at)))
            path_rows[p] = (msg_off, w_off, d3, b_offs[p], n_coef)
            if mode != 'sh':
                continue
            vals = np.zeros(-(-len(at) // 4) * 4, np.float32)
            for i in range(d1):
                for j in range(d2):
                    for q in range(pair_start[pair + i * d2 + j],
                                   pair_start[pair + i * d2 + j + 1]):
                        e = (i, j, int(coup[q, 0]) // mul)
                        if e not in at:
                            raise ValueError(
                                f'cg_quad: coupling {e} of a {d1} x {d2} '
                                f'-> {d3} path lies outside the selection '
                                'rule')
                        vals[at[e]] = cval[q]
            coefs.append(vals.view(np.int32))
            n_coef += len(vals)
    units, cost = [], []
    red, red_of = 0, {}     # sh: each group's first partial and slices
    for (x_off, d1, mul, gb, ge, _) in chunks:
        slices = range(0, mul, WARP)
        if mode == 'x':
            for u0 in slices:
                units.append((x_off, d1, mul, u0, gb, ge, 0))
                cost.append(_quad_unit_cost(
                    mode, d1, [info[p] for g in range(gb, ge)
                               for p in range(groups[g, 2], groups[g, 3])]))
            continue
        for g in range(gb, ge):
            pb, pe = int(groups[g, 2]), int(groups[g, 3])
            if mode == 'sh':
                for s, u0 in enumerate(slices):
                    units.append((x_off, d1, mul, u0, g, g + 1,
                                  red + s * int(groups[g, 1])))
                    cost.append(_quad_unit_cost(
                        mode, d1, [info[p] for p in range(pb, pe)]))
                red_of[g] = (red, len(slices))
                red += len(slices) * int(groups[g, 1])
                continue
            for p in range(pb, pe):
                for u0 in slices:
                    units.append((x_off, d1, mul, u0, p, p + 1, 0))
                    cost.append(_quad_unit_cost(mode, d1, [info[p]]))
    step = QUAD_SH_EDGES if mode == 'sh' else 1
    items = [(q, le) for le in range(0, tile, step)
             for q in range(len(units))]
    order, warp_start = _spread([cost[q] for q, _ in items], warps)
    col_start, col_parts = [0], []
    for col in range(layout.dim_sh if mode == 'sh' else 0):
        for g, (first, n_slice) in sorted(red_of.items()):
            sh_off, d2 = int(groups[g, 0]), int(groups[g, 1])
            if sh_off <= col < sh_off + d2:
                col_parts.append((first + col - sh_off, n_slice, d2))
        col_start.append(len(col_parts))
    use_b = mode != 'sh'
    return QuadPlan(
        units=np.asarray(units, np.int32).reshape(-1, QUAD_UNIT),
        groups=groups, paths=path_rows,
        entries=entries if use_b else np.zeros((0, AGG_ENTRY), np.int32),
        warp_start=warp_start,
        items=np.asarray([items[q] for q in order], np.int32).reshape(-1, 2),
        col_start=np.asarray(col_start, np.int32),
        col_parts=np.asarray(col_parts, np.int32).reshape(-1, 3),
        coef=(np.concatenate(coefs) if coefs else np.zeros(0, np.int32)),
        b_row=b_row if use_b else 0, n_red=red)


@dataclass(frozen=True)
class QuadSmem:
    """cg_quad.cu's dynamic shared memory, in floats: ``stages`` stages of
    the mode's three legs' spans (``caps``: each a 16-byte aligned copy of
    a tile's rows), then two B buffers of ``tile`` rows (msg, x, w), then
    two buffers of ``tile`` rows of sh partials and the paths'
    coefficients (sh).  Every section starts 16-byte aligned."""

    caps: Tuple[int, int, int]
    stage: int
    b_base: int
    red_base: int
    red_row: int
    coef_base: int
    total: int

    @property
    def nbytes(self) -> int:
        return 4 * self.total


def quad_smem(layout: CGLayout, mode: str, cfg: QuadConfig,
              plan: QuadPlan) -> QuadSmem:
    if not (1 <= cfg.tile <= QUAD_MAX_TILE
            and 2 <= cfg.stages <= QUAD_MAX_STAGES):
        # a tile is issued stages - 1 tiles ahead of its use
        raise ValueError(f'cg_quad: tiles of {cfg.tile} edges, '
                         f'{cfg.stages} stages')
    caps = tuple(_cap(cfg.tile, layout.mode_dims[leg])
                 for leg in _MODE_LEGS[mode])
    stage = sum(caps)
    b_base = cfg.stages * stage
    red_base = b_base + 2 * cfg.tile * plan.b_row
    red_row = -(-plan.n_red // 4) * 4
    coef_base = red_base + 2 * cfg.tile * red_row
    return QuadSmem(caps=caps, stage=stage, b_base=b_base,
                    red_base=red_base, red_row=red_row,
                    coef_base=coef_base, total=coef_base + len(plan.coef))


_DEVICE_CACHE: Dict[tuple, tuple] = {}


def on_device(key, arrays, device: torch.device):
    """Device copies of host tables, cached per (key, device)."""
    ck = (key, str(device))
    if ck not in _DEVICE_CACHE:
        _DEVICE_CACHE[ck] = tuple(
            torch.as_tensor(a).to(device) for a in arrays)
    return _DEVICE_CACHE[ck]
