"""The cg_node family's backward Functions, closed under autograd.

Port of ``sevennet_finetuning_tpu/ops/fused_conv_multi.py``.  With the
quadrilinear scalar S = sum_e C . x[e] . sh[e] . w[e] . ybar[dst[e]]
(``ops/fused_conv_agg``), every derivative of the convolution is one of
three grouped calls, each an autograd Function whose backward calls only
Functions of this family (so a third order works too):

- ``CGNodeMulti``: several first-order edge cotangents xn / shn / wn over
  one shared (ybar, x, sh, w, dst) -- ``CGNodeAgg``'s backward.  It is
  one ``cg_gmulti`` pass over the pool [x, sh, w], a job a group (xn the
  x job of legs (sh, w), shn the sh job of (x, w), wn the w job of
  (x, sh)), launched through ``csrc/cg_gmulti.cu``'s entry point built
  for one job slot (``cg_multi_f32``; its launches count as ``cg_multi``).
- ``CGNodeGAgg``: a sum of agg terms whose legs come from a pool of edge
  arrays -- the ybar cotangent of a double backward.  Kernel
  ``csrc/cg_gagg.cu``, driven by the same path-level couplings
  (``cg_tables.gagg_plan``).
- ``CGNodeGMulti``: node-mode jobs (emit mode, two pool legs, group) over
  one shared ybar, grouped outputs -- every edge-side cotangent of a
  double backward.  Kernel ``csrc/cg_gmulti.cu``, driven by the layout's
  path-level coupling list (``cg_tables.gmulti_plan``).

``CGNodeMulti.backward`` is JAX's ``_multi_transpose`` fused the way
``_mls_transpose`` fuses it: for jobs (xn, shn, wn) with cotangents
(ct_xn, ct_shn, ct_wn) the ybar cotangent is ONE gagg of three terms and
the x / sh / w cotangents ONE gmulti of six jobs in three groups, over
the pool [x, sh, w, ct_xn, ct_shn, ct_wn].  Jobs are visited in reverse,
as ``_mls_transpose`` does; a ``None`` cotangent (``ad.Zero`` in JAX)
skips its job.

On CUDA tensors each Function launches its kernel; on CPU tensors it
runs the kernel's plain PyTorch version beside it.
"""

from __future__ import annotations

import functools
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from . import _cuda
from .cg_tables import (gagg_plan, gmulti_out_dims, gmulti_passes,
                        gmulti_plan, on_device)
from .fused_conv import CGLayout
from .fused_conv_agg import agg_plain, node_mode_plain
from .scatter import row_offsets

_JOB_LEGS = {'xn': ('sh', 'w'), 'shn': ('x', 'w'), 'wn': ('x', 'sh')}
# emit mode of each node-mode job and the node-mode job emitting each leg
_EMIT = {'xn': 'x', 'shn': 'sh', 'wn': 'w'}
_EMIT2NODE = {v: k for k, v in _EMIT.items()}
# leg roles (b, c) of each emit mode, in cg_node leg order after ybar
_EMIT_LEGS = {'x': ('sh', 'w'), 'sh': ('x', 'w'), 'w': ('x', 'sh')}

# edges per block of the gmulti kernel (consecutive, so they mostly share
# one destination node and its ybar row)
EDGES_PER_BLOCK = 16
# pool pointers and terms a kernel launch takes (csrc/cg_g*.cu)
MAX_POOL = 12
MAX_GAGG_TERMS = 6


# ---------------------------------------------------------------------------
# multi: first-order edge cotangents
# ---------------------------------------------------------------------------

def multi_plain(ybar, x, sh, w, dst, jobs: Sequence[str],
                layout: CGLayout, n_node: int):
    legs = {'x': x, 'sh': sh, 'w': w}
    return tuple(
        node_mode_plain(j, ybar, *(legs[l] for l in _JOB_LEGS[j]), dst,
                        layout, n_node)
        for j in jobs)


# pool index of each leg in multi's pool [x, sh, w]
_MULTI_POOL = {'x': 0, 'sh': 1, 'w': 2}


def multi_cuda(ybar, x, sh, w, dst, jobs: Tuple[str, ...],
               layout: CGLayout, n_node: int,
               n_phase: Optional[int] = None):
    """The CUDA kernel: ybar [n_node, dim_msg], edge legs [E, dim] f32,
    dst [E] int32 ascending -> one [E, dim] array per job, each job at
    most once; one launch of ``cg_gmulti.cu`` built for one slot.
    ``n_phase`` as for ``gmulti_cuda``."""
    return _gmulti_launch('cg_multi', ybar, [x, sh, w], dst,
                          multi_jobs(jobs), jobs, layout, n_node, n_phase)


def multi_jobs(jobs: Tuple[str, ...]):
    """Multi's jobs as gmulti jobs over the pool [x, sh, w], each job its
    own group: (emit mode, b, c, job)."""
    if len(set(jobs)) != len(jobs):
        raise ValueError(f'multi jobs {jobs}: each job at most once')
    return tuple((_EMIT[j], *(_MULTI_POOL[leg] for leg in _JOB_LEGS[j]), j)
                 for j in jobs)


class _Pool:
    """Edge arrays collected by identity, in first-use order."""

    def __init__(self):
        self.arrays: List[torch.Tensor] = []
        self._ids: Dict[int, int] = {}

    def __call__(self, arr: torch.Tensor) -> int:
        key = id(arr)
        if key not in self._ids:
            self._ids[key] = len(self.arrays)
            self.arrays.append(arr)
        return self._ids[key]


class CGNodeMulti(torch.autograd.Function):
    @staticmethod
    def forward(ctx, ybar, x, sh, w, dst, jobs, layout, n_node):
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(ybar, x, sh, w, dst)
        ctx.jobs, ctx.layout, ctx.n_node = jobs, layout, n_node
        if ybar.is_cuda:
            return multi_cuda(ybar.contiguous(), x.contiguous(),
                              sh.contiguous(), w.contiguous(),
                              dst.contiguous(), jobs, layout, n_node)
        return multi_plain(ybar, x, sh, w, dst, jobs, layout, n_node)

    @staticmethod
    def backward(ctx, *cts):
        ybar, x, sh, w, dst = ctx.saved_tensors
        canon = {'x': x, 'sh': sh, 'w': w}
        need = dict(zip(('ybar', 'x', 'sh', 'w'), ctx.needs_input_grad[:4]))
        # jobs in reverse, as _mls_transpose visits them
        live = [(j, ct) for j, ct in reversed(list(zip(ctx.jobs, cts)))
                if ct is not None]
        res = dict.fromkeys(('ybar', 'x', 'sh', 'w'))
        if not live:
            return res['ybar'], None, None, None, None, None, None, None
        pool = _Pool()
        for leg in ('x', 'sh', 'w'):
            pool(canon[leg])
        subs = []                      # canonical legs of each job's S
        for j, ct in live:
            s = dict(canon)
            s[_EMIT[j]] = ct
            subs.append((j, s))
        if need['ybar']:
            terms = tuple((pool(s['x']), pool(s['sh']), pool(s['w']))
                          for _, s in subs)
            res['ybar'] = cg_node_gagg(pool.arrays, dst, terms=terms,
                                       layout=ctx.layout,
                                       n_node=ctx.n_node)
        gjobs, groups = [], []
        for leg in ('x', 'sh', 'w'):
            if not need[leg]:
                continue
            for j, s in subs:
                if leg not in _JOB_LEGS[j]:
                    continue           # out_j does not depend on its leg
                bl, cl = _EMIT_LEGS[leg]
                gjobs.append((leg, pool(s[bl]), pool(s[cl]), leg))
                if leg not in groups:
                    groups.append(leg)
        if gjobs:
            outs = cg_node_gmulti(ybar, pool.arrays, dst, jobs=gjobs,
                                  groups=groups, layout=ctx.layout,
                                  n_node=ctx.n_node)
            res.update(zip(groups, outs))
        return (res['ybar'], res['x'], res['sh'], res['w'],
                None, None, None, None)


def cg_node_multi(ybar, x, sh, w, dst, *, jobs, layout: CGLayout,
                  n_node: int):
    """Several backward modes from ('xn', 'shn', 'wn') at once; returns
    one edge-major array per job."""
    jobs = tuple(jobs)
    if not jobs or not all(j in _JOB_LEGS for j in jobs):
        raise ValueError(f'cg_node_multi jobs {jobs}')
    return CGNodeMulti.apply(ybar, x, sh, w, dst, jobs, layout, n_node)


# ---------------------------------------------------------------------------
# gagg: a sum of agg terms over a pool of edge legs
# ---------------------------------------------------------------------------

def gagg_plain(pool, dst, terms, layout: CGLayout, n_node: int):
    """Plain PyTorch version: the agg terms, added left to right."""
    out = None
    for (xi, si, wi) in terms:
        term = agg_plain(pool[xi], pool[si], pool[wi], dst, layout, n_node)
        out = term if out is None else out + term
    return out


def _pool_dims(layout: CGLayout, pool, roles: Dict[int, str]):
    dims = layout.mode_dims
    for i, role in roles.items():
        if pool[i].shape[1] != dims[role]:
            raise ValueError(f'pool[{i}] as {role}: width '
                             f'{pool[i].shape[1]}, expected {dims[role]}')
    return tuple(int(p.shape[1]) for p in pool)


def _require_pool(pool, E):
    if not 1 <= len(pool) <= MAX_POOL:
        raise ValueError(f'{len(pool)} pool arrays; the kernels take 1 to '
                         f'{MAX_POOL}')
    for i, p in enumerate(pool):
        _cuda.require(p, f'pool[{i}]', torch.float32, (E, p.shape[1]))


def gagg_cuda(pool, dst, terms, layout: CGLayout, n_node: int):
    """The CUDA kernel: pool of [E, dim] f32 edge arrays, dst [E] int32
    ascending, terms (x, sh, w) pool indices -> [n_node, dim_msg]."""
    E = dst.shape[0]
    _require_pool(pool, E)
    _cuda.require(dst, 'dst', torch.int32, (E,))
    if not 1 <= len(terms) <= MAX_GAGG_TERMS:
        raise ValueError(f'{len(terms)} agg terms; the kernel takes 1 to '
                         f'{MAX_GAGG_TERMS}')
    roles = {}
    for (xi, si, wi) in terms:
        roles.update({xi: 'x', si: 'sh', wi: 'w'})
    _pool_dims(layout, pool, roles)
    flat, meta, n_unit = _gagg_args(layout)
    (plan,) = on_device(('gagg', layout), (flat,), dst.device)
    offs = row_offsets(dst, n_node)
    out = torch.empty((n_node, layout.dim_msg), dtype=torch.float32,
                      device=dst.device)
    fn = _cuda.kernel('cg_gagg')
    if n_node and n_unit:
        _cuda.LAUNCHES['cg_gagg'] += 1
    _cuda.check('cg_gagg', fn(
        _cuda.host_ptrs(pool), len(pool),
        _cuda.host_ints([i for term in terms for i in term]), len(terms),
        offs.data_ptr(), plan.data_ptr(), meta, out.data_ptr(), n_node,
        layout.dim_x, layout.dim_sh, layout.dim_w, layout.dim_msg,
        _cuda.stream_ptr(dst.device)))
    return out


@functools.lru_cache(maxsize=None)
def _gagg_args(layout: CGLayout):
    """Host side of a gagg launch, per layout: the packed plan, its meta
    as a C int array and the number of units."""
    flat, meta = gagg_plan(layout).packed()
    return flat, _cuda.host_ints(meta), meta[0]


class CGNodeGAgg(torch.autograd.Function):
    @staticmethod
    def forward(ctx, dst, terms, layout, n_node, *pool):
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(dst, *pool)
        ctx.terms, ctx.layout, ctx.n_node = terms, layout, n_node
        if dst.is_cuda:
            return gagg_cuda([p.contiguous() for p in pool],
                             dst.contiguous(), terms, layout, n_node)
        return gagg_plain(pool, dst, terms, layout, n_node)

    @staticmethod
    def backward(ctx, ct):
        """_gagg_transpose: ct stands at each term's ybar slot, so pool
        leg l of a term gets cg_node[LEG_MODE[l]] of the term's other
        legs -- one gmulti over ybar = ct, grouped by pool index."""
        dst, *pool = ctx.saved_tensors
        grads = [None] * len(pool)
        if ct is None:
            return (None,) * 4 + tuple(grads)
        need = ctx.needs_input_grad[4:]
        jobs, groups = [], []
        for (xi, si, wi) in ctx.terms:
            idx = {'x': xi, 'sh': si, 'w': wi}
            for leg in ('x', 'sh', 'w'):
                if not need[idx[leg]]:
                    continue
                bl, cl = _EMIT_LEGS[leg]
                jobs.append((leg, idx[bl], idx[cl], idx[leg]))
                if idx[leg] not in groups:
                    groups.append(idx[leg])
        if jobs:
            outs = cg_node_gmulti(ct, pool, dst, jobs=jobs, groups=groups,
                                  layout=ctx.layout, n_node=ctx.n_node)
            for g, o in zip(groups, outs):
                grads[g] = o
        return (None,) * 4 + tuple(grads)


def cg_node_gagg(pool, dst, *, terms, layout: CGLayout, n_node: int):
    """Sum of agg terms; ``terms``: tuple of (x_idx, sh_idx, w_idx) into
    ``pool``, combined left to right in order -> [n_node, dim_msg]."""
    terms = tuple(tuple(t) for t in terms)
    if not terms:
        raise ValueError('cg_node_gagg needs at least one term')
    return CGNodeGAgg.apply(dst, terms, layout, n_node, *pool)


# ---------------------------------------------------------------------------
# gmulti: grouped node-mode jobs over one shared ybar
# ---------------------------------------------------------------------------

def gmulti_plain(ybar, pool, dst, jobs, groups, layout: CGLayout,
                 n_node: int):
    """Plain PyTorch version: one node mode per job, added per group in
    job order (the JAX package's ``_gmulti_lower``)."""
    acc = {}
    for (m, bi, ci, grp) in jobs:
        val = node_mode_plain(_EMIT2NODE[m], ybar, pool[bi], pool[ci], dst,
                              layout, n_node)
        acc[grp] = val if grp not in acc else acc[grp] + val
    return tuple(acc[g] for g in groups)


def gmulti_cuda(ybar, pool, dst, jobs, groups, layout: CGLayout,
                n_node: int, n_phase: Optional[int] = None):
    """The CUDA kernel: ybar [n_node, dim_msg], pool of [E, dim] f32 edge
    arrays, dst [E] int32 ascending -> one [E, dim] array per group; one
    launch per pass (``gmulti_passes``).  ``n_phase``: the plan's phases
    (``gmulti_plan``, None for its measured rule; any count gives the
    same bits)."""
    if len(groups) > MAX_POOL:
        raise ValueError(f'{len(groups)} groups; the kernel takes at most '
                         f'{MAX_POOL}')
    return _gmulti_launch('cg_gmulti', ybar, pool, dst, jobs, groups, layout,
                          n_node, n_phase)


def _gmulti_launch(entry: str, ybar, pool, dst, jobs, groups,
                   layout: CGLayout, n_node: int, n_phase: Optional[int]):
    """The passes of grouped jobs through the C entry point ``entry`` of
    ``csrc/cg_gmulti.cu`` (``cg_gmulti``: two slots of each emit mode;
    ``cg_multi``: one), counted one launch a pass under its name."""
    E = dst.shape[0]
    _cuda.require(ybar, 'ybar', torch.float32, (n_node, layout.dim_msg))
    _require_pool(pool, E)
    _cuda.require(dst, 'dst', torch.int32, (E,))
    gidx = {g: i for i, g in enumerate(groups)}
    norm = tuple((m, bi, ci, gidx[g]) for (m, bi, ci, g) in jobs)
    roles = {}
    for (m, bi, ci, _) in norm:
        roles.update(zip((bi, ci), _EMIT_LEGS[m]))
    _pool_dims(layout, pool, roles)
    flat, meta, passes, n_pass, out_dims = _gmulti_args(
        layout, norm, len(groups), n_phase)
    (plan,) = on_device(('gmulti', layout, EDGES_PER_BLOCK, n_phase),
                        (flat,), dst.device)
    outs = [torch.empty((E, d), dtype=torch.float32, device=dst.device)
            for d in out_dims]
    fn = _cuda.kernel(entry)
    if E:
        _cuda.LAUNCHES[entry] += n_pass
    _cuda.check(entry, fn(
        ybar.data_ptr(), _cuda.host_ptrs(pool), len(pool),
        _cuda.host_ptrs(outs), len(outs), dst.data_ptr(), plan.data_ptr(),
        meta, passes, n_pass, E, n_node, layout.dim_x, layout.dim_sh,
        layout.dim_w, layout.dim_msg, EDGES_PER_BLOCK,
        _cuda.stream_ptr(dst.device)))
    return tuple(outs)


@functools.lru_cache(maxsize=None)
def _gmulti_args(layout: CGLayout, jobs, n_groups: int,
                 n_phase: Optional[int]):
    """Host side of a gmulti launch, per (layout, jobs, phases): the
    packed plan, its meta and the passes as C int arrays, the number of
    passes and the groups' widths."""
    flat, meta = gmulti_plan(layout, EDGES_PER_BLOCK, n_phase).packed()
    passes = gmulti_passes(jobs, n_groups)
    return (flat, _cuda.host_ints(meta),
            _cuda.host_ints(passes.reshape(-1).tolist()), len(passes),
            gmulti_out_dims(layout, jobs, n_groups))


class CGNodeGMulti(torch.autograd.Function):
    @staticmethod
    def forward(ctx, dst, jobs, groups, layout, n_node, ybar, *pool):
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(dst, ybar, *pool)
        ctx.jobs, ctx.groups = jobs, groups
        ctx.layout, ctx.n_node = layout, n_node
        if ybar.is_cuda:
            return gmulti_cuda(ybar.contiguous(),
                               [p.contiguous() for p in pool],
                               dst.contiguous(), jobs, groups, layout,
                               n_node)
        return gmulti_plain(ybar, pool, dst, jobs, groups, layout, n_node)

    @staticmethod
    def backward(ctx, *cts):
        """_gmulti_transpose: job (m, b, c, grp) is <S, ct_grp> with ct_grp
        at its emit leg m; ybar gets one gagg of every live job's legs and
        the pool legs one gmulti over the same ybar."""
        dst, ybar, *pool_in = ctx.saved_tensors
        n_in = len(pool_in)
        need_ybar = ctx.needs_input_grad[5]
        need = ctx.needs_input_grad[6:]
        ct_of = dict(zip(ctx.groups, cts))
        pool = _Pool()
        for p in pool_in:
            pool(p)
        res = [None] * (1 + n_in)
        terms, gjobs, groups = [], [], []
        for (m, bi, ci, grp) in ctx.jobs:
            ct = ct_of[grp]
            if ct is None:
                continue
            bl, cl = _EMIT_LEGS[m]
            s = {m: ct, bl: pool_in[bi], cl: pool_in[ci]}
            if need_ybar:
                terms.append((pool(s['x']), pool(s['sh']), pool(s['w'])))
            for idx, leg in ((bi, bl), (ci, cl)):
                if not need[idx]:
                    continue
                ol, oc = _EMIT_LEGS[leg]
                gjobs.append((leg, pool(s[ol]), pool(s[oc]), idx))
                if idx not in groups:
                    groups.append(idx)
        if terms:
            res[0] = cg_node_gagg(pool.arrays, dst, terms=terms,
                                  layout=ctx.layout, n_node=ctx.n_node)
        if gjobs:
            outs = cg_node_gmulti(ybar, pool.arrays, dst, jobs=gjobs,
                                  groups=groups, layout=ctx.layout,
                                  n_node=ctx.n_node)
            for g, o in zip(groups, outs):
                res[1 + g] = o
        return (None,) * 5 + tuple(res)


def cg_node_gmulti(ybar, pool, dst, *, jobs, groups, layout: CGLayout,
                   n_node: int):
    """Grouped node-mode jobs: ``jobs`` a tuple of (emit_mode, b_idx,
    c_idx, group), emit_mode in ('x', 'sh', 'w') and (b_idx, c_idx)
    indexing ``pool`` in the mode's leg order; ``groups`` the distinct
    group ids in output order.  Returns one [E, dim] array per group."""
    jobs = tuple(tuple(j) for j in jobs)
    groups = tuple(groups)
    for (m, _, _, g) in jobs:
        if m not in _EMIT_LEGS or g not in groups:
            raise ValueError(f'cg_node_gmulti job {(m, g)}')
    return CGNodeGMulti.apply(dst, jobs, groups, layout, n_node, ybar,
                              *pool)
