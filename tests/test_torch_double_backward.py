"""The double backward of the port's convolution against the JAX package.

- ``gagg_plain`` and ``gmulti_plain`` against the Pallas kernels
  ``gagg_pallas`` / ``gmulti_pallas`` in interpret mode, on a small layout
  and on SevenNet-0's interior layout (block 1 of the in-repo checkpoint)
  with few edges, including sentinel edges and an all-sentinel edge tile
  (the Pallas kernels' edge tile is 128);
- CPU evaluators of the term tables that drive ``csrc/cg_gagg.cu`` and
  ``csrc/cg_gmulti.cu`` (``gagg_table`` / ``gmulti_table``), walked the way
  the kernels walk them, against the plain versions;
- ``CGNodeMulti``'s backward against ``jax.vjp`` of JAX ``cg_node_multi``,
  with some cotangents absent and some inputs constant;
- grad-of-grad of ``conv_aggregate`` (``autograd.grad`` with
  ``create_graph=True`` followed by a backward) against JAX's grad of grad;
- third order: ``torch.autograd.gradgradcheck`` of ``CGNodeMulti``,
  ``CGNodeGAgg`` and ``CGNodeGMulti`` and of the scatter family in float64;
- a census of the Functions that the double backward's graph records.

Tolerance: 2e-5 relative to the largest magnitude of the reference
(float32 sums of up to a few thousand terms in another order).
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sevennet_finetuning_tpu.irreps import Irreps as JIrreps
from sevennet_finetuning_tpu.ops import fused_conv as j_fc
from sevennet_finetuning_tpu.ops.fused_conv_agg import (
    cg_node_apply as j_cg_node_apply)
from sevennet_finetuning_tpu.ops.fused_conv_agg_kernel import gagg_pallas
from sevennet_finetuning_tpu.ops.fused_conv_bwd_kernel import gmulti_pallas
from sevennet_finetuning_tpu.ops.fused_conv_multi import (
    cg_node_multi as j_cg_node_multi)
from sevennet_finetuning_tpu.ops.tensor_product import (
    uvu_tp_spec as j_uvu_tp_spec)
from sevennet_finetuning_tpu_torch.irreps import Irreps
from sevennet_finetuning_tpu_torch.ops import cg_tables, scatter
from sevennet_finetuning_tpu_torch.ops.fused_conv import layout_from_spec
from sevennet_finetuning_tpu_torch.ops.fused_conv_agg import conv_aggregate
from sevennet_finetuning_tpu_torch.ops.fused_conv_multi import (
    CGNodeGAgg, CGNodeGMulti, CGNodeMulti, cg_node_gagg, cg_node_gmulti,
    cg_node_multi, gagg_plain, gmulti_plain)
from sevennet_finetuning_tpu_torch.ops.tensor_product import uvu_tp_spec

torch.set_num_threads(2)
RTOL = 2e-5
ROOT = Path(__file__).resolve().parent.parent
CKPT = ROOT / 'experiments/ft_reewc_900/conv_out/checkpoint_best.pth'

SMALL = ('4x0e+3x1e+2x2e', '1x0e+1x1e+1x2e', '4x0e+4x1e+4x2e')
TINY = ('1x0e+1x1e', '1x0e+1x1e', '1x0e+1x1e')

# CGNodeMulti.backward's shapes: pool [x, sh, w, ct_xn, ct_shn, ct_wn]
GAGG_TERMS = ((0, 1, 5), (0, 4, 2), (3, 1, 2))
GMULTI_JOBS = (('x', 1, 5, 'x'), ('x', 4, 2, 'x'), ('sh', 0, 5, 'sh'),
               ('sh', 3, 2, 'sh'), ('w', 0, 4, 'w'), ('w', 3, 1, 'w'))
GMULTI_GROUPS = ('x', 'sh', 'w')


def _layouts(irreps):
    a, b, c = irreps
    return (j_fc.layout_from_spec(j_uvu_tp_spec(JIrreps(a), JIrreps(b),
                                                JIrreps(c))),
            layout_from_spec(uvu_tp_spec(Irreps(a), Irreps(b), Irreps(c))))


@pytest.fixture(scope='module')
def interior():
    """SevenNet-0's interior convolution layout (block 1), both packages."""
    from sevennet_finetuning_tpu.model.build import (
        build_model_spec as j_build)
    from sevennet_finetuning_tpu.train.checkpoint import (
        load_checkpoint as j_load)
    from sevennet_finetuning_tpu_torch.model.build import build_model_spec
    from sevennet_finetuning_tpu_torch.train.checkpoint import (
        load_checkpoint)

    jl = j_fc.layout_from_spec(
        j_build(j_load(str(CKPT))['config']).blocks[1].conv_tp)
    tl = layout_from_spec(
        build_model_spec(load_checkpoint(str(CKPT))['config'])
        .blocks[1].conv_tp)
    return jl, tl


def _close(got, want, rtol=RTOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= rtol * scale, (err, scale)


def _pool_data(layout, E, N, seed, sentinel_from=None, dtype=np.float32):
    """ybar, the pool [x, sh, w, ct_x, ct_sh, ct_w] and an ascending dst
    whose tail from ``sentinel_from`` is the sentinel N."""
    rng = np.random.default_rng(seed)

    def f(*s):
        return rng.standard_normal(s).astype(dtype)

    dst = np.sort(rng.integers(0, N, E)).astype(np.int32)
    dst[E - 3 if sentinel_from is None else sentinel_from:] = N
    dims = (layout.dim_x, layout.dim_sh, layout.dim_w)
    pool = [f(E, d) for d in dims + dims]
    return f(N, layout.dim_msg), pool, dst


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


# ---------------------------------------------------------------------------
# plain versions against the Pallas kernels in interpret mode
# ---------------------------------------------------------------------------

# (E, first sentinel edge): two edge tiles, the second all sentinel
CASES = [(200, 128)]


@pytest.mark.parametrize('E,sent', CASES)
def test_gagg_pallas_interpret_matches_port(E, sent):
    jl, tl = _layouts(SMALL)
    N = 9
    _, pool, dst = _pool_data(tl, E, N, seed=1, sentinel_from=sent)
    want = gagg_pallas([jnp.asarray(p) for p in pool], jnp.asarray(dst),
                       layout=jl, terms=GAGG_TERMS, n_node=N,
                       interpret=True)
    _close(gagg_plain(_t(*pool), torch.from_numpy(dst), GAGG_TERMS, tl, N),
           want)


@pytest.mark.parametrize('E,sent', CASES)
def test_gmulti_pallas_interpret_matches_port(E, sent):
    jl, tl = _layouts(SMALL)
    N = 9
    ybar, pool, dst = _pool_data(tl, E, N, seed=2, sentinel_from=sent)
    want = gmulti_pallas(jnp.asarray(ybar), [jnp.asarray(p) for p in pool],
                         jnp.asarray(dst), layout=jl, jobs=GMULTI_JOBS,
                         groups=GMULTI_GROUPS, n_node=N, interpret=True)
    got = gmulti_plain(torch.from_numpy(ybar), _t(*pool),
                       torch.from_numpy(dst), GMULTI_JOBS, GMULTI_GROUPS, tl,
                       N)
    for g, w in zip(got, want):
        _close(g, w)
    assert float(np.abs(np.asarray(want[1])[sent:]).max()) == 0.0


def test_sevennet0_interior_pallas_interpret_matches_port(interior):
    jl, tl = interior
    N = 3
    ybar, pool, dst = _pool_data(tl, 12, N, seed=3, sentinel_from=9)
    jpool = [jnp.asarray(p) for p in pool]
    want = gagg_pallas(jpool, jnp.asarray(dst), layout=jl,
                       terms=GAGG_TERMS, n_node=N, interpret=True)
    _close(gagg_plain(_t(*pool), torch.from_numpy(dst), GAGG_TERMS, tl, N),
           want)
    want = gmulti_pallas(jnp.asarray(ybar), jpool, jnp.asarray(dst),
                         layout=jl, jobs=GMULTI_JOBS, groups=GMULTI_GROUPS,
                         n_node=N, interpret=True)
    got = gmulti_plain(torch.from_numpy(ybar), _t(*pool),
                       torch.from_numpy(dst), GMULTI_JOBS, GMULTI_GROUPS, tl,
                       N)
    for g, w in zip(got, want):
        _close(g, w)


# ---------------------------------------------------------------------------
# the kernels' term tables, walked on the CPU the way the kernels walk them
# ---------------------------------------------------------------------------

def _term_values(rows, terms):
    a, b, c = terms[:, 0], terms[:, 1], terms[:, 2]
    coef = terms[:, 3].copy().view(np.float32).astype(np.float64)
    return coef * rows[:, a] * rows[:, b] * rows[:, c]     # [E, T]


def _segment_sums(vals, start):
    """[E, T] term values -> [E, n_seg] sums of each CSR segment."""
    seg_of_term = np.repeat(np.arange(len(start) - 1), np.diff(start))
    out = np.zeros((vals.shape[0], len(start) - 1))
    np.add.at(out, (slice(None), seg_of_term), vals)
    return out


def eval_gagg_table(layout, pool, dst, terms, n_node):
    """cg_gagg.cu: per node, per (column, term) its entries over the
    node's edges in order; then the terms added left to right."""
    pool_dims = tuple(p.shape[1] for p in pool)
    start, entries = cg_tables.gagg_table(layout, terms, pool_dims)
    rows = np.concatenate(pool, axis=1).astype(np.float64)
    per = _segment_sums(_term_values(rows, entries[:start[-1]]), start)
    per = per.reshape(len(dst), layout.dim_msg, len(terms))
    out = np.zeros((n_node, layout.dim_msg))
    offs = np.searchsorted(dst, np.arange(n_node + 1))
    for n in range(n_node):
        acc = per[offs[n]:offs[n + 1]].sum(axis=0)      # [dim_msg, T]
        out[n] = acc.sum(axis=1)
    return out


def eval_gmulti_table(layout, ybar, pool, dst, jobs, groups, n_node):
    """cg_gmulti.cu: per edge, items (segment sums added in job order, or
    shn chunks), then the ordered reduction of each shn column."""
    pool_dims = tuple(p.shape[1] for p in pool)
    gidx = {g: i for i, g in enumerate(groups)}
    tab = cg_tables.gmulti_table(
        layout, tuple((m, b, c, gidx[g]) for m, b, c, g in jobs),
        len(groups), pool_dims)
    g = np.where((dst < n_node)[:, None],
                 ybar[np.minimum(dst, n_node - 1)], 0.0)
    rows = np.concatenate([g, *pool], axis=1).astype(np.float64)
    segs = _segment_sums(_term_values(rows, tab.terms[:tab.seg_start[-1]]),
                         tab.seg_start)
    items = np.stack([segs[:, tab.item_seg[i]:tab.item_seg[i + 1]].sum(1)
                      for i in range(len(tab.item_out))], axis=1)
    out = np.full((len(dst), sum(tab.out_dims)), np.nan)
    part = np.zeros((len(dst), max(tab.n_part, 1)))
    for it, o in enumerate(tab.item_out):
        if o >= 0:
            out[:, o] = items[:, it]
        else:
            part[:, -o - 1] = items[:, it]
    for q in range(len(tab.red_start) - 1):
        out[:, tab.red_out[q]] = part[:, tab.red_start[q]:
                                      tab.red_start[q + 1]].sum(axis=1)
    return np.split(out, np.cumsum(tab.out_dims)[:-1], axis=1)


@pytest.mark.parametrize('name', ['small', 'tiny'])
def test_gagg_gmulti_tables_match_plain(name):
    _, tl = _layouts({'small': SMALL, 'tiny': TINY}[name])
    N = 7
    ybar, pool, dst = _pool_data(tl, 29, N, seed=4)
    tdst = torch.from_numpy(dst)
    want = gagg_plain(_t(*pool), tdst, GAGG_TERMS, tl, N)
    _close(eval_gagg_table(tl, pool, dst, GAGG_TERMS, N), want.numpy())
    # a lone group, a group of one job, and the six-job backward
    for jobs, groups in ((GMULTI_JOBS, GMULTI_GROUPS),
                         ((('w', 3, 1, 'w'),), ('w',)),
                         ((('sh', 0, 5, 'a'), ('x', 1, 2, 'b'),
                           ('sh', 3, 2, 'a')), ('b', 'a'))):
        want = gmulti_plain(torch.from_numpy(ybar), _t(*pool), tdst, jobs,
                            groups, tl, N)
        got = eval_gmulti_table(tl, ybar, pool, dst, jobs, groups, N)
        for g, w in zip(got, want):
            _close(g, w.numpy())
            assert np.all(g[-3:] == 0.0)         # sentinel edges


def test_sevennet0_interior_tables_match_plain(interior):
    _, tl = interior
    N = 3
    ybar, pool, dst = _pool_data(tl, 8, N, seed=5)
    tdst = torch.from_numpy(dst)
    want = gagg_plain(_t(*pool), tdst, GAGG_TERMS, tl, N)
    _close(eval_gagg_table(tl, pool, dst, GAGG_TERMS, N), want.numpy())
    want = gmulti_plain(torch.from_numpy(ybar), _t(*pool), tdst,
                        GMULTI_JOBS, GMULTI_GROUPS, tl, N)
    got = eval_gmulti_table(tl, ybar, pool, dst, GMULTI_JOBS, GMULTI_GROUPS,
                            N)
    for g, w in zip(got, want):
        _close(g, w.numpy())
    tab = cg_tables.gmulti_table(
        tl, tuple((m, b, c, GMULTI_GROUPS.index(g))
                  for m, b, c, g in GMULTI_JOBS), 3,
        tuple(p.shape[1] for p in pool))
    assert np.diff(tab.seg_start).max() <= max(
        cg_tables.SH_CHUNK, np.diff(cg_tables.multi_table(
            tl, ('xn', 'wn')).item_start).max())
    # the shared-memory row of an interior block: g + two pool copies
    assert tl.dim_msg + sum(p.shape[1] for p in pool) == 6034


# ---------------------------------------------------------------------------
# autograd against JAX
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('live', [(0, 1, 2), (0, 2), (1,)])
@pytest.mark.parametrize('const', [(), ('sh',)])
def test_cg_node_multi_backward_matches_jax_vjp(live, const):
    """``live``: which job outputs get a cotangent; ``const``: inputs
    that need no gradient."""
    jl, tl = _layouts(SMALL)
    N = 6
    ybar, pool, dst = _pool_data(tl, 23, N, seed=6)
    x, sh, w, cx, cs, cw = pool
    jobs = ('xn', 'shn', 'wn')
    names = ('ybar', 'x', 'sh', 'w')
    arrays = dict(zip(names, (ybar, x, sh, w)))
    var = [n for n in names if n not in const]

    def f(*vs):
        a = dict(arrays, **dict(zip(var, vs)))
        return j_cg_node_multi(*(jnp.asarray(a[n]) for n in names),
                               jnp.asarray(dst), jobs=jobs, layout=jl,
                               n_node=N)

    outs, vjp = jax.vjp(f, *(jnp.asarray(arrays[n]) for n in var))
    cts = [cx, cs, cw]
    j_cts = [jnp.asarray(c) if i in live else jnp.zeros_like(o)
             for i, (c, o) in enumerate(zip(cts, outs))]
    want = vjp(j_cts)

    t_in = {n: torch.from_numpy(arrays[n]).requires_grad_(n in var)
            for n in names}
    got_outs = cg_node_multi(*(t_in[n] for n in names),
                             torch.from_numpy(dst), jobs=jobs, layout=tl,
                             n_node=N)
    for g, o in zip(got_outs, outs):
        _close(g, o)
    used = [got_outs[i] for i in live]
    got = torch.autograd.grad(used, [t_in[n] for n in var],
                              [torch.from_numpy(cts[i]) for i in live],
                              allow_unused=True)
    for n, g, wnt in zip(var, got, want):
        if g is None:          # no live job reads this input
            assert float(np.abs(np.asarray(wnt)).max()) == 0.0, n
        else:
            _close(g, wnt)


def test_conv_aggregate_grad_of_grad_matches_jax():
    """The train step's pattern: a first derivative kept in the graph
    (create_graph=True), then a backward of a loss on it."""
    jl, tl = _layouts(SMALL)
    N = 7
    _, pool, dst = _pool_data(tl, 31, N, seed=7)
    x, sh, w, rx, rs, rw = pool
    c = np.random.default_rng(8).standard_normal(
        (N, tl.dim_msg)).astype(np.float32)

    def j_outer(x, sh, w):
        inner = jax.grad(
            lambda x, sh, w: jnp.sum(j_cg_node_apply(
                'agg', x, sh, w, jnp.asarray(dst), jl, N) * c),
            argnums=(0, 1, 2))(x, sh, w)
        return sum(jnp.sum(g * jnp.asarray(r) ** 2)
                   for g, r in zip(inner, (rx, rs, rw)))

    want = jax.grad(j_outer, argnums=(0, 1, 2))(
        *(jnp.asarray(a) for a in (x, sh, w)))

    ins = [torch.from_numpy(a).requires_grad_(True) for a in (x, sh, w)]
    out = conv_aggregate(tl, *ins, torch.from_numpy(dst), N)
    inner = torch.autograd.grad((out * torch.from_numpy(c)).sum(), ins,
                                create_graph=True)
    outer = sum((g * torch.from_numpy(r) ** 2).sum()
                for g, r in zip(inner, (rx, rs, rw)))
    got = torch.autograd.grad(outer, ins)
    for g, wnt in zip(got, want):
        _close(g, wnt)


def test_double_backward_records_only_the_family():
    """The force pass records one CGNodeMulti per convolution, and its
    backward (the outer loss's) one gagg and one gmulti."""
    _, tl = _layouts(SMALL)
    N = 5
    _, pool, dst = _pool_data(tl, 17, N, seed=9)
    ins = [torch.from_numpy(a).requires_grad_(True) for a in pool[:3]]
    out = conv_aggregate(tl, *ins, torch.from_numpy(dst), N)
    inner = torch.autograd.grad(out.pow(2).sum(), ins, create_graph=True)
    names = {type(g.grad_fn).__name__ for g in inner}
    assert names == {'CGNodeMultiBackward'}, names

    calls = []
    orig = {cls: cls.forward for cls in (CGNodeGAgg, CGNodeGMulti)}

    def spy(cls):
        def fwd(ctx, *args):
            calls.append(cls.__name__)
            return orig[cls](ctx, *args)
        return staticmethod(fwd)

    for cls in orig:
        cls.forward = spy(cls)
    try:
        sum(g.pow(2).sum() for g in inner).backward()
    finally:
        for cls, f in orig.items():
            cls.forward = staticmethod(f)
    assert sorted(calls) == ['CGNodeGAgg', 'CGNodeGMulti']


# ---------------------------------------------------------------------------
# third order: gradgradcheck in float64
# ---------------------------------------------------------------------------

def _ggc(fn, inputs):
    """gradgradcheck in fast mode (random projections of the Jacobians)."""
    return torch.autograd.gradgradcheck(fn, inputs, fast_mode=True)


def _tiny64(seed, E=5, N=3):
    _, tl = _layouts(TINY)
    ybar, pool, dst = _pool_data(tl, E, N, seed, sentinel_from=E - 1,
                                 dtype=np.float64)
    leaf = [torch.from_numpy(a).requires_grad_(True) for a in [ybar] + pool]
    return tl, leaf, torch.from_numpy(dst), N


def test_gradgradcheck_cg_node_multi():
    tl, (ybar, x, sh, w, *_), dst, N = _tiny64(10)
    assert _ggc(
        lambda y, a, b, c: cg_node_multi(y, a, b, c, dst,
                                         jobs=('xn', 'shn', 'wn'),
                                         layout=tl, n_node=N),
        (ybar, x, sh, w))


def test_gradgradcheck_cg_node_gagg():
    tl, (_, x, sh, w, cx, _, cw), dst, N = _tiny64(11)
    assert _ggc(
        lambda *p: cg_node_gagg(list(p), dst, terms=((0, 1, 4), (3, 1, 2)),
                                layout=tl, n_node=N),
        (x, sh, w, cx, cw))


def test_gradgradcheck_cg_node_gmulti():
    tl, (ybar, x, sh, w, cx, *_), dst, N = _tiny64(12)
    jobs = (('x', 1, 2, 'gx'), ('w', 3, 1, 'gw'), ('x', 1, 2, 'gx'))
    assert _ggc(
        lambda y, *p: cg_node_gmulti(y, list(p), dst, jobs=jobs,
                                     groups=('gx', 'gw'), layout=tl,
                                     n_node=N),
        (ybar, x, sh, w, cx))


def test_gradgradcheck_scatter_family():
    rng = np.random.default_rng(13)
    E, N, D = 9, 4, 2
    dst = np.sort(rng.integers(0, N, E)).astype(np.int32)
    dst[-2:] = N
    src = rng.integers(0, N, E).astype(np.int32)
    src[-2:] = N
    perm_np = np.argsort(src, kind='stable').astype(np.int32)
    perm = torch.from_numpy(perm_np)
    inv = torch.from_numpy(np.argsort(perm_np).astype(np.int32))
    msg = torch.from_numpy(rng.normal(size=(E, D))).requires_grad_(True)
    x = torch.from_numpy(rng.normal(size=(N, D))).requires_grad_(True)
    tdst, tsrc = torch.from_numpy(dst), torch.from_numpy(src)
    assert _ggc(
        lambda m: scatter.segment_sum_sorted(m, tdst, N) ** 2, (msg,))
    assert _ggc(
        lambda m: scatter.scatter_rows(m, tsrc, N, perm, inv) ** 2, (msg,))
    assert _ggc(
        lambda v: scatter.gather_rows(v, tsrc, perm, inv) ** 2, (x,))
    # the backwards call only Functions of the family
    y = scatter.segment_sum_sorted(msg, tdst, N)
    g, = torch.autograd.grad(y.pow(2).sum(), msg, create_graph=True)
    assert type(g.grad_fn).__name__ == 'GatherZeroOOBBackward'
    z = scatter.gather_rows(x, tsrc, perm, inv)
    g, = torch.autograd.grad(z.pow(2).sum(), x, create_graph=True)
    assert type(g.grad_fn).__name__ == 'SegmentSumSortedBackward'
