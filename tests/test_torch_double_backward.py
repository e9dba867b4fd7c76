"""The double backward of the port's convolution against the JAX package.

- ``gagg_plain`` and ``gmulti_plain`` against the Pallas kernels
  ``gagg_pallas`` / ``gmulti_pallas`` in interpret mode, on a small layout
  and on SevenNet-0's interior layout (block 1 of the in-repo checkpoint)
  with few edges, including sentinel edges and an all-sentinel edge tile
  (the Pallas kernels' edge tile is 128);
- float32 numpy walks of ``csrc/cg_gagg.cu`` (its units and lane
  couplings, ``gagg_plan``) and ``csrc/cg_gmulti.cu`` (the path-level
  coupling list ``gmulti_plan`` and the passes ``gmulti_passes``, also
  as the one-slot build that computes ``CGNodeMulti``'s first-order
  jobs), in the kernels' order, against the plain versions and the
  Pallas kernels in interpret mode (``gagg_pallas``, ``multi_pallas``),
  for every job set a third order asks for;
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
from sevennet_finetuning_tpu.ops.fused_conv_bwd_kernel import (
    gmulti_pallas, multi_pallas)
from sevennet_finetuning_tpu.ops.fused_conv_multi import (
    cg_node_multi as j_cg_node_multi)
from sevennet_finetuning_tpu.ops.tensor_product import (
    uvu_tp_spec as j_uvu_tp_spec)
from sevennet_finetuning_tpu_torch.irreps import Irreps
from sevennet_finetuning_tpu_torch.ops import cg_tables, scatter
from sevennet_finetuning_tpu_torch.ops import fused_conv_multi as fcm
from sevennet_finetuning_tpu_torch.ops.fused_conv import layout_from_spec
from sevennet_finetuning_tpu_torch.ops.fused_conv_agg import conv_aggregate
from sevennet_finetuning_tpu_torch.ops.fused_conv_multi import (
    EDGES_PER_BLOCK, CGNodeGAgg, CGNodeGMulti, CGNodeMulti, cg_node_gagg,
    cg_node_gmulti, cg_node_multi, gagg_plain, gmulti_plain, multi_jobs,
    multi_plain)
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
# the train step's outer backward without its sh group (chip_smoke.py)
GMULTI_NO_SH = (tuple(j for j in GMULTI_JOBS if j[3] != 'sh'), ('x', 'w'))


def _layouts(irreps):
    a, b, c = irreps
    return (j_fc.layout_from_spec(j_uvu_tp_spec(JIrreps(a), JIrreps(b),
                                                JIrreps(c))),
            layout_from_spec(uvu_tp_spec(Irreps(a), Irreps(b), Irreps(c))))


@pytest.fixture(scope='module')
def sevennet0():
    """SevenNet-0's convolution layouts at blocks 0, 1 (interior) and 4,
    both packages: {block: (JAX layout, port layout)}."""
    from sevennet_finetuning_tpu.model.build import (
        build_model_spec as j_build)
    from sevennet_finetuning_tpu.train.checkpoint import (
        load_checkpoint as j_load)
    from sevennet_finetuning_tpu_torch.model.build import build_model_spec
    from sevennet_finetuning_tpu_torch.train.checkpoint import (
        load_checkpoint)

    j_spec = j_build(j_load(str(CKPT))['config'])
    t_spec = build_model_spec(load_checkpoint(str(CKPT))['config'])
    return {b: (j_fc.layout_from_spec(j_spec.blocks[b].conv_tp),
                layout_from_spec(t_spec.blocks[b].conv_tp))
            for b in (0, 1, 4)}


@pytest.fixture(scope='module')
def interior(sevennet0):
    """SevenNet-0's interior convolution layout (block 1), both packages."""
    return sevennet0[1]


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


F32 = np.float32


def walk_gagg_plan(layout, pool, dst, terms, n_node, writes=None):
    """cg_gagg.cu in numpy, float32, in the kernel's order: per unit (a
    path and a 32-channel slice of its x chunk) and term, each edge's
    message -- lane k * d1 + i forms B[k][i] = sum c * S[j] from its
    coupling steps, then m[k] = W * sum_i X[i] * B[k][i] -- summed over
    each node's edges in order, then the terms added left to right and
    each lane's columns written.  ``writes`` ([n_node, dim_msg] ints)
    counts the writes of every output element."""
    plan = cg_tables.gagg_plan(layout)
    coef = plan.couplings[:, 1].copy().view(np.float32)
    jj = plan.couplings[:, 0]
    pool = [p.astype(F32) for p in pool]
    out = np.full((n_node, layout.dim_msg), np.nan, F32)
    offs = np.searchsorted(dst, np.arange(n_node + 1))
    deg = np.diff(offs)
    lanes = np.arange(cg_tables.WARP)
    for (x_off, d1, mul, u0, sh_off, d2, msg_off, w_off, d3, first, steps,
         _) in plan.units:
        width = -(-d1 * d3 // cg_tables.WARP) * cg_tables.WARP
        blk = slice(first, first + steps * width)
        bj = jj[blk].reshape(steps, width)
        bc = coef[blk].reshape(steps, width)
        u = u0 + lanes
        act = u < mul
        uc = np.where(act, u, mul - 1)
        msgs = []
        for (xi, si, wi) in terms:
            s = pool[si][:, sh_off:sh_off + d2]
            b = np.zeros((len(dst), width), F32)
            for st in range(steps):
                b = b + bc[st] * s[:, bj[st]]
            xv = [pool[xi][:, x_off + i * mul + uc] for i in range(d1)]
            wv = pool[wi][:, w_off + uc]
            m = np.zeros((len(dst), d3, cg_tables.WARP), F32)
            for k in range(d3):
                mk = np.zeros((len(dst), cg_tables.WARP), F32)
                for i in range(d1):
                    mk = mk + b[:, k * d1 + i, None] * xv[i]
                m[:, k] = wv * mk
            msgs.append(m)
        accs = [np.zeros((n_node, d3, cg_tables.WARP), F32) for _ in terms]
        for p in range(deg.max(initial=0)):
            has = deg > p
            for acc, m in zip(accs, msgs):
                acc[has] = acc[has] + m[offs[:-1][has] + p]
        total = accs[0]
        for acc in accs[1:]:
            total = total + acc
        for k in range(d3):
            cols = msg_off + k * mul + u[act]
            out[:, cols] = total[:, k][:, act]
            if writes is not None:
                writes[:, cols] += 1
    return out


F32 = np.float32


def _emit(out, slots, rows, cols, vals):
    """cg_gmulti.cu's emit: each live slot's values written to (or, with
    ``add``, added to) its group; two slots of one group added in slot
    order.  ``slots``: (group, add) per slot, group -1 where unused."""
    (o0, add0), (o1, add1) = slots
    if o0 >= 0 and o0 == o1:
        v = out[o0][rows, cols] + vals[0] if add0 else vals[0]
        out[o0][rows, cols] = v + vals[1]
        return
    for (o, add), v in zip(slots, vals):
        if o >= 0:
            out[o][rows, cols] = out[o][rows, cols] + v if add else v


def eval_gmulti_plan(layout, ybar, pool, dst, jobs, groups, n_node,
                     one_slot=False):
    """cg_gmulti.cu in numpy, float32, in the kernel's order: per pass and
    per 32-channel slice of each chunk, per path A[i][j] = sum of c *
    g[k, u] over its coupling list, the jobs' contractions of A (slot s of
    x reads legs S[s], W[s]; of sh X[s], W[s]; of w X[s], S[1 - s]), each
    sh column's xor butterfly over the slice's lanes, and after the tile
    the slices added in order.  ``one_slot``: the build for one slot
    (``cg_multi``), whose w slot reads S[0] (S1 folded in), whose x and
    sh jobs contract A[i][j] = sum of c * (g[k, u] * W[u]) and add each
    path's part, and whose w job adds X[i] * S[j] * sum of c * g[k, u]
    for each (i, j)."""
    gidx = {g: i for i, g in enumerate(groups)}
    norm = tuple((m, b, c, gidx[g]) for m, b, c, g in jobs)
    plan = cg_tables.gmulti_plan(layout, EDGES_PER_BLOCK)
    passes = cg_tables.gmulti_passes(norm, len(groups))
    E = len(dst)
    g = np.where((dst < n_node)[:, None],
                 ybar[np.minimum(dst, n_node - 1)], 0.0).astype(F32)
    pool = [p.astype(F32) for p in pool]
    outs = [np.full((E, d), np.nan, F32)
            for d in cg_tables.gmulti_out_dims(layout, norm, len(groups))]
    coef = plan.couplings[:, 1].copy().view(np.float32)
    koff = plan.couplings[:, 0]
    lanes = np.arange(cg_tables.WARP)
    rows = np.arange(E)[:, None]
    zero = np.zeros((E, 32), F32)
    for ps in passes:
        X, S, W = ps[0:2], ps[2:4].copy(), ps[4:6]
        if one_slot:
            S[0] = S[0] if S[0] >= 0 else S[1]
        ws = (lambda s: 0) if one_slot else (lambda s: 1 - s)
        slots = {m: [(int(ps[6 + (q * 2 + s) * 2]),
                      int(ps[7 + (q * 2 + s) * 2])) for s in range(2)]
                 for q, m in enumerate(cg_tables.GMULTI_MODES)}
        on = {m: [grp >= 0 for grp, _ in slots[m]] for m in slots}
        red = np.zeros((E, plan.n_slice, 2, layout.dim_sh), F32)
        for (x_off, d1, mul, gb, ge, slice0) in plan.chunks:
            for sl in range(-(-mul // cg_tables.WARP)):
                u = sl * cg_tables.WARP + lanes
                act = u < mul
                uc = np.where(act, u, mul - 1)
                xcol = [x_off + i * mul + uc for i in range(d1)]
                xs = [[np.where(act, pool[X[s]][:, c], F32(0))
                       if on['sh'][s] or on['w'][s] else zero
                       for c in xcol] for s in range(2)]
                accx = [[zero] * d1 for _ in range(2)]
                for (sh_off, d2, pb, pe) in plan.groups[gb:ge]:
                    sv = [pool[S[s]][:, sh_off:sh_off + d2, None]
                          if on['x'][s] or on['w'][ws(s)]
                          else np.zeros((E, d2, 1), F32) for s in range(2)]
                    acc_sh = [[zero] * d2 for _ in range(2)]
                    for (msg_off, w_off, pair, _) in plan.paths[pb:pe]:
                        wcol = w_off + uc
                        wv = [np.where(act, pool[W[s]][:, wcol], F32(0))
                              if on['x'][s] or on['sh'][s] else zero
                              for s in range(2)]
                        seg = plan.pair_start[pair:pair + d1 * d2 + 1]
                        A = [[zero] * d2 for _ in range(d1)]
                        wo = [zero, zero]
                        for i in range(d1):
                            for j in range(d2):
                                ag = zero
                                for q in range(seg[i * d2 + j],
                                               seg[i * d2 + j + 1]):
                                    gq = g[:, msg_off + koff[q] + uc]
                                    if not one_slot:
                                        A[i][j] = A[i][j] + coef[q] * gq
                                        continue
                                    A[i][j] = A[i][j] + coef[q] * (gq * wv[0])
                                    ag = ag + coef[q] * gq
                                if one_slot:
                                    wo[0] = wo[0] + (
                                        xs[0][i] * sv[0][:, j]) * ag
                        if one_slot:
                            for i in range(d1 if on['x'][0] else 0):
                                t = zero
                                for j in range(d2):
                                    t = t + sv[0][:, j] * A[i][j]
                                accx[0][i] = accx[0][i] + t
                            for j in range(d2 if on['sh'][0] else 0):
                                t = zero
                                for i in range(d1):
                                    t = t + xs[0][i] * A[i][j]
                                acc_sh[0][j] = acc_sh[0][j] + t
                        for s in range(0 if one_slot else 2):
                            if on['x'][s]:
                                for i in range(d1):
                                    t = zero
                                    for j in range(d2):
                                        t = t + sv[s][:, j] * A[i][j]
                                    accx[s][i] = accx[s][i] + wv[s] * t
                            if on['sh'][s]:
                                for j in range(d2):
                                    t = zero
                                    for i in range(d1):
                                        t = t + xs[s][i] * A[i][j]
                                    acc_sh[s][j] = acc_sh[s][j] + wv[s] * t
                            if on['w'][s]:
                                for i in range(d1):
                                    r = zero
                                    for j in range(d2):
                                        r = r + sv[ws(s)][:, j] * A[i][j]
                                    wo[s] = wo[s] + xs[s][i] * r
                        _emit(outs, slots['w'], rows, wcol[act],
                              [v[:, act] for v in wo])
                    for s in range(2):
                        for j in range(d2 if on['sh'][s] else 0):
                            v = acc_sh[s][j]
                            for off in (16, 8, 4, 2, 1):
                                v = v + v[:, lanes ^ off]
                            red[:, slice0 + sl, s, sh_off + j] = v[:, 0]
                for i in range(d1):
                    _emit(outs, slots['x'], rows, xcol[i][act],
                          [a[i][:, act] for a in accx])
        sums = []
        for s in range(2):
            p = np.zeros((E, layout.dim_sh), F32)
            for sl in range(plan.n_slice if on['sh'][s] else 0):
                p = p + red[:, sl, s]
            sums.append(p)
        _emit(outs, slots['sh'], rows, np.arange(layout.dim_sh)[None],
              sums)
    return outs


@pytest.mark.parametrize('name', ['small', 'tiny'])
def test_gagg_gmulti_tables_match_plain(name):
    _, tl = _layouts({'small': SMALL, 'tiny': TINY}[name])
    N = 7
    ybar, pool, dst = _pool_data(tl, 29, N, seed=4)
    tdst = torch.from_numpy(dst)
    want = gagg_plain(_t(*pool), tdst, GAGG_TERMS, tl, N)
    _close(walk_gagg_plan(tl, pool, dst, GAGG_TERMS, N), want.numpy())
    # a lone group, a group of one job, and the six-job backward
    for jobs, groups in ((GMULTI_JOBS, GMULTI_GROUPS),
                         ((('w', 3, 1, 'w'),), ('w',)),
                         ((('sh', 0, 5, 'a'), ('x', 1, 2, 'b'),
                           ('sh', 3, 2, 'a')), ('b', 'a'))):
        want = gmulti_plain(torch.from_numpy(ybar), _t(*pool), tdst, jobs,
                            groups, tl, N)
        got = eval_gmulti_plan(tl, ybar, pool, dst, jobs, groups, N)
        for g, w in zip(got, want):
            _close(g, w.numpy())
            assert np.all(g[-3:] == 0.0)         # sentinel edges


def test_sevennet0_interior_tables_match_plain(interior):
    _, tl = interior
    N = 3
    ybar, pool, dst = _pool_data(tl, 8, N, seed=5)
    tdst = torch.from_numpy(dst)
    want = gagg_plain(_t(*pool), tdst, GAGG_TERMS, tl, N)
    _close(walk_gagg_plan(tl, pool, dst, GAGG_TERMS, N), want.numpy())
    for jobs, groups in ((GMULTI_JOBS, GMULTI_GROUPS), GMULTI_NO_SH):
        want = gmulti_plain(torch.from_numpy(ybar), _t(*pool), tdst, jobs,
                            groups, tl, N)
        got = eval_gmulti_plan(tl, ybar, pool, dst, jobs, groups, N)
        for g, w in zip(got, want):
            _close(g, w.numpy())
            assert np.all(g[-3:] == 0.0)         # sentinel edges
    # one entry per path coupling, shared by the six jobs and the
    # channels: 137 against the 41,088 terms of a per-channel, per-job
    # table; the channels of x irreps 0e / 1 / 2 in 7 warp slices
    plan = cg_tables.gmulti_plan(tl, EDGES_PER_BLOCK)
    assert len(plan.couplings) == 137
    assert plan.n_slice == 7
    # chunks of three irrep dims: one edge a work unit
    assert len(plan.descs) == plan.n_slice * EDGES_PER_BLOCK
    assert sorted({(int(d[0]), int(d[3])) for d in plan.descs}) == [
        (0, EDGES_PER_BLOCK), (1, EDGES_PER_BLOCK), (2, EDGES_PER_BLOCK)]
    # one pass takes the six jobs
    norm = tuple((m, b, c, GMULTI_GROUPS.index(g))
                 for m, b, c, g in GMULTI_JOBS)
    assert len(cg_tables.gmulti_passes(norm, 3)) == 1


# gagg terms over the pool [x, sh, w, ct_x, ct_sh, ct_w]: one term; the
# three of CGNodeMulti.backward (pool leg 0 shared by two terms); six
GAGG_TERM_SETS = {1: ((0, 1, 2),), 3: GAGG_TERMS,
                  6: GAGG_TERMS + ((3, 4, 2), (0, 4, 5), (3, 1, 5))}


@pytest.mark.parametrize('n_terms', sorted(GAGG_TERM_SETS))
def test_gagg_plan_walk_matches_plain_and_pallas(n_terms):
    """The walk of cg_gagg.cu against gagg_plain and JAX gagg_pallas in
    interpret mode: node 2 has no edges (zeros), the last three edges are
    sentinels, and every output element is written once."""
    jl, tl = _layouts(SMALL)
    terms = GAGG_TERM_SETS[n_terms]
    N, E = 7, 29
    _, pool, dst = _pool_data(tl, E, N, seed=20 + n_terms)
    dst[:E - 3] = np.sort(np.random.default_rng(n_terms).choice(
        [0, 1, 3, 4, 5, 6], E - 3)).astype(np.int32)
    writes = np.zeros((N, tl.dim_msg), np.int64)
    got = walk_gagg_plan(tl, pool, dst, terms, N, writes)
    assert (writes == 1).all()
    assert np.all(got[2] == 0.0)
    want = gagg_plain(_t(*pool), torch.from_numpy(dst), terms, tl, N)
    _close(got, want.numpy())
    want = gagg_pallas([jnp.asarray(p) for p in pool], jnp.asarray(dst),
                       layout=jl, terms=terms, n_node=N, interpret=True)
    _close(got, want)


@pytest.mark.parametrize('name', ['small', 'tiny', 'sevennet0'])
def test_gagg_plan_writes_each_msg_column_once(name, sevennet0):
    """Per node, the units' lanes (a path's components k, a slice's
    active channels u) cover every msg column exactly once; each unit's
    coupling block holds every coupling of its path once, in the lane of
    its (k, i) segment; SevenNet-0's interior block has 30 units."""
    layouts = ({'small': [_layouts(SMALL)[1]], 'tiny': [_layouts(TINY)[1]]}
               .get(name) or [tl for _, tl in sevennet0.values()])
    for tl in layouts:
        plan = cg_tables.gagg_plan(tl)
        cover = np.zeros(tl.dim_msg, np.int64)
        coef = plan.couplings[:, 1].copy().view(np.float32)
        for (x_off, d1, mul, u0, sh_off, d2, msg_off, w_off, d3, first,
             steps, _) in plan.units:
            u = np.arange(u0, min(u0 + cg_tables.WARP, mul))
            for k in range(d3):
                cover[msg_off + k * mul + u] += 1
            path = next(p for g in tl.groups for p in g.paths
                        if (p.msg_off, g.x_off, g.sh_off) == (msg_off, x_off,
                                                              sh_off))
            assert (path.w_off, path.d_out) == (w_off, d3)
            width = -(-d1 * d3 // cg_tables.WARP) * cg_tables.WARP
            blk = slice(first, first + steps * width)
            got = sorted(
                (int(lane) // d1, int(lane) % d1, int(j), float(c))
                for st in range(steps)
                for lane, (j, c) in enumerate(zip(
                    plan.couplings[blk, 0].reshape(steps, width)[st],
                    coef[blk].reshape(steps, width)[st]))
                if c != 0.0)
            want = sorted((k, i, j, float(np.float32(c)))
                          for (k, i, j, c) in path.nnz if c != 0.0)
            assert got == want
        assert (cover == 1).all()
    if name == 'sevennet0':
        assert len(cg_tables.gagg_plan(sevennet0[1][1]).units) == 30


def walk_multi_plan(layout, jobs, ybar, x, sh, w, dst, n_node):
    """CGNodeMulti's jobs as multi_cuda launches them: one pass of
    cg_gmulti.cu over the pool [x, sh, w] (a job a group) that fills slot
    0 of its modes only, walked by eval_gmulti_plan as the kernel built
    for one slot."""
    gjobs = multi_jobs(jobs)
    passes = cg_tables.gmulti_passes(
        tuple((m, b, c, q) for q, (m, b, c, _) in enumerate(gjobs)),
        len(jobs))
    assert len(passes) == 1
    (ps,) = passes
    assert ps[1] == ps[5] == -1                      # X1, W1 unused
    assert -1 in (ps[2], ps[3]) or ps[2] == ps[3]    # S1 folds into S0
    slots = ps[6:].reshape(3, cg_tables.GMULTI_SLOTS, 2)
    assert (slots[:, 1, 0] == -1).all()              # no slot 1
    return eval_gmulti_plan(layout, ybar, [x, sh, w], dst, gjobs, jobs,
                            n_node, one_slot=True)


MULTI_JOB_SETS = (('xn', 'shn', 'wn'), ('shn', 'wn'), ('xn',), ('shn',),
                  ('wn',), ('xn', 'wn'))


@pytest.mark.parametrize('name', ['small', 'tiny', 0, 1, 4])
def test_multi_plan_walk_matches_plain_and_pallas(name, sevennet0):
    """Every job set of the first-order backward (the train step's and
    serving's (xn, shn, wn) and block 0's (shn, wn), each single job,
    xn + wn) through the one-pass walk, against multi_plain and JAX
    multi_pallas in interpret mode, at the narrow layouts and SevenNet-0's
    blocks 0, 1 and 4; sentinel edges get zero cotangents."""
    jl, tl = (sevennet0[name] if isinstance(name, int)
              else _layouts({'small': SMALL, 'tiny': TINY}[name]))
    N, E = (3, 7) if isinstance(name, int) else (7, 23)
    ybar, pool, dst = _pool_data(tl, E, N, seed=30)
    x, sh, w = pool[:3]
    full = ('xn', 'shn', 'wn')
    ref = dict(zip(full, multi_pallas(
        jnp.asarray(ybar), jnp.asarray(x), jnp.asarray(sh), jnp.asarray(w),
        jnp.asarray(dst), layout=jl, jobs=full, n_node=N, interpret=True)))
    for jobs in MULTI_JOB_SETS:
        got = walk_multi_plan(tl, jobs, ybar, x, sh, w, dst, N)
        want = multi_plain(torch.from_numpy(ybar), *_t(x, sh, w),
                           torch.from_numpy(dst), jobs, tl, N)
        for j, g, wp in zip(jobs, got, want):
            _close(g, wp.numpy())
            _close(g, ref[j])
            assert np.all(g[-3:] == 0.0)             # sentinel edges


def test_gmulti_plan_phases_follow_the_measured_rule():
    """Chunks of one irrep dim (SevenNet-0's block 0: 128 scalars) take
    GMULTI_PHASES_ONE_DIM phases, chunks of several dims one edge a work
    unit; an explicit count is taken as given, and a count the tile
    cannot split into raises."""
    _, one = _layouts(('40x0e', '1x0e+1x1e+1x2e', '40x0e+40x1e+40x2e'))
    _, several = _layouts(SMALL)
    for layout, want in ((one, cg_tables.GMULTI_PHASES_ONE_DIM),
                         (several, EDGES_PER_BLOCK)):
        plan = cg_tables.gmulti_plan(layout, EDGES_PER_BLOCK)
        assert set(plan.descs[:, 3].tolist()) == {want}
        assert len(plan.descs) == plan.n_slice * want
    plan = cg_tables.gmulti_plan(one, EDGES_PER_BLOCK, 4)
    assert len(plan.descs) == plan.n_slice * 4
    with pytest.raises(ValueError):
        cg_tables.gmulti_plan(one, EDGES_PER_BLOCK, EDGES_PER_BLOCK + 1)


def test_gmulti_term_count_pins_the_interior_block(interior):
    """chip_smoke.py's cg_gmulti bound counts the function's scalar
    couplings (one per path coupling and channel) times jobs."""
    _, tl = interior
    assert cg_tables.gmulti_term_count(tl, len(GMULTI_JOBS)) == 41088
    assert cg_tables.gmulti_term_count(tl, len(GMULTI_NO_SH[0])) == 27392


def test_third_order_job_sets_walk_matches_plain(monkeypatch):
    """Every gmulti job set a third-order derivative of conv_aggregate asks
    for (CGNodeMulti.backward's six jobs, then CGNodeGAgg.backward's and
    CGNodeGMulti.backward's), recorded on the CPU, through the plan walk
    -- passes of more than two jobs of an emit mode included."""
    _, tl = _layouts(SMALL)
    N = 5
    ybar, pool, dst = _pool_data(tl, 19, N, seed=14)
    calls = []
    orig = fcm.gmulti_plain

    def spy(ybar, pool, dst, jobs, groups, layout, n_node):
        calls.append((jobs, groups, tuple(int(p.shape[1]) for p in pool)))
        return orig(ybar, pool, dst, jobs, groups, layout, n_node)

    monkeypatch.setattr(fcm, 'gmulti_plain', spy)
    ins = [torch.from_numpy(a).requires_grad_(True) for a in pool[:3]]
    tdst = torch.from_numpy(dst)
    out = conv_aggregate(tl, *ins, tdst, N)
    # the cotangent 2 * out depends on the inputs: the second order
    # records CGNodeGAgg too
    inner = torch.autograd.grad(out.pow(2).sum(), ins, create_graph=True)
    second = torch.autograd.grad(
        sum((g * torch.from_numpy(r)).sum()
            for g, r in zip(inner, pool[3:])), ins, create_graph=True)
    torch.autograd.grad(sum(g.pow(2).sum() for g in second), ins)
    monkeypatch.undo()
    assert len(calls) >= 3
    # CGNodeGAgg.backward of GAGG_TERMS with every pool leg live: three
    # jobs of each emit mode, more than one pass
    widths = tuple(p.shape[1] for p in pool)
    calls.append((tuple((leg, idx[b], idx[c], idx[leg])
                        for term in GAGG_TERMS
                        for idx in [dict(zip(('x', 'sh', 'w'), term))]
                        for leg, (b, c) in (('x', ('sh', 'w')),
                                            ('sh', ('x', 'w')),
                                            ('w', ('x', 'sh')))),
                  tuple(sorted({i for t in GAGG_TERMS for i in t})), widths))
    n_passes = []
    rng = np.random.default_rng(15)
    for jobs, groups, widths in calls:
        gidx = {g: i for i, g in enumerate(groups)}
        passes = cg_tables.gmulti_passes(
            tuple((m, b, c, gidx[g]) for m, b, c, g in jobs), len(groups))
        assert passes.shape[1:] == (cg_tables.PASS_LEN,)
        n_passes.append(len(passes))
        cpool = [rng.standard_normal((len(dst), d)).astype(np.float32)
                 for d in widths]
        yb = rng.standard_normal((N, tl.dim_msg)).astype(np.float32)
        want = gmulti_plain(torch.from_numpy(yb), _t(*cpool), tdst, jobs,
                            groups, tl, N)
        got = eval_gmulti_plan(tl, yb, cpool, dst, jobs, groups, N)
        for g, w in zip(got, want):
            _close(g, w.numpy())
    assert n_passes[-1] >= 2


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
