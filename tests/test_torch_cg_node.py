"""The cg_node family of the port against the JAX package.

- the port's ``CGLayout`` equals JAX ``layout_from_spec`` field by field
  for the three SevenNet-0 conv layouts;
- plain agg / xn / shn / wn and ``CGNodeAgg``'s value and first-order
  gradients against JAX ``cg_node_apply`` and ``jax.vjp``;
- the JAX Pallas kernels in interpret mode (``agg_pallas``,
  ``multi_pallas``, ``segment_sum_sorted``) at small E against the port's
  plain versions;
- a CPU evaluator of the host-built term tables that drive the CUDA
  kernels (``ops/cg_tables.py``), walked the way the kernels walk them,
  against the plain versions -- so a table bug shows here, before the
  card;
- sentinel destinations (padded edges, dst = n_node) throughout.

Tolerance: 2e-5 relative to the largest magnitude of the reference
(float32 sums of up to a few thousand terms in another order).
"""

import dataclasses
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sevennet_finetuning_tpu.irreps import Irreps as JIrreps
from sevennet_finetuning_tpu.ops import fused_conv as j_fc
from sevennet_finetuning_tpu.ops.fused_conv_agg import cg_node_apply
from sevennet_finetuning_tpu.ops.fused_conv_agg_kernel import agg_pallas
from sevennet_finetuning_tpu.ops.fused_conv_bwd_kernel import multi_pallas
from sevennet_finetuning_tpu.ops.pallas_scatter import (
    segment_sum_sorted as j_segment_sum_sorted)
from sevennet_finetuning_tpu.ops.tensor_product import (
    uvu_tp_spec as j_uvu_tp_spec)
from sevennet_finetuning_tpu_torch.irreps import Irreps
from sevennet_finetuning_tpu_torch.ops import cg_tables, scatter
from sevennet_finetuning_tpu_torch.ops.fused_conv import (
    e3nn_to_stride, layout_from_spec, stride_to_e3nn)
from sevennet_finetuning_tpu_torch.ops.fused_conv_agg import (
    agg_plain, conv_aggregate, node_mode_plain)
from sevennet_finetuning_tpu_torch.ops.fused_conv_multi import (
    cg_node_multi, multi_plain)
from sevennet_finetuning_tpu_torch.ops.tensor_product import uvu_tp_spec

torch.set_num_threads(2)
RTOL = 2e-5
ROOT = Path(__file__).resolve().parent.parent
CKPT = ROOT / 'experiments/ft_reewc_900/conv_out/checkpoint_best.pth'

SMALL = ('4x0e+3x1e+2x2e', '1x0e+1x1e+1x2e', '4x0e+4x1e+4x2e')
SEVENNET_LIKE = ('16x0e+8x1e+4x2e', '1x0e+1x1e+1x2e', '16x0e+16x1e+16x2e')
SCALAR_IN = ('8x0e', '1x0e+1x1e+1x2e', '8x0e+8x1e+8x2e')
LAYOUTS = {'small': SMALL, 'sevennet_like': SEVENNET_LIKE,
           'scalar_in': SCALAR_IN}


def _specs(irreps):
    a, b, c = irreps
    return (j_uvu_tp_spec(JIrreps(a), JIrreps(b), JIrreps(c)),
            uvu_tp_spec(Irreps(a), Irreps(b), Irreps(c)))


def _close(got, want, rtol=RTOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= rtol * scale, (err, scale)


def _data(layout, E, N, seed=0, sentinel_tail=3):
    rng = np.random.default_rng(seed)

    def f(*s):
        return rng.standard_normal(s).astype(np.float32)

    dst = np.sort(rng.integers(0, N, E)).astype(np.int32)
    if sentinel_tail:
        dst[-sentinel_tail:] = N
    return dict(x=f(E, layout.dim_x), sh=f(E, layout.dim_sh),
                w=f(E, layout.dim_w), ybar=f(N, layout.dim_msg), dst=dst)


def _t(d):
    return {k: torch.from_numpy(v) for k, v in d.items()}


def _j(d):
    return {k: jnp.asarray(v) for k, v in d.items()}


# ---------------------------------------------------------------------------
# layouts
# ---------------------------------------------------------------------------

@pytest.fixture(scope='module')
def sevennet_specs():
    from sevennet_finetuning_tpu.model.build import (
        build_model_spec as j_build)
    from sevennet_finetuning_tpu.train.checkpoint import (
        load_checkpoint as j_load)
    from sevennet_finetuning_tpu_torch.model.build import build_model_spec
    from sevennet_finetuning_tpu_torch.train.checkpoint import (
        load_checkpoint)

    j_spec = j_build(j_load(str(CKPT))['config'])
    t_spec = build_model_spec(load_checkpoint(str(CKPT))['config'])
    return j_spec, t_spec


@pytest.mark.parametrize('block', [0, 1, 4])
def test_sevennet0_layout_matches_jax(sevennet_specs, block):
    j_spec, t_spec = sevennet_specs
    want = j_fc.layout_from_spec(j_spec.blocks[block].conv_tp)
    got = layout_from_spec(t_spec.blocks[block].conv_tp)
    assert dataclasses.astuple(got) == dataclasses.astuple(want)
    dims = {0: (128, 9, 384, 1152), 1: (480, 9, 960, 3136),
            4: (480, 9, 224, 224)}[block]
    assert (got.dim_x, got.dim_sh, got.dim_w, got.dim_msg) == dims


def test_stride_roundtrip_matches_jax():
    ir = '3x0e+2x1e+2x2e'
    x = np.random.default_rng(0).normal(size=(5, JIrreps(ir).dim))
    x = x.astype(np.float32)
    want = j_fc.stride_to_e3nn(JIrreps(ir), jnp.asarray(x))
    got = stride_to_e3nn(Irreps(ir), torch.from_numpy(x))
    _close(got, want)
    _close(e3nn_to_stride(Irreps(ir), got), x)


# ---------------------------------------------------------------------------
# plain versions and autograd against JAX
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('name', sorted(LAYOUTS))
def test_plain_modes_match_jax(name):
    j_spec, t_spec = _specs(LAYOUTS[name])
    jl, tl = j_fc.layout_from_spec(j_spec), layout_from_spec(t_spec)
    N = 7
    d = _data(tl, E=29, N=N, seed=1)
    j, t = _j(d), _t(d)
    want = cg_node_apply('agg', j['x'], j['sh'], j['w'], j['dst'], jl, N)
    _close(agg_plain(t['x'], t['sh'], t['w'], t['dst'], tl, N), want)
    legs = {'xn': ('sh', 'w'), 'shn': ('x', 'w'), 'wn': ('x', 'sh')}
    for mode, (b, c) in legs.items():
        want = cg_node_apply(mode, j['ybar'], j[b], j[c], j['dst'], jl, N)
        got = node_mode_plain(mode, t['ybar'], t[b], t[c], t['dst'], tl, N)
        _close(got, want)


@pytest.mark.parametrize('name', sorted(LAYOUTS))
@pytest.mark.parametrize('live', [(0, 1, 2), (1, 2), (0,)])
def test_cg_node_agg_grads_match_jax_vjp(name, live):
    j_spec, t_spec = _specs(LAYOUTS[name])
    jl, tl = j_fc.layout_from_spec(j_spec), layout_from_spec(t_spec)
    N = 6
    d = _data(tl, E=23, N=N, seed=2)
    j, t = _j(d), _t(d)
    legs = ['x', 'sh', 'w']

    def f(*args):
        full = [j[k] for k in legs]
        for i, a in zip(live, args):
            full[i] = a
        return cg_node_apply('agg', *full, j['dst'], jl, N)

    want, vjp = jax.vjp(f, *[j[legs[i]] for i in live])
    want_g = vjp(j['ybar'])
    ins = [t[k].clone().requires_grad_(i in live)
           for i, k in enumerate(legs)]
    got = conv_aggregate(tl, *ins, t['dst'], N)
    _close(got, want)
    got_g = torch.autograd.grad(got, [ins[i] for i in live], t['ybar'])
    for g, w in zip(got_g, want_g):
        _close(g, w)


def test_multi_backward_is_for_the_training_slice():
    _, t_spec = _specs(SMALL)
    tl = layout_from_spec(t_spec)
    t = _t(_data(tl, E=9, N=4))
    ybar = t['ybar'].clone().requires_grad_(True)
    out = cg_node_multi(ybar, t['x'], t['sh'], t['w'], t['dst'],
                        jobs=('xn', 'wn'), layout=tl, n_node=4)
    with pytest.raises(NotImplementedError, match='training slice'):
        torch.autograd.grad(out[0].sum(), ybar)


def test_segment_sum_and_gather_rows_sentinels():
    rng = np.random.default_rng(3)
    E, N, D = 40, 9, 5
    dst = np.sort(rng.integers(0, N, E)).astype(np.int32)
    dst[-4:] = N
    msg = torch.from_numpy(rng.normal(size=(E, D)).astype(np.float32))
    msg.requires_grad_(True)
    td = torch.from_numpy(dst)
    out = scatter.segment_sum_sorted(msg, td, N)
    want = np.zeros((N, D), np.float32)
    np.add.at(want, dst[:-4], msg.detach().numpy()[:-4])
    _close(out, want)
    ct = torch.from_numpy(rng.normal(size=(N, D)).astype(np.float32))
    g, = torch.autograd.grad(out, msg, ct)
    assert float(g[-4:].abs().max()) == 0.0       # sentinel rows get 0
    _close(g[:-4], ct.numpy()[dst[:-4]])

    # gather_rows: clamped forward, sentinel cotangents dropped backward
    src = rng.integers(0, N, E).astype(np.int32)
    src[-4:] = N
    perm = torch.from_numpy(np.argsort(src, kind='stable').astype(np.int32))
    x = torch.from_numpy(rng.normal(size=(N, D)).astype(np.float32))
    x.requires_grad_(True)
    y = scatter.gather_rows(x, torch.from_numpy(src), perm)
    _close(y, x.detach().numpy()[np.minimum(src, N - 1)])
    cy = torch.from_numpy(rng.normal(size=(E, D)).astype(np.float32))
    gx, = torch.autograd.grad(y, x, cy)
    want = np.zeros((N, D), np.float32)
    np.add.at(want, src[:-4], cy.numpy()[:-4])
    _close(gx, want)


# ---------------------------------------------------------------------------
# the Pallas kernels in interpret mode against the port's plain versions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('name', ['small', 'sevennet_like'])
def test_agg_pallas_interpret_matches_port(name):
    j_spec, t_spec = _specs(LAYOUTS[name])
    jl, tl = j_fc.layout_from_spec(j_spec), layout_from_spec(t_spec)
    N = 9
    d = _data(tl, E=37, N=N, seed=4)
    j, t = _j(d), _t(d)
    want = agg_pallas(j['x'], j['sh'], j['w'], j['dst'], layout=jl,
                      n_node=N, interpret=True)
    _close(agg_plain(t['x'], t['sh'], t['w'], t['dst'], tl, N), want)


@pytest.mark.parametrize('jobs', [('xn', 'shn', 'wn'), ('shn', 'wn')])
def test_multi_pallas_interpret_matches_port(jobs):
    j_spec, t_spec = _specs(SEVENNET_LIKE)
    jl, tl = j_fc.layout_from_spec(j_spec), layout_from_spec(t_spec)
    N = 12
    d = _data(tl, E=77, N=N, seed=5, sentinel_tail=4)
    j, t = _j(d), _t(d)
    want = multi_pallas(j['ybar'], j['x'], j['sh'], j['w'], j['dst'],
                        layout=jl, jobs=jobs, n_node=N, interpret=True)
    got = multi_plain(t['ybar'], t['x'], t['sh'], t['w'], t['dst'], jobs,
                      tl, N)
    for g, w in zip(got, want):
        _close(g, w)


@pytest.mark.parametrize('D', [1, 3, 6, 128])
def test_segment_sum_pallas_interpret_matches_port(D):
    rng = np.random.default_rng(D)
    E, N = 300, 41
    dst = np.sort(rng.integers(0, N, E)).astype(np.int32)
    dst[-20:] = N
    msg = rng.normal(size=(E, D)).astype(np.float32)
    want = j_segment_sum_sorted(jnp.asarray(msg), jnp.asarray(dst), N,
                                interpret=True)
    got = scatter.segment_sum_plain(torch.from_numpy(msg),
                                    torch.from_numpy(dst), N)
    _close(got, want)


# ---------------------------------------------------------------------------
# the kernels' term tables, walked on the CPU the way the kernels walk them
# ---------------------------------------------------------------------------

def _term_values(rows, terms):
    a, b, c = terms[:, 0], terms[:, 1], terms[:, 2]
    coef = terms[:, 3].copy().view(np.float32).astype(np.float64)
    return coef * rows[:, a] * rows[:, b] * rows[:, c]     # [E, T]


def eval_agg_table(layout, x, sh, w, dst, n_node):
    """cg_agg.cu: per node, per edge in order, per msg column its terms."""
    start, terms = cg_tables.agg_table(layout)
    rows = np.concatenate([x, sh, w], axis=1).astype(np.float64)
    vals = _term_values(rows, terms[:start[-1]])
    col_of_term = np.repeat(np.arange(layout.dim_msg), np.diff(start))
    msg = np.zeros((len(dst), layout.dim_msg))
    np.add.at(msg, (slice(None), col_of_term), vals)
    out = np.zeros((n_node, layout.dim_msg))
    offs = np.searchsorted(dst, np.arange(n_node + 1))
    for n in range(n_node):
        for e in range(offs[n], offs[n + 1]):
            out[n] += msg[e]
    return out


def eval_multi_table(layout, jobs, ybar, x, sh, w, dst, n_node):
    """cg_multi.cu: per edge, items (columns or shn chunks), then the
    ordered reduction of each shn column's partial sums."""
    tab = cg_tables.multi_table(layout, jobs)
    g = np.where((dst < n_node)[:, None],
                 ybar[np.minimum(dst, n_node - 1)], 0.0)
    rows = np.concatenate([g, x, sh, w], axis=1).astype(np.float64)
    vals = _term_values(rows, tab.terms[:tab.item_start[-1]])
    item_of_term = np.repeat(np.arange(len(tab.item_out)),
                             np.diff(tab.item_start))
    items = np.zeros((len(dst), len(tab.item_out)))
    np.add.at(items, (slice(None), item_of_term), vals)
    total = sum(tab.out_dims)
    out = np.full((len(dst), total), np.nan)
    part = np.zeros((len(dst), max(tab.n_part, 1)))
    for it, o in enumerate(tab.item_out):
        if o >= 0:
            out[:, o] = items[:, it]
        else:
            part[:, -o - 1] = items[:, it]
    for q in range(len(tab.red_start) - 1):
        out[:, tab.red_out[q]] = part[:, tab.red_start[q]:
                                      tab.red_start[q + 1]].sum(axis=1)
    splits = np.cumsum(tab.out_dims)[:-1]
    return np.split(out, splits, axis=1)


def test_tables_cover_every_output_once():
    _, t_spec = _specs(SEVENNET_LIKE)
    tl = layout_from_spec(t_spec)
    start, _ = cg_tables.agg_table(tl)
    assert len(start) == tl.dim_msg + 1
    for jobs in [('xn', 'shn', 'wn'), ('shn', 'wn'), ('wn',), ('shn',)]:
        tab = cg_tables.multi_table(tl, jobs)
        direct = [int(o) for o in tab.item_out if o >= 0]
        reduced = list(tab.red_out[:len(tab.red_start) - 1])
        assert sorted(direct + reduced) == list(range(sum(tab.out_dims)))
        sizes = np.diff(tab.item_start)
        assert sizes.max() <= cg_tables.SH_CHUNK


@pytest.mark.parametrize('name', sorted(LAYOUTS))
def test_agg_table_matches_plain(name):
    _, t_spec = _specs(LAYOUTS[name])
    tl = layout_from_spec(t_spec)
    N = 8
    d = _data(tl, E=31, N=N, seed=6)
    t = _t(d)
    want = agg_plain(t['x'], t['sh'], t['w'], t['dst'], tl, N)
    got = eval_agg_table(tl, d['x'], d['sh'], d['w'], d['dst'], N)
    _close(got, want.numpy())


@pytest.mark.parametrize('name', sorted(LAYOUTS))
@pytest.mark.parametrize('jobs', [('xn', 'shn', 'wn'), ('shn', 'wn'),
                                  ('xn',)])
def test_multi_table_matches_plain(name, jobs):
    _, t_spec = _specs(LAYOUTS[name])
    tl = layout_from_spec(t_spec)
    N = 8
    d = _data(tl, E=31, N=N, seed=7)
    t = _t(d)
    want = multi_plain(t['ybar'], t['x'], t['sh'], t['w'], t['dst'], jobs,
                       tl, N)
    got = eval_multi_table(tl, jobs, d['ybar'], d['x'], d['sh'], d['w'],
                           d['dst'], N)
    for g, w in zip(got, want):
        _close(g, w.numpy())


@pytest.mark.parametrize('block', [0, 1, 4])
def test_sevennet0_tables_match_plain(sevennet_specs, block):
    _, t_spec = sevennet_specs
    tl = layout_from_spec(t_spec.blocks[block].conv_tp)
    N = 4
    d = _data(tl, E=14, N=N, seed=8, sentinel_tail=2)
    t = _t(d)
    want = agg_plain(t['x'], t['sh'], t['w'], t['dst'], tl, N)
    _close(eval_agg_table(tl, d['x'], d['sh'], d['w'], d['dst'], N),
           want.numpy())
    jobs = ('shn', 'wn') if block == 0 else ('xn', 'shn', 'wn')
    want = multi_plain(t['ybar'], t['x'], t['sh'], t['w'], t['dst'], jobs,
                       tl, N)
    got = eval_multi_table(tl, jobs, d['ybar'], d['x'], d['sh'], d['w'],
                           d['dst'], N)
    for g, w in zip(got, want):
        _close(g, w.numpy())
        assert np.all(g[-2:] == 0.0)      # sentinel edges: zero cotangent
