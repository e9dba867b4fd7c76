"""The cg_node family of the port against the JAX package.

- the port's ``CGLayout`` equals JAX ``layout_from_spec`` field by field
  for the three SevenNet-0 conv layouts;
- plain agg / xn / shn / wn and ``CGNodeAgg``'s value and first-order
  gradients against JAX ``cg_node_apply`` and ``jax.vjp``;
- the JAX Pallas kernels in interpret mode (``agg_pallas``,
  ``multi_pallas``, ``segment_sum_sorted``) at small E against the port's
  plain versions;
- a float32 walk of ``csrc/cg_agg.cu`` (its node-range kernel,
  ``cg_tables.agg_plan``, its shared memory ``agg_smem`` and its bulk
  copies ``agg_span``) tile by tile and stage by stage against the plain
  version and JAX
  ``agg_pallas`` in interpret mode, and the alignment of every bulk copy
  it issues at SevenNet-0's blocks;
- a float32 walk of ``csrc/segment_sum.cu``'s order (each row's edges
  in edge order, in either of ``segment_plan``'s shapes) against the
  plain version, bit for bit: empty rows, a sentinel tail, N << E;
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
from sevennet_finetuning_tpu_torch.ops.fused_conv_multi import multi_plain
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
    inv = torch.from_numpy(np.argsort(perm.numpy()).astype(np.int32))
    y = scatter.gather_rows(x, torch.from_numpy(src), perm, inv)
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

# ---------------------------------------------------------------------------
# cg_agg.cu's plan, walked on the CPU in the kernel's order
# ---------------------------------------------------------------------------

F32 = np.float32


def _fma(a, b, c):
    """float32 fma: the product of two float32 values is exact in
    float64; the sum is rounded once (to float64, then float32)."""
    return (np.asarray(a, np.float64) * b + c).astype(F32)


def _agg_launch(layout, cfg):
    plan = cg_tables.agg_plan(layout, cfg.nodes, cfg.warps)
    return plan, cg_tables.agg_smem(layout, cfg, plan.b_row)


def _agg_tile_copies(layout, cfg, sm, e0, ne, n_edge, stage):
    """The copies of one tile as cg_agg.cu's issue_tile makes them: per
    array (x, sh, w), (a0, bulk, tail_end, row offset, shared-memory
    float of the span, the span's capacity, width)."""
    sections = ((layout.dim_x, 0, sm.x_cap),
                (layout.dim_sh, sm.x_cap, sm.sh_cap),
                (layout.dim_w, sm.x_cap + sm.sh_cap, sm.w_cap))
    return [(*cg_tables.agg_span(e0, ne, d, n_edge * d),
             stage * sm.stage + sec, cap, d) for d, sec, cap in sections]


def walk_agg_offsets(dst, n_node):
    """cg_agg.cu's offsets kernel in numpy: thread e (0..E) writes offs[n]
    = e for n in (dst[e - 1], dst[e]] (thread 0 from -1, thread E up to
    n_node), destinations clamped to n_node; -1 marks an entry no thread
    wrote."""
    E = len(dst)
    d = np.minimum(np.asarray(dst, np.int64), n_node)
    offs = np.full(n_node + 1, -1, np.int64)
    for e in range(E + 1):
        lo = -1 if e == 0 else d[e - 1]
        hi = n_node if e == E else d[e]
        assert (offs[lo + 1:hi + 1] == -1).all()      # written once
        offs[lo + 1:hi + 1] = e
    return offs


@pytest.mark.parametrize('E,N,tail,empty', [
    (0, 5, 0, ()), (40, 7, 3, (2,)), (40, 7, 0, (0, 6)), (300, 40, 25,
                                                         (0, 7, 39)),
    (12, 1, 12, ())])
def test_agg_offsets_walk_matches_row_offsets(E, N, tail, empty):
    """The node ranges cg_agg.cu computes on the device equal
    scatter.row_offsets (the host search they replace): empty nodes, a
    sentinel tail, no edges, only sentinels; every entry written once."""
    rng = np.random.default_rng(E + N)
    keep = np.setdiff1d(np.arange(N), empty)
    dst = np.sort(rng.choice(keep, E)).astype(np.int32)
    if tail:
        dst[-tail:] = N
    got = walk_agg_offsets(dst, N)
    want = scatter.row_offsets(torch.from_numpy(dst), N).numpy()
    assert (got >= 0).all()
    np.testing.assert_array_equal(got, want)


def walk_agg_plan(layout, x, sh, w, dst, n_node, cfg, copies=None,
                  cover=None):
    """csrc/cg_agg.cu in numpy, float32, in the kernel's order, with the
    block's shared memory as one float array (NaN where nothing was
    staged): the node ranges as its offsets kernel writes them; per block
    of ``cfg.nodes`` nodes, its edge run in tiles; the
    first ``stages`` tiles issued up front, tile c - 1 + stages after tile
    c's B rows; each array's tile copied as agg_span's 16-byte aligned
    span (plus its plain-load tail) and read at the span's row offset; B
    rows from the staged sh (B buffer c % 2, fma over the couplings),
    then each warp's items in order, each over its node's edges in the
    tile with its running sums loaded from and stored to the accumulators
    (m = sum_i x B and acc += w m, each product rounded before its add).
    ``copies`` collects
    (source byte offset, destination byte offset, bytes) of every bulk
    copy; ``cover`` ([n_node, dim_msg]) counts each output element's
    item lanes."""
    plan, sm = _agg_launch(layout, cfg)
    T, S = cfg.tile, cfg.stages
    E = len(dst)
    flat = [np.ascontiguousarray(a, F32).reshape(-1) for a in (x, sh, w)]
    offs = walk_agg_offsets(dst, n_node)
    ent = plan.entries
    coef = ent[:, 3::2].copy().view(F32)
    steps = ent[:, 1]
    lanes = np.arange(cg_tables.WARP)
    dx, dsh, dw, dm = (layout.dim_x, layout.dim_sh, layout.dim_w,
                       layout.dim_msg)
    out = np.full((n_node, dm), np.nan, F32)
    for n0 in range(0, n_node, cfg.nodes):
        nn = min(cfg.nodes, n_node - n0)
        no = offs[n0:n0 + nn + 1]
        smem = np.full(sm.total, np.nan, F32)
        smem[sm.acc_base:sm.acc_base + nn * dm] = 0.0
        seen = set()
        e_begin, e_end = int(no[0]), int(no[nn])
        n_tile = -(-(e_end - e_begin) // T)

        def issue(c):
            e0 = e_begin + c * T
            ne = min(T, e_end - e0)
            for f, (a0, bulk, tail_end, _, at, cap, _) in zip(
                    flat, _agg_tile_copies(layout, cfg, sm, e0, ne, E,
                                           c % S)):
                assert max(bulk, tail_end - a0) <= cap
                smem[at:at + bulk] = f[a0:a0 + bulk]
                smem[at + bulk:at + tail_end - a0] = f[a0 + bulk:tail_end]
                if copies is not None and bulk:
                    copies.append((4 * a0, 4 * at, 4 * bulk))

        for c in range(min(S, n_tile)):
            issue(c)
        for c in range(n_tile):
            e0 = e_begin + c * T
            ne = min(T, e_end - e0)
            (_, _, _, ox, ax, _, _), (_, _, _, os_, as_, _, _), \
                (_, _, _, ow, aw, _, _) = _agg_tile_copies(
                    layout, cfg, sm, e0, ne, E, c % S)
            xs, ss, ws = ax + ox, as_ + os_, aw + ow
            bs = sm.b_base + (c % 2) * T * plan.b_row
            for le in range(ne):
                b = np.zeros(len(ent), F32)
                for st in range(cg_tables.AGG_MAX_STEPS):
                    sv = smem[ss + le * dsh + ent[:, 2 + 2 * st]]
                    b = np.where(st < steps, _fma(coef[:, st], sv, b), b)
                smem[bs + le * plan.b_row + ent[:, 0]] = b
            if c >= 1 and c - 1 + S < n_tile:
                issue(c - 1 + S)
            for wp in range(cfg.warps):
                for it in range(plan.warp_start[wp], plan.warp_start[wp + 1]):
                    (g, x_off, d1, mul, u0, w_off, d3, msg_off, b_off,
                     _) = plan.items[it]
                    if g >= nn:
                        continue
                    lo, hi = max(no[g], e0) - e0, min(no[g + 1], e0 + ne) - e0
                    if lo >= hi:
                        continue
                    u = u0 + lanes
                    act = u < mul
                    uc = np.where(act, u, mul - 1)
                    at = (sm.acc_base + g * dm + msg_off
                          + np.arange(d3)[:, None] * mul + uc)
                    acc = smem[at]
                    for le in range(lo, hi):
                        xv = smem[xs + le * dx + x_off
                                  + np.arange(d1)[:, None] * mul + uc]
                        wv = smem[ws + le * dw + w_off + uc]
                        bb = smem[bs + le * plan.b_row + b_off
                                  + np.arange(d1 * d3)].reshape(d3, d1)
                        m = (bb[:, 0, None] * xv[0]).astype(F32)
                        for i in range(1, d1):
                            m = m + (bb[:, i, None] * xv[i]).astype(F32)
                        acc = acc + (wv * m).astype(F32)
                    smem[at[:, act]] = acc[:, act]
                    if cover is not None and (g, it) not in seen:
                        seen.add((g, it))
                        np.add.at(cover, (n0 + g, at[:, act] - sm.acc_base
                                          - g * dm), 1)
        out[n0:n0 + nn] = smem[sm.acc_base:sm.acc_base + nn * dm].reshape(
            nn, dm)
    return out


def _agg_cases(sevennet_specs):
    """(name -> (JAX layout, port layout)) for the narrow layouts and
    SevenNet-0's blocks 0, 1 and 4."""
    cases = {name: tuple(
        f(spec) for f, spec in zip((j_fc.layout_from_spec, layout_from_spec),
                                   _specs(irreps)))
             for name, irreps in LAYOUTS.items()}
    j_spec, t_spec = sevennet_specs
    for b in (0, 1, 4):
        cases[f'block{b}'] = (
            j_fc.layout_from_spec(j_spec.blocks[b].conv_tp),
            layout_from_spec(t_spec.blocks[b].conv_tp))
    return cases


# a block of 2 nodes, 3 warps, tiles of 3 edges in a ring of 3: nodes
# span several tiles, tiles span nodes, the ring wraps
AGG_SMALL_CFG = cg_tables.AggConfig(tile=3, stages=3, nodes=2, warps=3)


@pytest.mark.parametrize('name', sorted(LAYOUTS) + ['block0', 'block1',
                                                    'block4'])
def test_agg_plan_walk_matches_plain_and_pallas(sevennet_specs, name):
    """The walk of cg_agg.cu at the launch rule's config and at
    ``AGG_SMALL_CFG`` against agg_plain and JAX agg_pallas in interpret
    mode: node 2 has no edges (zeros), node 5 has 9 (several tiles), the
    last three edges are sentinels; then a graph without sentinels whose
    sh rows end in a partial 16 bytes (the plain-load tail).  Each
    output element gets one item lane, both configs give the same bits,
    and every bulk copy is 16-byte aligned."""
    from sevennet_finetuning_tpu_torch.ops.fused_conv_agg import agg_config

    jl, tl = _agg_cases(sevennet_specs)[name]
    N = 7
    rng = np.random.default_rng(len(name))
    dst = np.sort(np.concatenate([rng.choice([0, 1, 3, 4, 6], 14),
                                  np.full(9, 5)])).astype(np.int32)
    dst = np.concatenate([dst, np.full(3, N)]).astype(np.int32)
    for dst in (dst, np.sort(rng.integers(0, N, 25)).astype(np.int32)):
        d = _data(tl, E=len(dst), N=N, seed=9, sentinel_tail=0)
        d['dst'] = dst
        t = _t(d)
        want = agg_plain(t['x'], t['sh'], t['w'], t['dst'], tl, N).numpy()
        j = _j(d)
        pallas = agg_pallas(j['x'], j['sh'], j['w'], j['dst'], layout=jl,
                            n_node=N, interpret=True)
        outs = []
        for cfg in (agg_config(tl), AGG_SMALL_CFG):
            copies, cover = [], np.zeros((N, tl.dim_msg), np.int64)
            got = walk_agg_plan(tl, d['x'], d['sh'], d['w'], dst, N, cfg,
                                copies, cover)
            _close(got, want)
            _close(got, pallas)
            assert (cover[np.unique(dst[dst < N])] == 1).all()
            assert all(v % 16 == 0 for cp in copies for v in cp)
            outs.append(got)
        assert np.array_equal(outs[0], outs[1])
        if 2 not in dst:
            assert np.all(outs[0][2] == 0.0)


@pytest.mark.parametrize('block', [0, 1, 4])
def test_agg_copies_aligned_and_within_shared_memory(sevennet_specs,
                                                     block):
    """Every bulk copy that cg_agg.cu issues at the launch rule's config
    on a graph of the batch-8 collate's size (768 nodes, 38,080 edge
    slots, 34,604 live, ascending from numpy seed 0), and on one of 1,001
    live edges and no sentinel (the sh array then ends in a partial 16
    bytes), has a 16-byte aligned source offset, destination offset and
    size, never reads past the array's last whole 16 bytes, and lands in
    its span's section; the tail's plain loads end at the array's end;
    the sections lie apart, and the block's shared memory, static part
    included, fits the card's 232,448 bytes."""
    from sevennet_finetuning_tpu_torch.ops.fused_conv_agg import agg_config

    _, tl = _agg_cases(sevennet_specs)[f'block{block}']
    cfg = agg_config(tl)
    plan, sm = _agg_launch(tl, cfg)
    assert sm.nbytes + 128 <= 232448 and sm.nbytes <= cg_tables.AGG_SMEM_MAX
    assert cfg.stages * sm.stage <= sm.b_base
    assert sm.b_base + 2 * cfg.tile * plan.b_row <= sm.acc_base
    assert sm.acc_base + cfg.nodes * tl.dim_msg <= sm.total
    assert all(v % 4 == 0 for v in (sm.x_cap, sm.sh_cap, sm.w_cap, sm.stage,
                                    sm.b_base, sm.acc_base, plan.b_row))
    assert (plan.items[:, 8] % 4 == 0).all()        # B blocks: float4s
    rng = np.random.default_rng(0)
    big = np.full(38080, 768, np.int32)
    big[:34604] = np.sort(rng.integers(0, 768, 34604))
    odd = np.sort(rng.integers(0, 40, 1001)).astype(np.int32)
    n_tail = 0
    for dst, n_node in ((big, 768), (odd, 40)):
        E = len(dst)
        offs = np.searchsorted(dst, np.arange(n_node + 1))
        for n0 in range(0, n_node, cfg.nodes):
            e_begin = offs[n0]
            e_end = offs[min(n0 + cfg.nodes, n_node)]
            for c in range(-(-(e_end - e_begin) // cfg.tile)):
                e0 = e_begin + c * cfg.tile
                ne = min(cfg.tile, e_end - e0)
                for a0, bulk, tail_end, off, at, cap, dim in (
                        _agg_tile_copies(tl, cfg, sm, e0, ne, E,
                                         c % cfg.stages)):
                    assert (4 * a0) % 16 == 0 and (4 * at) % 16 == 0
                    assert (4 * bulk) % 16 == 0 and bulk >= 0
                    assert a0 + bulk <= E * dim // 4 * 4
                    assert tail_end == max((e0 + ne) * dim, a0 + bulk)
                    assert tail_end <= E * dim
                    assert off == e0 * dim - a0 and 0 <= off < 4
                    assert max(bulk, tail_end - a0) <= cap
                    n_tail += tail_end > a0 + bulk
    assert n_tail > 0            # the odd graph's last sh rows


def test_agg_launch_rule_at_sevennet0(sevennet_specs):
    """agg_config takes AGG_FEW at blocks 0 and 4 (12 and 7 units a node)
    and AGG_MANY at the interior block (30), each block within 110 KB of
    shared memory (two an SM); the wrapper's host arrays carry that plan,
    config and shared-memory layout."""
    from sevennet_finetuning_tpu_torch.ops import fused_conv_agg as fca

    cases = _agg_cases(sevennet_specs)
    for block, want, n_unit in ((0, fca.AGG_FEW, 12), (1, fca.AGG_MANY, 30),
                                (4, fca.AGG_FEW, 7)):
        tl = cases[f'block{block}'][1]
        assert len(cg_tables.agg_plan(tl, 1, 1).items) == n_unit
        cfg = fca.agg_config(tl)
        assert cfg == want
        plan, sm = _agg_launch(tl, cfg)
        assert sm.nbytes <= 110 * 1024
        dev_plan, (meta, c_cfg, c_smem) = fca._agg_launch(
            tl, None, torch.device('cpu'))
        flat, m = plan.packed()
        assert np.array_equal(dev_plan.numpy(), flat) and tuple(meta) == m
        assert tuple(c_cfg) == (cfg.tile, cfg.stages, cfg.nodes, cfg.warps)
        assert tuple(c_smem) == (sm.x_cap, sm.sh_cap, sm.stage, sm.b_base,
                                 sm.acc_base, plan.b_row, sm.total)


# ---------------------------------------------------------------------------
# segment_sum.cu's order, walked on the CPU
# ---------------------------------------------------------------------------

def walk_segment_sum(msg, dst, n_rows):
    """segment_sum.cu in numpy, float32, in the kernel's order (both of
    ``segment_plan``'s shapes): a row's edge range from lower bounds of n
    and n + 1, its edges added in edge order from 0 (the staged shape's
    chunks only change where the values are read)."""
    E, D = msg.shape
    chunk = scatter.segment_plan(E, D, n_rows) or E
    offs = np.searchsorted(dst, np.arange(n_rows + 1), side='left')
    out = np.zeros((n_rows, D), np.float32)
    for n in range(n_rows):
        acc = np.zeros(D, np.float32)
        for c in range(offs[n], offs[n + 1], chunk):
            for row in msg[c:min(c + chunk, offs[n + 1])]:
                acc = acc + row
        out[n] = acc
    return out


# (E, D, N, rows left empty, sentinel tail): N << E (the per-graph
# energy and virial: staged), N = E / 50 (per node: one thread per
# output), wide rows, empty rows, a sentinel tail
SEG_CASES = [(2000, 1, 3, (), 0), (6000, 6, 8, (2, 5), 40),
             (2000, 3, 40, (0, 7, 39), 25), (2000, 1, 40, (), 0),
             (600, 128, 200, (3, 4), 17), (96, 6, 8, (1,), 5)]


@pytest.mark.parametrize('E,D,N,empty,tail', SEG_CASES)
def test_segment_sum_walk_matches_plain(E, D, N, empty, tail):
    rng = np.random.default_rng(E + D + N)
    keep = np.setdiff1d(np.arange(N), empty)
    dst = np.sort(rng.choice(keep, E)).astype(np.int32)
    if tail:
        dst[-tail:] = N
    msg = rng.normal(size=(E, D)).astype(np.float32)
    want = scatter.segment_sum_plain(torch.from_numpy(msg),
                                     torch.from_numpy(dst), N).numpy()
    got = walk_segment_sum(msg, dst, N)
    _close(got, want)
    assert np.all(got[list(empty)] == 0.0)
    # the order is index_add_'s on the CPU: the same bits
    assert np.array_equal(got, want)


def test_segment_plan_stages_the_per_graph_reduces():
    """The main path's per-graph energy (96 atoms a graph) and virial
    (~4,800 edges a graph) take the staged shape; per-node sums and wide
    rows one thread per output element; a chunk fills one buffer."""
    assert scatter.segment_plan(768, 1, 8) == scatter.STAGED_FLOATS
    assert scatter.segment_plan(38080, 6, 8) == scatter.STAGED_FLOATS // 6
    for E, D, N in ((38080, 480, 768), (38080, 128, 768), (38080, 3, 768),
                    (38080, 1, 768), (96, 6, 8)):
        assert scatter.segment_plan(E, D, N) == 0
    for E, D, N in ((6000, 6, 8), (2000, 1, 3), (10 ** 6, 5000, 1)):
        c = scatter.segment_plan(E, D, N)
        assert 0 <= c * D <= scatter.STAGED_FLOATS


def test_segment_plan_keeps_wide_rows_off_the_staged_shape():
    """The staged block adds one column a thread over 256 threads: wider
    rows, however few and long, take one thread per output element -- as
    the src-side feature scatter (width 480) of a 12-atom graph padded to
    1,024 edge slots does."""
    assert scatter.segment_plan(1024, 480, 12) == 0
    assert scatter.segment_plan(4096, scatter.STAGED_MAX_D + 1, 16) == 0
    assert scatter.segment_plan(4096, scatter.STAGED_MAX_D, 16) == 16
