"""The per-edge quadrilinear family and the unsorted-dst convolution of the
port against the JAX package.

- each mode (msg / x / sh / w) of the port's plain version, through the
  feature-major ``cg_apply`` and the edge-major ``cg_apply_edge``,
  against JAX ``pallas_impl(interpret=True)`` and ``_xla_impl`` on the
  SevenNet-0 block-1 spec and an odd-parity lmax-1 spec, E = 150 (not a
  multiple of the Pallas edge tile); zero-weight edges give exact zeros;
- a CPU evaluator of ``cg_tables.quad_table`` (the table that drives
  ``csrc/cg_quad.cu``), walked the way the kernel walks it, against the
  plain version, on small layouts and SevenNet-0's blocks 0, 1 and 4;
- the ``CGQuad`` Function: first- and second-order gradients against
  ``jax.vjp`` / ``jax.grad`` of JAX ``cg_apply``, and float64
  ``gradgradcheck`` (third order);
- ``aggregate_messages(sorted_dst=False)`` and ``gather_rows(perm=None)``
  with padded (sentinel) edges mixed in, values and gradients, against
  JAX;
- the whole slice on a narrow NequIP (channel 16, lmax 2, 3
  convolutions): with ``onehot``, ``emb`` and ``edge_attr`` from JAX
  ``energy_network`` on a collate of two structures of ft.extxyz (96 and
  12 atoms) and every edge slot permuted, the port's ``run_blocks(edges_sorted=False)`` against JAX
  ``run_blocks(edges_sorted=False, src_perm=None)``: node features, the
  gradient of the summed readout over ``edge_attr``, ``emb`` and every
  parameter, and a ``create_graph=True`` parameter gradient of a
  random-weighted loss on that edge gradient.

Tolerances: each mode within 2e-6 x max|ref| (the JAX package's own
kernel limit); family gradients 2e-5 x max|ref| (float32 sums of up to a
few thousand terms in another order, as for the cg_node family); node
features 1e-5 and model gradients 1e-4 x max|g| per leaf (the narrow
model limits of test_torch_model.py and test_torch_train.py).

The golden file that ``chip_smoke.py`` holds the card's unsorted path
against (SevenNet-0 at full width, the batch-8 collate of ft900.extxyz with
every edge slot permuted by numpy seed 0: the permutation, the atom types,
the last block's node features, the energies and fij = dE/d edge_vec,
from JAX on the CPU) is written by

    PYTHONPATH=. python tests/test_torch_quad.py
"""

import dataclasses
import functools
import os
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sevennet_finetuning_tpu import keys as JK
from sevennet_finetuning_tpu.data.readers import read_extxyz as j_read
from sevennet_finetuning_tpu.irreps import Irreps as JIrreps
from sevennet_finetuning_tpu.model import graph as j_graph
from sevennet_finetuning_tpu.model import nequip as j_nequip
from sevennet_finetuning_tpu.model.build import build_model_spec as j_build
from sevennet_finetuning_tpu.ops import fused_conv as j_fc
from sevennet_finetuning_tpu.ops.fused_conv_kernel import pallas_impl
from sevennet_finetuning_tpu.ops.pallas_scatter import (
    aggregate_messages as j_aggregate, gather_rows as j_gather_rows)
from sevennet_finetuning_tpu.ops.tensor_product import (
    uvu_tp_spec as j_uvu_tp_spec)
from sevennet_finetuning_tpu_torch import keys as K
from sevennet_finetuning_tpu_torch.irreps import Irreps
from sevennet_finetuning_tpu_torch.model.build import build_model_spec
from sevennet_finetuning_tpu_torch.model.nequip import (
    NequIP, embed_nodes, load_jax_params, readout_and_rescale, run_blocks)
from sevennet_finetuning_tpu_torch.ops import cg_tables, scatter
from sevennet_finetuning_tpu_torch.ops.fused_conv import (
    _MODE_LEGS, CGQuad, cg_apply, cg_apply_edge, layout_from_spec)
from sevennet_finetuning_tpu_torch.ops.fused_conv_kernel import quad_plain
from sevennet_finetuning_tpu_torch.ops.tensor_product import uvu_tp_spec

torch.set_num_threads(2)
MODE_TOL = 2e-6
FAMILY_TOL = 2e-5
FEATURE_TOL = 1e-5
GRAD_TOL = 1e-4
ROOT = Path(__file__).resolve().parent.parent
FT = ROOT / 'experiments/ft_reewc/data/ft.extxyz'
FT900 = ROOT / 'experiments/ft_reewc_900/data/ft900.extxyz'
CKPT = ROOT / 'experiments/ft_reewc_900/conv_out/checkpoint_best.pth'
GOLDEN = (ROOT / 'sevennet_finetuning_tpu_torch/golden/'
          'unsorted_ft900_jax_cpu.npz')
TYPE_MAP = {72: 0, 8: 1}
MODES = ('msg', 'x', 'sh', 'w')

# the specs of tests/test_fused_conv_kernel.py
SPECS = {
    'sevennet0_block1': ('128x0e+64x1e+32x2e', '1x0e+1x1e+1x2e',
                         '128x0e+128x1e+128x2e'),
    'parity_lmax1': ('8x0e+4x1o', '1x0e+1x1o', '8x0e+8x1o+8x1e'),
}
SMALL = ('4x0e+3x1e+2x2e', '1x0e+1x1e+1x2e', '4x0e+4x1e+4x2e')
TINY = ('1x0e+1x1e', '1x0e+1x1e', '1x0e+1x1e')
TABLE_LAYOUTS = {'small': SMALL, 'parity_lmax1': SPECS['parity_lmax1'],
                 'scalar_in': ('8x0e', '1x0e+1x1e+1x2e',
                               '8x0e+8x1e+8x2e')}


def _layouts(irreps):
    a, b, c = irreps
    return (j_fc.layout_from_spec(j_uvu_tp_spec(JIrreps(a), JIrreps(b),
                                                JIrreps(c))),
            layout_from_spec(uvu_tp_spec(Irreps(a), Irreps(b), Irreps(c))))


def _close(got, want, rtol, name=''):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= rtol * scale, (name, err, scale)


def _legs(layout, mode, E, seed, dtype=np.float32):
    """Feature-major [dim, E] legs of ``mode`` from a numpy seed."""
    rng = np.random.default_rng(seed)
    dims = layout.mode_dims
    return [rng.standard_normal((dims[leg], E)).astype(dtype)
            for leg in _MODE_LEGS[mode]]


# ---------------------------------------------------------------------------
# each mode: the port's plain version against the JAX kernel and oracle
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('spec_name', sorted(SPECS))
@pytest.mark.parametrize('mode', MODES)
def test_plain_mode_matches_pallas_and_xla(spec_name, mode):
    jl, tl = _layouts(SPECS[spec_name])
    legs = _legs(tl, mode, 150, seed=MODES.index(mode))
    j_args = [jnp.asarray(a) for a in legs]
    want_pallas = pallas_impl(*j_args, layout=jl, mode=mode, interpret=True)
    want_xla = jax.jit(functools.partial(j_fc._xla_impl, layout=jl,
                                         mode=mode))(*j_args)
    t_args = [torch.from_numpy(a) for a in legs]
    got = cg_apply(mode, *t_args, tl)                  # feature-major
    _close(got, want_pallas, MODE_TOL, 'pallas')
    _close(got, want_xla, MODE_TOL, 'xla')
    got_edge = quad_plain(mode, *(a.T for a in t_args), tl)
    _close(got_edge.T, want_pallas, MODE_TOL, 'edge-major')


def test_zero_weight_edges_give_exact_zeros():
    jl, tl = _layouts(SPECS['parity_lmax1'])
    x, sh, w = _legs(tl, 'msg', 40, seed=3)
    w[:, -5:] = 0.0
    msg = cg_apply('msg', *(torch.from_numpy(a) for a in (x, sh, w)), tl)
    assert torch.all(msg[:, -5:] == 0.0)
    want = pallas_impl(*(jnp.asarray(a) for a in (x, sh, w)), layout=jl,
                       mode='msg', interpret=True)
    assert np.all(np.asarray(want)[:, -5:] == 0.0)
    g = np.random.default_rng(4).standard_normal(
        (tl.dim_msg, 40)).astype(np.float32)
    dx = cg_apply('x', *(torch.from_numpy(a) for a in (g, sh, w)), tl)
    assert torch.all(dx[:, -5:] == 0.0)
    assert np.all(eval_quad_table(tl, 'x', g.T, sh.T, w.T)[-5:] == 0.0)


# ---------------------------------------------------------------------------
# the kernel's term table, walked on the CPU the way the kernel walks it
# ---------------------------------------------------------------------------

def eval_quad_table(layout, mode, a, b, c):
    """cg_quad.cu: per edge, every item (a column, or a chunk of an sh
    column's terms) sums its terms in order; then each sh column adds its
    partial sums in order.  a, b, c edge-major, float64 arithmetic."""
    tab = cg_tables.quad_table(layout, mode)
    rows = np.concatenate([a, b, c], axis=1).astype(np.float64)
    E = rows.shape[0]
    items = np.zeros((E, len(tab.item_out)))
    for it in range(len(tab.item_out)):
        for t in range(tab.item_start[it], tab.item_start[it + 1]):
            i, j, k, bits = tab.terms[t]
            coef = np.int32(bits).view(np.float32).astype(np.float64)
            items[:, it] += coef * rows[:, i] * rows[:, j] * rows[:, k]
    out = np.full((E, tab.out_dims[0]), np.nan)
    part = np.zeros((E, max(tab.n_part, 1)))
    for it, o in enumerate(tab.item_out):
        if o >= 0:
            out[:, o] = items[:, it]
        else:
            part[:, -o - 1] = items[:, it]
    for q in range(len(tab.red_start) - 1):
        out[:, tab.red_out[q]] = part[:, tab.red_start[q]:
                                      tab.red_start[q + 1]].sum(axis=1)
    return out


@pytest.mark.parametrize('mode', MODES)
def test_quad_tables_cover_every_column_once(mode):
    _, tl = _layouts(SMALL)
    tab = cg_tables.quad_table(tl, mode)
    direct = [int(o) for o in tab.item_out if o >= 0]
    reduced = [int(o) for o in tab.red_out[:len(tab.red_start) - 1]]
    assert sorted(direct + reduced) == list(range(tab.out_dims[0]))
    if mode == 'sh':
        assert np.diff(tab.item_start).max() <= cg_tables.SH_CHUNK
    row = sum(tl.mode_dims[leg] for leg in _MODE_LEGS[mode])
    n = tab.item_start[-1]
    assert 0 <= tab.terms[:n, :3].min() and tab.terms[:n, :3].max() < row


@pytest.mark.parametrize('name', sorted(TABLE_LAYOUTS))
@pytest.mark.parametrize('mode', MODES)
def test_quad_table_matches_plain(name, mode):
    _, tl = _layouts(TABLE_LAYOUTS[name])
    legs = [a.T for a in _legs(tl, mode, 13, seed=20 + MODES.index(mode))]
    want = quad_plain(mode, *(torch.from_numpy(a) for a in legs), tl)
    _close(eval_quad_table(tl, mode, *legs), want.numpy(), FAMILY_TOL)


@pytest.fixture(scope='module')
def sevennet0_spec():
    from sevennet_finetuning_tpu_torch.train.checkpoint import (
        load_checkpoint)

    return build_model_spec(load_checkpoint(str(CKPT))['config'])


@pytest.mark.parametrize('block', [0, 1, 4])
def test_sevennet0_quad_tables_match_plain(sevennet0_spec, block):
    tl = layout_from_spec(sevennet0_spec.blocks[block].conv_tp)
    for mode in MODES:
        legs = [a.T for a in _legs(tl, mode, 3, seed=30 + block)]
        want = quad_plain(mode, *(torch.from_numpy(a) for a in legs), tl)
        _close(eval_quad_table(tl, mode, *legs), want.numpy(), FAMILY_TOL,
               mode)


# ---------------------------------------------------------------------------
# the autograd family against JAX
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('mode', MODES)
@pytest.mark.parametrize('const', [None, 1])
def test_cg_quad_grads_match_jax(mode, const):
    """First order (``jax.vjp``) and grad of grad (``jax.grad`` of a loss
    on the first derivatives); ``const``: an input that needs no
    gradient."""
    jl, tl = _layouts(SMALL)
    E = 23
    legs = _legs(tl, mode, E, seed=40 + MODES.index(mode))
    out_dim = tl.mode_dims[j_fc._MODE_OUT[mode]]
    rng = np.random.default_rng(50)
    ct = rng.standard_normal((out_dim, E)).astype(np.float32)
    r = [rng.standard_normal(a.shape).astype(np.float32) for a in legs]
    var = [i for i in range(3) if i != const]

    def j_f(*vs):
        full = [jnp.asarray(a) for a in legs]
        for i, v in zip(var, vs):
            full[i] = v
        return j_fc.cg_apply(mode, *full, jl)

    j_in = [jnp.asarray(legs[i]) for i in var]
    want, vjp = jax.vjp(j_f, *j_in)
    want_g = vjp(jnp.asarray(ct))

    def j_outer(*vs):
        g = jax.grad(lambda *u: jnp.sum(j_f(*u) * ct),
                     argnums=tuple(range(len(var))))(*vs)
        return sum(jnp.sum(gi * jnp.asarray(r[i]) ** 2)
                   for gi, i in zip(g, var))

    want_gg = jax.grad(j_outer, argnums=tuple(range(len(var))))(*j_in)

    t_in = [torch.from_numpy(a).requires_grad_(i in var)
            for i, a in enumerate(legs)]
    got = cg_apply(mode, *t_in, tl)
    _close(got, want, FAMILY_TOL)
    got_g = torch.autograd.grad(got, [t_in[i] for i in var],
                                torch.from_numpy(ct), create_graph=True)
    for g, w in zip(got_g, want_g):
        _close(g, w, FAMILY_TOL)
    outer = sum((g * torch.from_numpy(r[i]) ** 2).sum()
                for g, i in zip(got_g, var))
    got_gg = torch.autograd.grad(outer, [t_in[i] for i in var])
    for g, w in zip(got_gg, want_gg):
        _close(g, w, FAMILY_TOL)


def test_cg_quad_backward_calls_the_family_only():
    _, tl = _layouts(SMALL)
    legs = [torch.from_numpy(a.T.copy()).requires_grad_(True)
            for a in _legs(tl, 'msg', 9, seed=60)]
    msg = cg_apply_edge('msg', *legs, tl)
    grads = torch.autograd.grad(msg.pow(2).sum(), legs, create_graph=True)
    assert {type(g.grad_fn).__name__ for g in grads} == {'CGQuadBackward'}
    calls = []
    orig = CGQuad.forward

    def spy(ctx, mode, *args):
        calls.append(mode)
        return orig(ctx, mode, *args)

    CGQuad.forward = staticmethod(spy)
    try:
        sum(g.pow(2).sum() for g in grads).backward()
    finally:
        CGQuad.forward = staticmethod(orig)
    # x: (g, sh, w) -> msg, sh, w; sh: (g, x, w) -> msg, x, w;
    # w: (g, x, sh) -> msg, x, sh; then msg's own backward: x, sh, w
    assert sorted(calls) == sorted(['msg', 'sh', 'w', 'msg', 'x', 'w',
                                    'msg', 'x', 'sh', 'x', 'sh', 'w'])


@pytest.mark.parametrize('mode', MODES)
def test_gradgradcheck_cg_quad(mode):
    _, tl = _layouts(TINY)
    legs = [torch.from_numpy(a.T.copy()).requires_grad_(True)
            for a in _legs(tl, mode, 4, seed=70, dtype=np.float64)]
    assert torch.autograd.gradgradcheck(
        lambda a, b, c: cg_apply_edge(mode, a, b, c, tl), legs,
        fast_mode=True)


def test_cg_apply_edge_checks_shapes():
    _, tl = _layouts(SMALL)
    x, sh, w = (torch.from_numpy(a.T.copy())
                for a in _legs(tl, 'msg', 5, seed=0))
    with pytest.raises(ValueError, match='cg_quadlinear'):
        cg_apply_edge('msg', sh, x, w, tl)
    with pytest.raises(ValueError, match='cg_quadlinear'):
        cg_apply_edge('msg', x, sh[:4], w, tl)


# ---------------------------------------------------------------------------
# the unsorted aggregate and the gather without a permutation
# ---------------------------------------------------------------------------

def _unsorted_edges(E, N, n_pad, seed):
    rng = np.random.default_rng(seed)
    dst = rng.integers(0, N, E).astype(np.int32)
    src = rng.integers(0, N, E).astype(np.int32)
    pad = rng.choice(E, n_pad, replace=False)       # sentinels, mixed in
    dst[pad] = N
    src[pad] = N
    return dst, src, pad, rng


def test_aggregate_messages_unsorted_matches_jax():
    E, N, D = 60, 9, 5
    dst, _, pad, rng = _unsorted_edges(E, N, 7, seed=80)
    msg = rng.standard_normal((E, D)).astype(np.float32)
    ct = rng.standard_normal((N, D)).astype(np.float32)
    want, vjp = jax.vjp(lambda m: j_aggregate(m, jnp.asarray(dst), N, False),
                        jnp.asarray(msg))
    want_g, = vjp(jnp.asarray(ct))
    tm = torch.from_numpy(msg).requires_grad_(True)
    got = scatter.aggregate_messages(tm, torch.from_numpy(dst), N, False)
    _close(got, want, FAMILY_TOL)
    g, = torch.autograd.grad(got, tm, torch.from_numpy(ct))
    _close(g, want_g, FAMILY_TOL)
    assert float(g[pad].abs().max()) == 0.0          # sentinel rows get 0
    # the same sum as the sorted path's on the sorted edges
    order = np.argsort(dst, kind='stable')
    sorted_sum = scatter.aggregate_messages(
        torch.from_numpy(msg[order]), torch.from_numpy(dst[order]), N, True)
    _close(got, sorted_sum.numpy(), 1e-6)


def test_gather_rows_without_perm_matches_jax():
    E, N, D = 60, 9, 5
    _, src, pad, rng = _unsorted_edges(E, N, 7, seed=81)
    x = rng.standard_normal((N, D)).astype(np.float32)
    ct = rng.standard_normal((E, D)).astype(np.float32)
    ct[pad] = 0.0        # EDGE_MASK makes padded edges' cotangents 0
    want, vjp = jax.vjp(lambda v: j_gather_rows(v, jnp.asarray(src), None),
                        jnp.asarray(x))
    want_g, = vjp(jnp.asarray(ct))
    tx = torch.from_numpy(x).requires_grad_(True)
    got = scatter.gather_rows(tx, torch.from_numpy(src))
    _close(got, want, 0.0)                          # a clamped copy
    g, = torch.autograd.grad(got, tx, torch.from_numpy(ct))
    _close(g, want_g, FAMILY_TOL)
    # a nonzero cotangent on a padded row: JAX adds it to the last row,
    # the port drops it (exact only under the zero-cotangent precondition)
    ct[pad] = 1.0
    g, = torch.autograd.grad(scatter.gather_rows(tx, torch.from_numpy(src)),
                             tx, torch.from_numpy(ct))
    want_g = np.zeros((N, D), np.float32)
    live = np.setdiff1d(np.arange(E), pad)
    np.add.at(want_g, src[live], ct[live])
    _close(g, want_g, FAMILY_TOL)


def test_gradgradcheck_unsorted_scatter():
    E, N, D = 11, 4, 2
    dst, src, _, rng = _unsorted_edges(E, N, 2, seed=82)
    msg = torch.from_numpy(rng.standard_normal((E, D))).requires_grad_(True)
    x = torch.from_numpy(rng.standard_normal((N, D))).requires_grad_(True)
    tdst, tsrc = torch.from_numpy(dst), torch.from_numpy(src)
    assert torch.autograd.gradgradcheck(
        lambda m: scatter.aggregate_messages(m, tdst, N, False) ** 2,
        (msg,), fast_mode=True)
    assert torch.autograd.gradgradcheck(
        lambda v: scatter.gather_rows(v, tsrc) ** 2, (x,), fast_mode=True)


# ---------------------------------------------------------------------------
# the whole slice: run_blocks on unsorted edges, narrow model
# ---------------------------------------------------------------------------

def _narrow_config():
    """The sevennet0_like narrow model of test_torch_model.py."""
    return {
        K.NUM_SPECIES: 2, K.TYPE_MAP: dict(TYPE_MAP),
        K.NODE_FEATURE_MULTIPLICITY: 16, K.LMAX: 2, K.NUM_CONVOLUTION: 3,
        K.CUTOFF: 5.0, K.SELF_CONNECTION_TYPE: 'linear',
        K.CONV_DENOMINATOR: 30.0, K.SHIFT: [-9.0, -4.5],
        K.SCALE: [1.7, 1.3], K.IS_PARITY: False,
        K.CUTOFF_FUNCTION: {K.CUTOFF_FUNCTION_NAME: 'XPLOR',
                            K.CUTOFF_ON: 4.5},
    }


def _j_collate(path, structs_of, type_map, n_graph=None, n_node=None):
    """A JAX collate (scipy neighbor list, as the port's)."""
    old = os.environ.get('SEVENN_NO_NATIVE')
    os.environ['SEVENN_NO_NATIVE'] = '1'
    try:
        structs = structs_of(j_read(str(path)))
        graphs = [j_graph.structure_to_graph(s, 5.0, type_map)
                  for s in structs]
    finally:
        if old is None:
            del os.environ['SEVENN_NO_NATIVE']
        else:
            os.environ['SEVENN_NO_NATIVE'] = old
    n_node = n_node or j_graph.bucket_capacity(sum(len(s) for s in structs))
    n_edge = j_graph.bucket_capacity(
        sum(g[JK.EDGE_IDX].shape[1] for g in graphs))
    return j_graph.collate(graphs, n_node=n_node, n_edge=n_edge,
                           n_graph=n_graph or len(structs) + 1)


def _j_blocks_inputs(spec, params, batch, perm):
    """onehot, emb, edge_attr (JAX energy_network) with the edge slots
    permuted by ``perm``, and the permuted edge index."""
    data = {k: jnp.asarray(v) for k, v in batch.items()
            if k not in (JK.INFO, JK.USER_LABEL)}
    out = jax.jit(lambda p, d: j_nequip.energy_network(
        spec, p, d, j_nequip.compute_edge_vec(d)))(params, data)
    idx = np.asarray(batch[JK.EDGE_IDX])[:, perm]
    return (np.asarray(out[JK.NODE_ATTR]),
            np.asarray(out[JK.EDGE_EMBEDDING])[perm],
            np.asarray(out[JK.EDGE_ATTR])[perm], idx)


def _j_embed(spec, params, onehot):
    from sevennet_finetuning_tpu.ops.linear import apply_linear, linear_spec

    es = linear_spec(JIrreps(f'{spec.num_species}x0e'),
                     spec.blocks[0].irreps_x,
                     biases=spec.use_bias_in_linear)
    p = params['onehot_to_feature_x']
    return apply_linear(es, [p[f'w{i}'] for i in range(len(p))], onehot)


@pytest.fixture(scope='module')
def narrow():
    """Both packages' run_blocks on the permuted narrow batch: node
    features, the first-order gradients of the summed readout and the
    create_graph parameter gradient."""
    cfg = _narrow_config()
    j_spec = j_build(cfg)
    params = jax.tree_util.tree_map(np.asarray,
                                    j_nequip.init_params(j_spec, seed=3))
    # a 96-atom and the 12-atom structure of ft.extxyz
    jb = _j_collate(FT, lambda s: [s[0], s[4]], TYPE_MAP)
    E = jb[JK.EDGE_IDX].shape[1]
    perm = np.random.default_rng(0).permutation(E)
    onehot, emb, edge_attr, idx = _j_blocks_inputs(
        j_spec, jax.tree_util.tree_map(jnp.asarray, params), jb, perm)
    n_node = jb[JK.POS].shape[0]
    atom_type = np.asarray(jb[JK.ATOM_TYPE])
    node_mask = np.asarray(jb[JK.NODE_MASK], np.float32)
    rng = np.random.default_rng(1)
    r_attr = rng.standard_normal(edge_attr.shape).astype(np.float32)
    r_emb = rng.standard_normal(emb.shape).astype(np.float32)

    # --- JAX ---
    def j_blocks(p, attr, em):
        x = _j_embed(j_spec, p, jnp.asarray(onehot))
        return j_nequip.run_blocks(
            j_spec, p, x, jnp.asarray(onehot), em, attr,
            jnp.asarray(idx[1]), jnp.asarray(idx[0]), n_node,
            edges_sorted=False, src_perm=None)

    def j_readout(p, attr, em):
        x = j_blocks(p, attr, em)
        _, atomic = j_nequip.readout_and_rescale(j_spec, p, x,
                                                 jnp.asarray(atom_type))
        return jnp.sum(atomic * node_mask), x

    def j_outer(p, attr, em):
        (_, x), g1 = jax.value_and_grad(j_readout, argnums=(0, 1, 2),
                                        has_aux=True)(p, attr, em)
        loss = jnp.sum(g1[1] * r_attr) + jnp.sum(g1[2] * r_emb)
        return loss, (x, g1)

    # one compiled function: features, first-order and create_graph grads
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    g2, (x, g1) = jax.jit(jax.grad(j_outer, has_aux=True))(
        jp, jnp.asarray(edge_attr), jnp.asarray(emb))
    res = {'j_x': np.asarray(x),
           'j_g1': jax.tree_util.tree_map(np.asarray, g1),
           'j_g2': jax.tree_util.tree_map(np.asarray, g2)}

    # --- port ---
    model = load_jax_params(NequIP(build_model_spec(cfg)), params)
    spec, p = model.spec, model.params
    t_attr = torch.from_numpy(edge_attr).requires_grad_(True)
    t_emb = torch.from_numpy(emb).requires_grad_(True)
    t_onehot = torch.from_numpy(onehot.copy())
    src = torch.from_numpy(np.ascontiguousarray(idx[1]))
    dst = torch.from_numpy(np.ascontiguousarray(idx[0]))

    def t_blocks():
        _, x = embed_nodes(spec, p, torch.from_numpy(atom_type),
                           torch.float32)
        return run_blocks(spec, p, x, t_onehot, t_emb, t_attr, src, dst,
                          n_node, edges_sorted=False)

    x = t_blocks()
    _, atomic = readout_and_rescale(spec, p, x, torch.from_numpy(atom_type))
    total = (atomic * torch.from_numpy(node_mask)).sum()
    leaves = [(g, n, prm) for g, names in p.items()
              for n, prm in names.items()]
    prms = [prm for _, _, prm in leaves]
    # allow_unused: the Bessel coefficients do not reach the blocks here
    # (emb is an input), nor the rescale shift the edge gradient
    g1 = torch.autograd.grad(total, [t_attr, t_emb] + prms,
                             create_graph=True, allow_unused=True)
    outer = ((g1[0] * torch.from_numpy(r_attr)).sum()
             + (g1[1] * torch.from_numpy(r_emb)).sum())
    g2 = torch.autograd.grad(outer, prms, allow_unused=True)

    def np_or_zeros(v, prm):
        return (np.zeros(tuple(prm.shape), np.float32) if v is None
                else v.detach().numpy())

    res['t_x'] = x.detach().numpy()
    res['t_g1'] = (g1[0].detach().numpy(), g1[1].detach().numpy(),
                   {(g, n): np_or_zeros(v, prm)
                    for (g, n, prm), v in zip(leaves, g1[2:])})
    res['t_g2'] = {(g, n): np_or_zeros(v, prm)
                   for (g, n, prm), v in zip(leaves, g2)}
    res['leaves'] = [(g, n) for g, n, _ in leaves]
    res['sorted_inputs'] = (model, t_onehot, emb, edge_attr, idx, perm,
                            n_node, atom_type)
    return res


def test_run_blocks_unsorted_features_match_jax(narrow):
    _close(narrow['t_x'], narrow['j_x'], FEATURE_TOL)


def test_run_blocks_unsorted_grads_match_jax(narrow):
    g_attr, g_emb, g_params = narrow['t_g1']
    j_params, j_attr, j_emb = narrow['j_g1']
    _close(g_attr, j_attr, GRAD_TOL, 'edge_attr')
    _close(g_emb, j_emb, GRAD_TOL, 'emb')
    assert len(g_params) == sum(len(v) for v in j_params.values())
    for (g, n), v in g_params.items():
        if float(np.abs(j_params[g][n]).max()) == 0.0:
            # emb is an input here: the Bessel coefficients are unused
            assert float(np.abs(v).max()) == 0.0, (g, n)
        else:
            _close(v, j_params[g][n], GRAD_TOL, f'{g}/{n}')


def test_run_blocks_unsorted_create_graph_grad_matches_jax(narrow):
    for (g, n), v in narrow['t_g2'].items():
        want = narrow['j_g2'][g][n]
        if float(np.abs(want).max()) == 0.0:
            # leaves the edge gradient does not depend on (the readout's
            # rescale shift)
            assert float(np.abs(v).max()) == 0.0, (g, n)
        else:
            _close(v, want, GRAD_TOL, f'{g}/{n}')


def test_run_blocks_unsorted_equals_sorted(narrow):
    """The same graph, dst-sorted, through the scatter-fused branch."""
    model, onehot, emb, edge_attr, idx, perm, n_node, atom_type = (
        narrow['sorted_inputs'])
    order = np.lexsort((idx[1], idx[0]))          # by dst, then src
    spec, p = model.spec, model.params
    _, x = embed_nodes(spec, p, torch.from_numpy(atom_type), torch.float32)
    with torch.no_grad():
        got = run_blocks(
            spec, p, x, onehot, torch.from_numpy(emb[order]),
            torch.from_numpy(edge_attr[order]),
            torch.from_numpy(np.ascontiguousarray(idx[1][order])),
            torch.from_numpy(np.ascontiguousarray(idx[0][order])), n_node,
            edges_sorted=True)
    _close(got, narrow['t_x'], FEATURE_TOL)


def test_run_blocks_refuses_unported_paths(narrow):
    model, onehot, emb, edge_attr, idx, _, n_node, atom_type = (
        narrow['sorted_inputs'])
    spec, p = model.spec, model.params
    _, x = embed_nodes(spec, p, torch.from_numpy(atom_type), torch.float32)
    args = (p, x, onehot, torch.from_numpy(emb), torch.from_numpy(edge_attr),
            torch.from_numpy(np.ascontiguousarray(idx[1])),
            torch.from_numpy(np.ascontiguousarray(idx[0])), n_node)
    with pytest.raises(NotImplementedError, match='A.8'):
        run_blocks(spec, *args, exchange_fn=lambda v: v)
    with pytest.raises(NotImplementedError, match='A.8'):
        run_blocks(spec, *args, halo_split={})
    with pytest.raises(NotImplementedError, match='A.5'):
        run_blocks(spec, *args, remat=True)
    for kind in ({'block_type': 'mace'}, {'block_type': 'custom'},
                 {'conv_kind': 'gaunt'}):
        bad = dataclasses.replace(spec, blocks=tuple(
            dataclasses.replace(b, **kind) for b in spec.blocks))
        with pytest.raises(NotImplementedError, match='A.9'):
            run_blocks(bad, *args)


# ---------------------------------------------------------------------------
# the full-width golden file of chip_smoke.py's unsorted phase
# ---------------------------------------------------------------------------

def test_unsorted_golden_file_is_consistent():
    gold = np.load(GOLDEN)
    E = int(gold['n_edge_slots'])
    perm = np.random.default_rng(int(gold['perm_seed'])).permutation(E)
    assert np.array_equal(gold['perm'], perm)
    assert gold['energy'].shape == (8,)
    assert gold['fij'].shape == (E, 3)
    assert gold['features'].shape[0] == 8 * 96
    assert gold['atom_type'].shape == (8 * 96,)
    for k in ('energy', 'fij', 'features'):
        assert np.all(np.isfinite(gold[k])), k


def _write_golden():
    """SevenNet-0 at full width on the batch-8 collate of ft900.extxyz,
    every edge slot permuted (numpy seed 0), through JAX
    ``run_blocks(edges_sorted=False, src_perm=None)`` on the CPU."""
    from sevennet_finetuning_tpu.ops.util import safe_norm
    from sevennet_finetuning_tpu.ops.radial import (
        bessel_basis, poly_cutoff, xplor_cutoff)
    from sevennet_finetuning_tpu.ops.spherical import spherical_harmonics
    from sevennet_finetuning_tpu.train.checkpoint import load_checkpoint

    blob = load_checkpoint(str(CKPT))
    spec = j_build(blob['config'])
    params = jax.tree_util.tree_map(jnp.asarray, blob['model_state_dict'])
    # chip_smoke.py's batch-8 collate: N = 768 exactly, bucketed edges
    batch = _j_collate(FT900, lambda s: [x for x in s if len(x) == 96][:8],
                       dict(spec.type_map), n_graph=8, n_node=8 * 96)
    E = batch[JK.EDGE_IDX].shape[1]
    seed = 0
    perm = np.random.default_rng(seed).permutation(E)
    data = {k: jnp.asarray(v) for k, v in batch.items()
            if k not in (JK.INFO, JK.USER_LABEL)}
    idx = data[JK.EDGE_IDX][:, perm]
    data_p = dict(data, **{JK.EDGE_IDX: idx,
                           JK.CELL_SHIFT: data[JK.CELL_SHIFT][perm],
                           JK.EDGE_MASK: data[JK.EDGE_MASK][perm]})
    n_node = batch[JK.POS].shape[0]
    es = spec.edge

    def energy(edge_vec):
        r = safe_norm(edge_vec)
        basis = bessel_basis(r, params['edge_embedding']['bessel_coeffs'],
                             es.cutoff)
        env = (xplor_cutoff(r, es.cutoff, es.cutoff_on)
               if es.cutoff_function == 'XPLOR'
               else poly_cutoff(r, es.cutoff, es.poly_cut_p))
        emb = basis * env[..., None]
        if es.weight_shift != 0.0 or es.weight_scale != 1.0:
            emb = (emb - es.weight_shift) * es.weight_scale
        emb = emb * data_p[JK.EDGE_MASK][..., None]
        attr = spherical_harmonics(es.lmax_edge,
                                   normalize=es.normalize_sph)(edge_vec)
        onehot = jax.nn.one_hot(data_p[JK.ATOM_TYPE], spec.num_species,
                                dtype=edge_vec.dtype)
        x = j_nequip.run_blocks(
            spec, params, _j_embed(spec, params, onehot), onehot, emb, attr,
            idx[1], idx[0], n_node, edges_sorted=False, src_perm=None)
        _, atomic = j_nequip.readout_and_rescale(spec, params, x,
                                                 data_p[JK.ATOM_TYPE])
        atomic = atomic * data_p[JK.NODE_MASK]
        e = jax.ops.segment_sum(atomic, data_p[JK.BATCH], num_segments=8)
        return e.sum(), (e, x)

    edge_vec = j_nequip.compute_edge_vec(data_p)
    (_, (e, x)), fij = jax.value_and_grad(energy, has_aux=True)(edge_vec)
    arrays = dict(perm_seed=np.int64(seed), perm=perm.astype(np.int64),
                  n_edge_slots=np.int64(E),
                  atom_type=np.asarray(batch[JK.ATOM_TYPE], np.int32),
                  energy=np.asarray(e, np.float64),
                  fij=np.asarray(fij, np.float32),
                  features=np.asarray(x, np.float32))
    GOLDEN.parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(GOLDEN, **arrays)
    print(f'wrote {GOLDEN}: energies {arrays["energy"]}')


if __name__ == '__main__':
    sys.path.insert(0, str(ROOT))
    jax.config.update('jax_platforms', 'cpu')
    _write_golden()
