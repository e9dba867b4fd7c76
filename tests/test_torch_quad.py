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
    NequIP, embed_nodes, init_params, load_jax_params, readout_and_rescale,
    run_blocks)
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
# an lmax-3 layout takes cg_quad.cu's kernels built for irrep dims up to 7
TABLE_LAYOUTS = {'small': SMALL, 'parity_lmax1': SPECS['parity_lmax1'],
                 'scalar_in': ('8x0e', '1x0e+1x1e+1x2e',
                               '8x0e+8x1e+8x2e'),
                 'lmax3': ('6x0e+3x1o+2x3o', '1x0e+1x1o+1x2e+1x3o',
                           '6x0e+6x1o+6x2e+6x3o')}


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
    walked = walk_quad_plan(tl, 'x', (g.T, sh.T, w.T), QUAD_SMALL_CFG, 4)
    assert np.all(walked[-5:] == 0.0)


# ---------------------------------------------------------------------------
# the kernel's schedule (cg_tables.quad_plan), walked on the CPU the way
# csrc/cg_quad.cu walks it, in float32
# ---------------------------------------------------------------------------

# which leg holds x, sh, w and g in each mode (cg_quad.cu's Legs)
_ROLE = {'msg': dict(X=0, S=1, W=2), 'x': dict(G=0, S=1, W=2),
         'sh': dict(G=0, X=1, W=2), 'w': dict(G=0, X=1, S=2)}


def _fma(a, b, c):
    """float32 fma: the product exact in float64, one rounding (up to a
    double rounding, which no test here resolves)."""
    f64 = functools.partial(np.asarray, dtype=np.float64)
    return (f64(a) * f64(b) + f64(c)).astype(np.float32)


def _f32(bits):
    return np.asarray(bits, np.int32).view(np.float32)


def walk_quad_plan(layout, mode, legs, cfg, n_blocks, writes=None,
                   copies=None):
    """cg_quad.cu on edge-major float32 legs: the persistent grid of
    min(tiles, ``n_blocks``) blocks, each a contiguous run of tiles; each
    tile's legs staged as agg_span's 16-byte aligned spans into the ring
    stage at quad_smem's offsets; the tile's B rows; every warp's items
    (a unit and an edge of the tile) with a lane per channel, in the
    kernel's float32 order (the sh mode from the paths' coefficients at
    the selection rule's entries); the sh partials added by the xor
    butterfly,
    then each sh column from its partials (per group its slices in order,
    the groups in order).  ``writes`` [E, d_out] counts the writes of
    each output element; ``copies`` collects (source float, destination
    float, floats, floats read from the buffer, buffer capacity) of
    every bulk copy."""
    legs = [np.ascontiguousarray(a, np.float32) for a in legs]
    E = legs[0].shape[0]
    dims = [a.shape[1] for a in legs]
    flat = [a.reshape(-1) for a in legs]
    role = _ROLE[mode]
    plan = cg_tables.quad_plan(layout, mode, cfg.tile, cfg.warps)
    sm = cg_tables.quad_smem(layout, mode, cfg, plan)
    d_out = layout.mode_dims[j_fc._MODE_OUT[mode]]
    out = np.full((E, d_out), np.nan, np.float32)
    lanes = np.arange(32)
    n_tile = -(-E // cfg.tile)
    grid = min(n_tile, n_blocks)

    def record(e, cols):
        if writes is not None:
            np.add.at(writes, (e, cols), 1)

    for blk in range(grid):
        t0, t1 = blk * n_tile // grid, (blk + 1) * n_tile // grid
        e_begin, e_end = t0 * cfg.tile, min(E, t1 * cfg.tile)
        for c in range(t1 - t0):
            e0 = e_begin + c * cfg.tile
            ne = min(cfg.tile, e_end - e0)
            pos = (c % cfg.stages) * sm.stage
            rows = []
            for f, d, cap in zip(flat, dims, sm.caps):
                a0, bulk, f1, off = cg_tables.agg_span(e0, ne, d, E * d)
                if copies is not None:
                    copies.append((a0, pos, bulk, f1 - a0, cap))
                buf = np.zeros(cap, np.float32)
                buf[:f1 - a0] = f[a0:f1]
                rows.append(buf[off:off + ne * d].reshape(ne, d))
                pos += cap
            B = np.zeros((ne, max(plan.b_row, 1)), np.float32)
            for ent in plan.entries:
                b = np.zeros(ne, np.float32)
                for st in range(ent[1]):
                    b = _fma(_f32(ent[3 + 2 * st]),
                             rows[role['S']][:, ent[2 + 2 * st]], b)
                B[:, ent[0]] = b
            red = np.zeros((ne, max(plan.n_red, 1)), np.float32)
            for it in range(plan.warp_start[-1]):
                q, le = plan.items[it]
                if le >= ne:
                    continue
                x_off, d1, mul, u0, lo, hi, r = plan.units[q]
                u = u0 + lanes
                act = u < mul
                uc = np.where(act, u, mul - 1)
                e = e0 + le
                row = {k: rows[v][le] for k, v in role.items()}
                if mode in ('msg', 'w'):
                    msg_off, w_off, d3, b_off = plan.paths[lo][:4]
                    bb = B[le, b_off:b_off + d1 * d3]
                    xv = [row['X'][x_off + i * mul + uc] for i in range(d1)]
                    m = []
                    for k in range(d3):
                        mk = bb[k * d1] * xv[0]
                        for i in range(1, d1):
                            mk = mk + bb[k * d1 + i] * xv[i]
                        m.append(mk)
                    if mode == 'msg':
                        wv = row['W'][w_off + uc]
                        for k in range(d3):
                            out[e, (msg_off + k * mul + u)[act]] = (
                                m[k] * wv)[act]
                            record(e, (msg_off + k * mul + u)[act])
                    else:
                        acc = m[0] * row['G'][msg_off + uc]
                        for k in range(1, d3):
                            acc = acc + m[k] * row['G'][msg_off + k * mul + uc]
                        out[e, (w_off + u)[act]] = acc[act]
                        record(e, (w_off + u)[act])
                elif mode == 'x':
                    acc = [np.zeros(32, np.float32) for _ in range(d1)]
                    for g in range(lo, hi):
                        t = [np.zeros(32, np.float32) for _ in range(d1)]
                        for p in range(*plan.groups[g][2:4]):
                            msg_off, w_off, d3, b_off = plan.paths[p][:4]
                            wv = row['W'][w_off + uc]
                            for k in range(d3):
                                gw = row['G'][msg_off + k * mul + uc] * wv
                                for i in range(d1):
                                    t[i] = _fma(B[le, b_off + k * d1 + i],
                                                gw, t[i])
                        acc = [a + b for a, b in zip(acc, t)]
                    for i in range(d1):
                        out[e, (x_off + i * mul + u)[act]] = acc[i][act]
                        record(e, (x_off + i * mul + u)[act])
                else:  # sh: the item's edge and the next
                    _sh_pair(plan, rows, role, red, le, ne, lo, d1, mul,
                             x_off, r, act, uc, lanes)
            if mode == 'sh':
                for le in range(ne):
                    for col in range(d_out):
                        v = np.float32(0)
                        for first, n, stride in plan.col_parts[
                                plan.col_start[col]:plan.col_start[col + 1]]:
                            s_ = red[le, first]
                            for t_ in range(1, n):
                                s_ = s_ + red[le, first + t_ * stride]
                            v = v + s_
                        out[e0 + le, col] = v
                        record(e0 + le, col)
    return out


def _sh_pair(plan, rows, role, red, le, ne, lo, d1, mul, x_off, r, act,
             uc, lanes):
    """An sh item: its edge and the next (if the tile has it), each
    lane's part from the paths' coefficients at the selection rule's
    entries (``w3j_pattern``, in k order), the xor butterfly, lane 0's
    sum to the edge's partials."""
    _, d2, pb, pe = plan.groups[lo]
    for le in range(le, min(le + 2, ne)):
        row = {k: rows[v][le] for k, v in role.items()}
        xv = [np.where(act, row['X'][x_off + i * mul + uc],
                       np.float32(0)) for i in range(d1)]
        acc = [np.zeros(32, np.float32) for _ in range(d2)]
        for p in range(pb, pe):
            msg_off, w_off, d3, _, c_off = plan.paths[p]
            wv = row['W'][w_off + uc]
            at = {e: q for q, e in enumerate(
                cg_tables.w3j_pattern(d1, d2, d3))}
            coef = _f32(plan.coef[c_off:c_off + len(at)])
            gw = [row['G'][msg_off + k * mul + uc] * wv
                  for k in range(d3)]
            t = [np.zeros(32, np.float32) for _ in range(d2)]
            for i in range(d1):
                for j in range(d2):
                    ks = [k for k in range(d3) if (i, j, k) in at]
                    if not ks:
                        continue
                    sj = np.zeros(32, np.float32)
                    for k in ks:
                        sj = _fma(coef[at[i, j, k]], gw[k], sj)
                    t[j] = _fma(xv[i], sj, t[j])
            acc = [a_ + t_ for a_, t_ in zip(acc, t)]
        for j in range(d2):
            v = acc[j]
            for off in (16, 8, 4, 2, 1):
                v = v + v[lanes ^ off]
            red[le, r + j] = v[0]


def _check_copies(copies, cfg, sm):
    """Every bulk copy: source, destination and size in whole 16-byte
    units, the floats read from the buffer within its capacity, the
    destination inside the ring."""
    for a0, dst, bulk, used, cap in copies:
        assert a0 % 4 == 0 and dst % 4 == 0 and bulk % 4 == 0
        assert bulk <= used <= cap
        assert dst + cap <= cfg.stages * sm.stage
    assert sm.b_base % 4 == 0 and sm.red_base % 4 == 0


def _walk_and_check(tl, mode, E, cfg, n_blocks, seed, tol=MODE_TOL):
    """The walk on random legs: every output element written once, every
    copy aligned, within ``tol`` x max of the plain version."""
    legs = [a.T for a in _legs(tl, mode, E, seed=seed)]
    want = quad_plain(mode, *(torch.from_numpy(a) for a in legs), tl)
    writes = np.zeros(tuple(want.shape), np.int64)
    copies = []
    got = walk_quad_plan(tl, mode, legs, cfg, n_blocks, writes, copies)
    assert (writes == 1).all(), (mode, np.unique(writes))
    plan = cg_tables.quad_plan(tl, mode, cfg.tile, cfg.warps)
    _check_copies(copies, cfg, cg_tables.quad_smem(tl, mode, cfg, plan))
    _close(got, want.numpy(), tol, mode)
    return got


# a small launch: several tiles and blocks, a partial last tile, fewer
# warps than items
QUAD_SMALL_CFG = cg_tables.QuadConfig(tile=3, stages=2, warps=3)


@pytest.mark.parametrize('mode', MODES)
def test_quad_plan_writes_each_column_once(mode):
    """Each (edge, output column) written once and every bulk copy
    16-byte aligned, at SevenNet-0's layouts (blocks 0, 1-3, 4) under the
    launch rule and a small launch, at an odd E (a partial last tile)."""
    from sevennet_finetuning_tpu_torch.ops.fused_conv_kernel import (
        quad_config)

    spec = _sevennet0_spec()
    for block in (0, 1, 4):
        tl = layout_from_spec(spec.blocks[block].conv_tp)
        # every unit once for each edge of a tile (sh: each edge pair)
        plan = cg_tables.quad_plan(tl, mode, 4, 4)
        step = cg_tables.QUAD_SH_EDGES if mode == 'sh' else 1
        assert sorted(map(tuple, plan.items.tolist())) == [
            (q, le) for q in range(len(plan.units))
            for le in range(0, 4, step)]
        for cfg, E, n_blocks in ((quad_config(tl, mode), 13, 2),
                                 (QUAD_SMALL_CFG, 11, 3)):
            _walk_and_check(tl, mode, E, cfg, n_blocks, seed=80 + block)


@pytest.mark.parametrize('name', sorted(TABLE_LAYOUTS))
@pytest.mark.parametrize('mode', MODES)
def test_quad_plan_walk_matches_plain(name, mode):
    _, tl = _layouts(TABLE_LAYOUTS[name])
    _walk_and_check(tl, mode, 13, QUAD_SMALL_CFG, 2,
                    seed=20 + MODES.index(mode))


@functools.lru_cache(maxsize=None)
def _sevennet0_spec():
    from sevennet_finetuning_tpu_torch.train.checkpoint import (
        load_checkpoint)

    return build_model_spec(load_checkpoint(str(CKPT))['config'])


@pytest.fixture(scope='module')
def sevennet0_spec():
    return _sevennet0_spec()


@pytest.mark.parametrize('block', [0, 1, 4])
def test_sevennet0_quad_plan_walk_matches_plain(sevennet0_spec, block):
    from sevennet_finetuning_tpu_torch.ops.fused_conv_kernel import (
        quad_config)

    tl = layout_from_spec(sevennet0_spec.blocks[block].conv_tp)
    for mode in MODES:
        _walk_and_check(tl, mode, 5, quad_config(tl, mode), 132,
                        seed=30 + block)


@pytest.mark.parametrize('block', [0, 1, 4])
def test_quad_sh_combine_matches_cg_modes(sevennet0_spec, block):
    """The sh mode's order (lane partials over each group's paths and
    couplings, the xor butterfly, then per column the groups' slices in
    order and the groups in order) against cg_modes, on legs whose
    cotangent and weights vary over several orders of magnitude."""
    tl = layout_from_spec(sevennet0_spec.blocks[block].conv_tp)
    E = 4
    rng = np.random.default_rng(90 + block)
    g, x, w = (rng.standard_normal((E, tl.mode_dims[leg])).astype(np.float32)
               * np.exp(rng.uniform(-3, 3, (1, tl.mode_dims[leg])))
               .astype(np.float32)
               for leg in _MODE_LEGS['sh'])
    want = quad_plain('sh', *(torch.from_numpy(a) for a in (g, x, w)), tl)
    plan = cg_tables.quad_plan(tl, 'sh', 2, 4)
    # every sh column gets one part per group that covers it
    n_groups = {c: sum(1 for grp in tl.groups
                       if grp.sh_off <= c < grp.sh_off + grp.d2)
                for c in range(tl.dim_sh)}
    assert [int(n) for n in np.diff(plan.col_start)] == [
        n_groups[c] for c in range(tl.dim_sh)]
    got = walk_quad_plan(tl, 'sh', (g, x, w),
                         cg_tables.QuadConfig(tile=2, stages=2, warps=4), 2)
    _close(got, want.numpy(), MODE_TOL)


def _rule_layouts():
    """SevenNet-0's three conv layouts and the lmax-3 layout (irrep dims
    of 7: the kernels built for them)."""
    spec = _sevennet0_spec()
    out = {f'block {b}': layout_from_spec(spec.blocks[b].conv_tp)
           for b in (0, 1, 4)}
    out['lmax3'] = _layouts(TABLE_LAYOUTS['lmax3'])[1]
    return out


@pytest.mark.parametrize('mode', MODES)
def test_quad_config_fits_the_card(mode):
    """The launch rule: two stages, the mode's warps (4 for sh tiles of
    one edge), a tile of at least one edge whose block fits the card's
    shared memory (227 KB less the kernel's static 64 bytes); at the
    interior block tiles of about the rule's stage bytes (one edge in the
    x and sh modes)."""
    from sevennet_finetuning_tpu_torch.ops import fused_conv_kernel as fck

    for name, tl in _rule_layouts().items():
        cfg = fck.quad_config(tl, mode)
        plan = cg_tables.quad_plan(tl, mode, cfg.tile, cfg.warps)
        sm = cg_tables.quad_smem(tl, mode, cfg, plan)
        assert cfg.stages == fck.QUAD_STAGES == 2
        assert cfg.warps == (fck.QUAD_SH_ONE_EDGE_WARPS
                             if mode == 'sh' and cfg.tile == 1
                             else fck.QUAD_RULE[mode][1])
        assert cfg.tile >= 1 and sm.nbytes <= cg_tables.QUAD_SMEM_MAX
        assert sm.nbytes + 64 <= 232448, name
        assert cg_tables.quad_max_dim(tl) == (7 if name == 'lmax3' else 5)
    interior = fck.quad_config(_rule_layouts()['block 1'], mode)
    assert interior.tile == {'msg': 3, 'x': 1, 'sh': 1, 'w': 2}[mode]


@pytest.mark.parametrize('mode', MODES)
def test_quad_cuda_refuses_cpu_tensors(mode):
    """On CPU tensors the kernel's wrapper raises before any launch is
    counted; ``quad`` runs the plain version there and counts nothing."""
    from sevennet_finetuning_tpu_torch.ops import _cuda
    from sevennet_finetuning_tpu_torch.ops import fused_conv_kernel as fck

    _, tl = _layouts(SMALL)
    legs = [torch.from_numpy(a.T.copy())
            for a in _legs(tl, mode, 5, seed=95)]
    before = (dict(_cuda.LAUNCHES), dict(fck.MODE_LAUNCHES))
    with pytest.raises(ValueError, match='CUDA'):
        fck.quad_cuda(mode, *legs, tl)
    assert torch.equal(fck.quad(mode, *legs, tl),
                       quad_plain(mode, *legs, tl))
    assert (dict(_cuda.LAUNCHES), dict(fck.MODE_LAUNCHES)) == before


@pytest.mark.parametrize('mode', MODES)
def test_quad_plan_packed_sections(mode):
    """QuadPlan.packed: each section at its meta offset, the items 8-byte
    aligned (read as int2), the sh coefficients and every path's B and
    coefficient offsets 16-byte aligned (read as float4s)."""
    for name, tl in _rule_layouts().items():
        plan = cg_tables.quad_plan(tl, mode, 3, 4)
        flat, meta = plan.packed()
        sections = (plan.units, plan.groups, plan.paths, plan.entries,
                    plan.warp_start, plan.items, plan.col_start,
                    plan.col_parts, plan.coef)
        assert meta[0] == len(plan.entries)
        assert meta[-2] == len(plan.coef) and meta[-1] == len(flat)
        for off, arr in zip(meta[1:-2], sections):
            arr = arr.reshape(-1)
            assert np.array_equal(flat[off:off + len(arr)], arr), name
        assert meta[6] % 2 == 0 and meta[9] % 4 == 0
        assert (plan.paths[:, 3] % 4 == 0).all()
        assert (plan.paths[:, 4] % 4 == 0).all()
        assert plan.b_row % 4 == 0
        assert len(plan.coef) == (0 if mode != 'sh' else sum(
            -(-len(cg_tables.w3j_pattern(g.d1, g.d2, p.d_out)) // 4) * 4
            for g in tl.groups for p in g.paths))


@pytest.mark.parametrize('l1', [0, 1, 2, 3])
def test_w3j_pattern_holds_every_coupling(l1):
    """The selection rule cg_quad.cu compiles in: it holds every nonzero
    of each real-basis Wigner-3j block with l1 and l2, l3 <= 3, and is
    exactly the nonzero set for l <= 2."""
    from sevennet_finetuning_tpu_torch.ops.wigner import wigner_3j

    for l2 in range(4):
        for l3 in range(abs(l1 - l2), min(l1 + l2, 3) + 1):
            nz = {tuple(int(v) for v in e) for e in np.argwhere(
                np.abs(np.asarray(wigner_3j(l1, l2, l3))) > 1e-12)}
            pat = set(cg_tables.w3j_pattern(2 * l1 + 1, 2 * l2 + 1,
                                            2 * l3 + 1))
            assert nz <= pat, (l1, l2, l3)
            if max(l1, l2, l3) <= 2:
                assert nz == pat, (l1, l2, l3)


@pytest.mark.parametrize('bad', ['mode', 'tile', 'warps', 'stages'])
def test_quad_plan_rejects_bad_launch(bad):
    _, tl = _layouts(SMALL)
    args = dict(mode='msg', tile=2, warps=4, stages=2)
    args[bad] = {'mode': 'agg', 'tile': 0, 'warps': 17, 'stages': 1}[bad]
    with pytest.raises(ValueError, match='cg_quad'):
        plan = cg_tables.quad_plan(tl, args['mode'], args['tile'],
                                   args['warps'])
        cg_tables.quad_smem(tl, args['mode'], cg_tables.QuadConfig(
            args['tile'], args['stages'], args['warps']), plan)


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
    # an identity exchange without a halo split is the plain path
    for edges_sorted in (True, False):
        assert torch.equal(
            run_blocks(spec, *args, exchange_fn=lambda v: v,
                       edges_sorted=edges_sorted),
            run_blocks(spec, *args, edges_sorted=edges_sorted))
    # per-block remat gives the plain path's features, both branches
    for edges_sorted in (True, False):
        assert torch.equal(
            run_blocks(spec, *args, remat=True, edges_sorted=edges_sorted),
            run_blocks(spec, *args, edges_sorted=edges_sorted))
    # the MACE and Gaunt families take the unsorted path too, and agree
    # with their sorted one on the same graph
    order = np.lexsort((idx[1], idx[0]))
    for itype in ('mace', 'gaunt', 'gaunt_gate'):
        fam = build_model_spec({**_narrow_config(), K.IS_PARITY: True,
                                K.NODE_FEATURE_MULTIPLICITY: 4,
                                K.INTERACTION_TYPE: itype})
        fp = load_jax_params(NequIP(fam), init_params(fam, 0)).params
        _, fx = embed_nodes(fam, fp, torch.from_numpy(atom_type),
                            torch.float32)
        outs = []
        with torch.no_grad():
            for o, srt in ((np.arange(len(order)), False), (order, True)):
                outs.append(run_blocks(
                    fam, fp, fx, onehot, torch.from_numpy(emb[o]),
                    torch.from_numpy(edge_attr[o]),
                    torch.from_numpy(np.ascontiguousarray(idx[1][o])),
                    torch.from_numpy(np.ascontiguousarray(idx[0][o])),
                    n_node, edges_sorted=srt))
        assert torch.isfinite(outs[0]).all()
        _close(outs[0], outs[1].numpy(), FEATURE_TOL, itype)


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
