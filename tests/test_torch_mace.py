"""The port's MACE family against the JAX package's, and the families'
full-width golden file.

Narrow setups (the JAX tests' 24-atom Si-O cell, channel 4) on the same
numpy-seeded inputs through both packages:

- ``u_matrix`` for couplings up to l = 3 and nu 1-3 (1e-6 max-abs);
- ``apply_sym_contraction`` (1e-5 relative) and its gradient;
- ``init_params`` bit for bit;
- energy, forces and stress of the whole model (1e-5 relative to the
  largest JAX magnitude) and the port's rotation equivariance;
- one train step (loss terms 1e-5 relative, per-leaf gradients 1e-4 of
  the leaf's max|g|);
- ``main train`` with ``interaction_type: mace`` (one epoch) against the
  JAX CLI's log;
- the CG kernels' numpy walks at MACE-MP-0 medium's convolution layouts
  (l = 3 filter, 128 channels at l = 0..3) against their plain versions.

The JAX side runs under ``jax.enable_x64(False)`` (the test session
turns x64 on, which would make JAX's U tensors float64).

``golden/families_jax_cpu.npz`` holds the three full-width family
configs (``FAMILY_CONFIGS``, with the statistics of ft900.extxyz that the
JAX pipeline computes), JAX-CPU serving results for ft.extxyz and three
train steps of MACE and Gaunt on ft900 structure 0.  ``chip_smoke.py``'s
families phase holds the card against it.  Regenerate it with

    PYTHONPATH=. python tests/test_torch_mace.py
"""

import json
import os
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation

from sevennet_finetuning_tpu.irreps import Irreps as JIrreps
from sevennet_finetuning_tpu.model.build import build_model_spec as j_build
from sevennet_finetuning_tpu.model.nequip import (
    apply_model as j_apply_model,
    init_params as j_init,
)
from sevennet_finetuning_tpu.ops import symmetric_contraction as j_sc
from sevennet_finetuning_tpu_torch import keys as K
from sevennet_finetuning_tpu_torch.irreps import Irreps
from sevennet_finetuning_tpu_torch.model.build import build_model_spec
from sevennet_finetuning_tpu_torch.model.nequip import (
    NequIP,
    apply_model,
    batch_to_torch,
    init_params,
    load_jax_params,
)
from sevennet_finetuning_tpu_torch.ops import symmetric_contraction as t_sc

torch.set_num_threads(2)
ROOT = Path(__file__).resolve().parent.parent
FT = ROOT / 'experiments/ft_reewc/data/ft.extxyz'
FT900 = ROOT / 'experiments/ft_reewc_900/data/ft900.extxyz'
GOLDEN = ROOT / 'sevennet_finetuning_tpu_torch/golden/families_jax_cpu.npz'
RTOL = 1e-5
GRAD_TOL = 1e-4

# the full-width configurations of the families golden (weights from
# init_params(spec, 0); the statistics are added from ft900.extxyz).
# mace_mp0_medium_widths: the repo's mace interaction at MACE-MP-0
# "medium"'s widths (Batatia et al., arXiv:2401.00096: hidden
# 128x0e+128x1o, max_ell 3, correlation 3, 2 interactions, r_max 6 A,
# 8 Bessel / p = 5 cutoff, radial MLP [64, 64, 64]); not MACE-MP-0
# itself, whose readout heads differ.  gaunt(_gate)_sevennet0_widths:
# SevenNet-0's trunk (channel 128, lmax 2, 5 convolutions, cutoff 5 A,
# radial MLP [64, 64], linear self-connection) with the Gaunt convolution
# of Luo et al. (arXiv:2401.10216), parity on (the Gaunt ops need every
# l).  gaunt is cut to 3 convolutions: its product basis is cubic in x
# with standard-normal weights, so at init the features grow ~x^3 a
# block (1.9e3 after block 1, 1.8e8 after block 2, 1.1e23 after block 3
# on ft.extxyz's 12-atom cell) and block 4 overflows float32 -- NaN
# energies in both packages at 5 convolutions
FAMILY_CONFIGS = {
    'mace_mp0_medium_widths': {
        K.INTERACTION_TYPE: 'mace', K.NODE_FEATURE_MULTIPLICITY: 128,
        K.LMAX_EDGE: 3, K.LMAX_NODE: 1, K.IS_PARITY: True,
        K.NUM_CONVOLUTION: 2, K.CUTOFF: 6.0, K.CORRELATION: 3,
        K.RADIAL_BASIS: {K.RADIAL_BASIS_NAME: 'bessel',
                         K.BESSEL_BASIS_NUM: 8},
        K.CUTOFF_FUNCTION: {K.CUTOFF_FUNCTION_NAME: 'poly_cut',
                            K.POLY_CUT_P: 5},
        K.CONVOLUTION_WEIGHT_NN_HIDDEN_NEURONS: [64, 64, 64],
        K.SELF_CONNECTION_TYPE: 'nequip',
    },
    'gaunt_sevennet0_widths': {
        K.INTERACTION_TYPE: 'gaunt', K.NODE_FEATURE_MULTIPLICITY: 128,
        K.LMAX: 2, K.IS_PARITY: True, K.NUM_CONVOLUTION: 3, K.CUTOFF: 5.0,
        K.CORRELATION: 3, K.CONVOLUTION_WEIGHT_NN_HIDDEN_NEURONS: [64, 64],
        K.SELF_CONNECTION_TYPE: 'linear',
    },
    'gaunt_gate_sevennet0_widths': {
        K.INTERACTION_TYPE: 'gaunt_gate', K.NODE_FEATURE_MULTIPLICITY: 128,
        K.LMAX: 2, K.IS_PARITY: True, K.NUM_CONVOLUTION: 5, K.CUTOFF: 5.0,
        K.CORRELATION: 3, K.CONVOLUTION_WEIGHT_NN_HIDDEN_NEURONS: [64, 64],
        K.SELF_CONNECTION_TYPE: 'linear',
    },
}
FAMILY_TYPE_MAP = {72: 0, 8: 1}
# the families trained in the golden, and their recipe: the reEWC
# recipe's loss and weights (train/recipe.py) without EWC, adam at a
# constant LR, three steps on ft900 structure 0 (batch 1)
FAMILY_TRAINED = ('mace_mp0_medium_widths', 'gaunt_sevennet0_widths')
FAMILY_TRAIN = {
    K.LOSS: 'Huber', K.LOSS_PARAM: {'delta': 0.01}, K.FORCE_WEIGHT: 1.0,
    K.STRESS_WEIGHT: 0.01, K.IS_TRAIN_STRESS: True, K.OPTIMIZER: 'adam',
    K.OPTIM_PARAM: {'lr': 1e-4}, K.SCHEDULER: 'constant',
    K.SCHEDULER_PARAM: {},
    K.ERROR_RECORD: [['Energy', 'RMSE'], ['Force', 'RMSE'],
                     ['Stress', 'RMSE'], ['TotalLoss', 'None']],
}
FAMILY_TRAIN_STEPS = 3
TRAIN_TERMS = ('Total', 'Energy', 'Force', 'Stress')


def family_config(name, stats):
    """The flat model config of a family, with the type map and the
    statistics ({cutoff: (shift, scale, denominator)})."""
    cfg = dict(FAMILY_CONFIGS[name])
    shift, scale, denom = stats[str(cfg[K.CUTOFF])]
    cfg.update({K.NUM_SPECIES: len(FAMILY_TYPE_MAP),
                K.TYPE_MAP: dict(FAMILY_TYPE_MAP), K.SHIFT: shift,
                K.SCALE: scale, K.CONV_DENOMINATOR: denom})
    return cfg


def _rel_close(got, want, rtol=RTOL, name=''):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= rtol * scale, (name, err, scale)


# --- narrow setups -----------------------------------------------------------

@pytest.fixture(autouse=True, scope='module')
def _ckdtree():
    """Both packages on the scipy neighbor list (the native builder orders
    a node's edges otherwise)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv('SEVENN_NO_NATIVE', '1')
        yield


def narrow_cell(n=24, box=9.0, seed=0):
    """The JAX tests' random Si-O cell: (species, positions, cell)."""
    rng = np.random.default_rng(seed)
    return (['Si' if i % 2 else 'O' for i in range(n)],
            rng.uniform(0, box, (n, 3)), np.eye(3) * box)


def narrow_config(itype, **over):
    cfg = {K.NUM_SPECIES: 2, K.TYPE_MAP: {8: 0, 14: 1},
           K.NODE_FEATURE_MULTIPLICITY: 4, K.LMAX: 2,
           K.NUM_CONVOLUTION: 2, K.CUTOFF: 3.5, K.IS_PARITY: True,
           K.INTERACTION_TYPE: itype, K.CORRELATION: 3,
           K.CONV_DENOMINATOR: 10.0, K.SHIFT: -2.0, K.SCALE: 1.0}
    cfg.update(over)
    return cfg


def narrow_batches(cfg, cell=None, forces=False):
    """The narrow cell collated by both packages (JAX jnp dict, port
    numpy dict); ``forces`` adds seeded energy, force and stress labels."""
    from sevennet_finetuning_tpu.data.vasp import Structure as JStructure
    from sevennet_finetuning_tpu.model import graph as j_graph
    from sevennet_finetuning_tpu_torch.data.vasp import Structure
    from sevennet_finetuning_tpu_torch.model import graph

    species, pos, box = cell or narrow_cell()
    labels = {}
    if forces:
        rng = np.random.default_rng(7)
        labels = dict(energy=-3.0 * len(species),
                      forces=rng.normal(size=(len(species), 3)),
                      stress=rng.normal(size=6) * 1e-3)
    out = []
    for S, gm in ((JStructure, j_graph), (Structure, graph)):
        s = S(species=list(species), pos=pos.copy(), cell=box.copy(),
              **labels)
        g = gm.structure_to_graph(s, cfg[K.CUTOFF], cfg[K.TYPE_MAP])
        out.append(gm.collate([g], n_node=len(species),
                              n_edge=g[K.EDGE_IDX].shape[1], n_graph=1))
    jb, tb = out
    jb = {k: jnp.asarray(v) for k, v in jb.items()
          if k not in (K.INFO, K.USER_LABEL)}
    return jb, tb


def port_and_jax(cfg, seed=0, t_cfg=None):
    """(JAX spec, JAX params as numpy, port model loaded with them); the
    port's own init_params must give the same arrays.  ``t_cfg``: the
    port's config where it differs (a plugin of its own)."""
    t_cfg = t_cfg or cfg
    j_spec = j_build(cfg)
    with jax.enable_x64(False):
        params = jax.tree_util.tree_map(np.asarray, j_init(j_spec, seed))
    mine = init_params(build_model_spec(t_cfg), seed)
    assert set(mine) == set(params)
    for g in params:
        assert set(mine[g]) == set(params[g]), g
        for n, v in params[g].items():
            assert mine[g][n].dtype == v.dtype, (g, n)
            assert np.array_equal(mine[g][n], v), (g, n)
    model = load_jax_params(NequIP(build_model_spec(t_cfg)), params)
    return j_spec, params, model


def check_model_matches_jax(cfg, seed=0, t_cfg=None):
    """Energy, forces and stress of the narrow cell, both packages."""
    j_spec, params, model = port_and_jax(cfg, seed, t_cfg)
    model.requires_grad_(False)
    jb, tb = narrow_batches(cfg)
    with jax.enable_x64(False):
        want = jax.jit(lambda p, b: j_apply_model(j_spec, p, b))(
            jax.tree_util.tree_map(jnp.asarray, params), jb)
        want = jax.tree_util.tree_map(np.asarray, want)
    got = apply_model(model, batch_to_torch(tb, 'cpu'))
    for key in (K.PRED_TOTAL_ENERGY, K.PRED_FORCE, K.PRED_STRESS):
        _rel_close(got[key], want[key], name=key)
    return model, tb


def check_rotation_equivariance(model, tb, seed=4):
    """The port alone: E invariant, forces rotate, under a random
    rotation of positions and cell."""
    R = Rotation.random(random_state=seed).as_matrix()
    out = apply_model(model, batch_to_torch(tb, 'cpu'))
    rb = dict(tb)
    rb[K.POS] = (tb[K.POS] @ R.T).astype(tb[K.POS].dtype)
    rb[K.CELL] = (tb[K.CELL] @ R.T).astype(tb[K.CELL].dtype)
    rot = apply_model(model, batch_to_torch(rb, 'cpu'))
    _rel_close(rot[K.PRED_TOTAL_ENERGY], out[K.PRED_TOTAL_ENERGY].numpy(),
               name='energy')
    _rel_close(rot[K.PRED_FORCE], out[K.PRED_FORCE].numpy() @ R.T,
               rtol=1e-4, name='forces')


def check_train_step_matches_jax(cfg, t_cfg=None, terms=TRAIN_TERMS):
    """One train step of the narrow cell at FAMILY_TRAIN's recipe (the
    configs' own loss where they set one), both packages: the loss terms
    ``terms`` and every leaf's gradient; returns the port's Trainer."""
    from sevennet_finetuning_tpu.train.trainer import Trainer as JTrainer
    from sevennet_finetuning_tpu_torch.train.trainer import Trainer
    from tests.test_torch_train import jax_steps, port_steps

    cfg = {**FAMILY_TRAIN, **cfg}
    t_cfg = {**FAMILY_TRAIN, **(t_cfg or cfg)}
    j_spec, params, model = port_and_jax(cfg, t_cfg=t_cfg)
    jb, tb = narrow_batches(cfg, forces=True)
    with jax.enable_x64(False):
        jt = JTrainer(j_spec, jax.tree_util.tree_map(jnp.asarray, params),
                      cfg)
        want_rows, want_g, _ = jax_steps(
            jt, [{k: np.asarray(v) for k, v in jb.items()}], ['train'])
    trainer = Trainer(model, t_cfg, device='cpu')
    got_rows, got_g = port_steps(trainer, [tb])
    for k in terms:
        _rel_close(np.float64(got_rows[0][k]), np.float64(want_rows[0][k]),
                   name=k)
    for g, names in want_g.items():
        for n, v in names.items():
            _rel_close(got_g[g][n], v, rtol=GRAD_TOL, name=f'{g}/{n}')
    return trainer


# --- symmetric contraction ---------------------------------------------------

COUPLINGS = ('1x0e+1x1o', '1x0e+1x1e+1x2e', '1x0e+1x1o+1x2e+1x3o')


@pytest.mark.parametrize('coupling', COUPLINGS)
def test_u_matrix_matches_jax(coupling):
    tc, jc = Irreps(coupling), JIrreps(coupling)
    for (_, t_ir), (_, j_ir) in zip(tc, jc):
        for nu in (1, 2, 3):
            got = t_sc.u_matrix(tc, t_ir, nu)
            want = j_sc.u_matrix(jc, j_ir, nu)
            assert got.shape == want.shape
            assert np.abs(got - want).max(initial=0.0) <= 1e-6


@pytest.mark.parametrize('irreps_in,irreps_out', [
    ('4x0e+4x1o+4x2e+4x3o', '4x0e+4x1o'),
    ('3x0e+3x1e+3x2e', '3x0e'),
])
def test_sym_contraction_matches_jax(irreps_in, irreps_out):
    """Value and the gradient of a seeded projection, both packages."""
    j_spec = j_sc.sym_contraction_spec(JIrreps(irreps_in),
                                       JIrreps(irreps_out), 3, 2)
    t_spec = t_sc.sym_contraction_spec(Irreps(irreps_in),
                                       Irreps(irreps_out), 3, 2)
    rng = np.random.default_rng(3)
    w = j_sc.init_sym_contraction(j_spec, rng)
    assert {k: v.shape for k, v in w.items()} == t_sc.sym_contraction_shapes(
        t_spec)
    x = rng.normal(size=(6, Irreps(irreps_in).dim)).astype(np.float32)
    attr = np.eye(2, dtype=np.float32)[rng.integers(0, 2, 6)]
    proj = rng.normal(size=(6, Irreps(irreps_out).dim)).astype(np.float32)
    with jax.enable_x64(False):
        def f(x_):
            out = j_sc.apply_sym_contraction(j_spec, w, x_,
                                             jnp.asarray(attr))
            return jnp.sum(out * proj), out

        (_, want), want_g = jax.value_and_grad(f, has_aux=True)(
            jnp.asarray(x))
    xt = torch.tensor(x, requires_grad=True)
    got = t_sc.apply_sym_contraction(
        t_spec, {k: torch.tensor(v) for k, v in w.items()}, xt,
        torch.tensor(attr))
    (got * torch.tensor(proj)).sum().backward()
    _rel_close(got, np.asarray(want))
    _rel_close(xt.grad, np.asarray(want_g))


# --- the MACE model ----------------------------------------------------------

def test_mace_model_matches_jax():
    cfg = narrow_config('mace', **{K.LMAX_EDGE: 3, K.LMAX_NODE: 1,
                                   K.SELF_CONNECTION_TYPE: 'nequip'})
    spec = build_model_spec(cfg)
    assert [b.block_type for b in spec.blocks] == ['mace', 'mace']
    model, tb = check_model_matches_jax(cfg)
    check_rotation_equivariance(model, tb)


def test_mace_output_parity_is_asserted():
    """MACE's outputs must be spherical-harmonics-like (p = (-1)^l)."""
    from sevennet_finetuning_tpu_torch.model.nequip import build_mace_block

    x = Irreps('4x0e')
    with pytest.raises(ValueError, match='spherical-harmonics-like'):
        build_mace_block(0, x, Irreps('1x0e+1x1o'), Irreps('4x0e+4x1o'),
                         Irreps('4x0e+4x1e'), 3, 2, (8,), 8, 'silu',
                         'linear', False)


def test_mace_train_step_matches_jax():
    check_train_step_matches_jax(narrow_config('mace'))


# --- the CG kernels' walks at MACE-MP-0 medium's layouts ----------------------

@pytest.fixture(scope='module')
def mace_layouts():
    """The two convolution layouts of mace_mp0_medium_widths (block 0:
    128x0e x an l <= 3 filter; block 1: 128x0e+128x1o, ten output
    chunks), both packages."""
    from sevennet_finetuning_tpu.ops import fused_conv as j_fc
    from sevennet_finetuning_tpu_torch.ops.fused_conv import layout_from_spec

    cfg = family_config('mace_mp0_medium_widths',
                        {'6.0': (0.0, 1.0, 30.0)})
    j_spec, t_spec = j_build(cfg), build_model_spec(cfg)
    return [(j_fc.layout_from_spec(jb.conv_tp),
             layout_from_spec(tb.conv_tp))
            for jb, tb in zip(j_spec.blocks, t_spec.blocks)]


@pytest.mark.parametrize('block', [0, 1])
def test_mace_layouts_walk_agg_and_multi(mace_layouts, block):
    """cg_agg.cu's walk at its launch rule's config and cg_multi's one
    pass at every job set of the first-order backward, at MACE's l = 3
    layouts, against the plain versions (7 edges into 3 nodes, the last
    three edges sentinels)."""
    from sevennet_finetuning_tpu_torch.ops.fused_conv_agg import (
        agg_config, agg_plain)
    from sevennet_finetuning_tpu_torch.ops.fused_conv_multi import (
        multi_plain)
    from tests.test_torch_cg_node import walk_agg_plan
    from tests.test_torch_double_backward import (
        MULTI_JOB_SETS, _pool_data, walk_multi_plan)

    _, tl = mace_layouts[block]
    N, E = 3, 7
    ybar, pool, dst = _pool_data(tl, E, N, seed=40 + block)
    x, sh, w = pool[:3]
    want = agg_plain(*(torch.from_numpy(a) for a in (x, sh, w, dst)), tl,
                     N).numpy()
    got = walk_agg_plan(tl, x, sh, w, dst, N, agg_config(tl))
    _rel_close(got, want, rtol=2e-6)
    for jobs in MULTI_JOB_SETS:
        got = walk_multi_plan(tl, jobs, ybar, x, sh, w, dst, N)
        want = multi_plain(*(torch.from_numpy(a)
                             for a in (ybar, x, sh, w, dst)), jobs, tl, N)
        for g, wp in zip(got, want):
            _rel_close(g, wp.numpy(), rtol=2e-6)
            assert np.all(g[-3:] == 0.0)


@pytest.mark.parametrize('block', [0, 1])
def test_mace_layouts_walk_double_backward(mace_layouts, block):
    """cg_gagg.cu's walk (the double backward's 3 terms) and cg_gmulti's
    passes (6 jobs in 3 groups) at MACE's layouts against the plain
    versions."""
    from sevennet_finetuning_tpu_torch.ops import cg_tables
    from sevennet_finetuning_tpu_torch.ops.fused_conv_multi import (
        gagg_plain, gmulti_plain)
    from tests.test_torch_double_backward import (
        _pool_data, eval_gmulti_plan, walk_gagg_plan)

    _, tl = mace_layouts[block]
    N, E = 3, 7
    ybar, pool, dst = _pool_data(tl, E, N, seed=50 + block)
    tp = [torch.from_numpy(p) for p in pool]
    terms = ((3, 1, 2), (0, 4, 2), (0, 1, 5))
    got = walk_gagg_plan(tl, pool, dst, terms, N)
    want = gagg_plain(tp, torch.from_numpy(dst), terms, tl, N).numpy()
    _rel_close(got, want, rtol=2e-6)
    assert len(cg_tables.gagg_plan(tl).units) > 0
    jobs = (('x', 1, 5, 'gx'), ('x', 4, 2, 'gx'), ('sh', 0, 5, 'gsh'),
            ('sh', 3, 2, 'gsh'), ('w', 0, 4, 'gw'), ('w', 3, 1, 'gw'))
    groups = ('gx', 'gsh', 'gw')
    got = eval_gmulti_plan(tl, ybar, pool, dst, jobs, groups, N)
    want = gmulti_plain(torch.from_numpy(ybar), tp, torch.from_numpy(dst),
                        jobs, groups, tl, N)
    for g, wp in zip(got, want):
        _rel_close(g, wp.numpy(), rtol=2e-6)


# --- the CLI -----------------------------------------------------------------

def test_main_train_mace_matches_jax_cli(tmp_path):
    """``main train`` from one YAML with ``interaction_type: mace``
    (narrow: channel 4, l <= 2 filter, correlation 2; one epoch on
    ft.extxyz), the port on the CPU against the JAX CLI: every log.csv
    value within the CLI tests' limits."""
    import yaml

    from tests.test_torch_cli import (assert_rows_close, narrow_input,
                                      read_csv, run_jax, run_port)

    y = narrow_input(tmp_path / 'input.yaml', epochs=1)
    cfg = yaml.safe_load(Path(y).read_text())
    cfg['model'].update({'interaction_type': 'mace', 'correlation': 2,
                         'lmax_edge': 2, 'lmax_node': 1, 'is_parity': True,
                         'self_connection_type': 'nequip'})
    Path(y).write_text(yaml.safe_dump(cfg))
    run_jax(y, tmp_path / 'jax')
    trainer = run_port(y, tmp_path / 'port')
    assert [b.block_type for b in trainer.spec.blocks] == ['mace', 'mace']
    got = read_csv(tmp_path / 'port/log.csv')
    assert [r['epoch'] for r in got] == ['1']
    assert_rows_close(got, read_csv(tmp_path / 'jax/log.csv'))


# --- the families golden -----------------------------------------------------

def golden_configs():
    """{name: flat model config} as the golden file stores them."""
    gold = np.load(GOLDEN)
    cfgs = json.loads(str(gold['configs']))
    for cfg in cfgs.values():
        cfg[K.TYPE_MAP] = {int(z): i for z, i in cfg[K.TYPE_MAP]}
    return gold, cfgs


def test_golden_configs_build_in_both_packages():
    """The golden's configs are FAMILY_CONFIGS plus ft900's statistics;
    both packages build them with the same parameter shapes."""
    gold, cfgs = golden_configs()
    assert set(cfgs) == set(FAMILY_CONFIGS)
    for name, cfg in cfgs.items():
        assert {k: cfg[k] for k in FAMILY_CONFIGS[name]} == FAMILY_CONFIGS[
            name]
        shapes = {g: {n: v.shape for n, v in d.items()}
                  for g, d in init_params(build_model_spec(cfg), 0).items()}
        with jax.enable_x64(False):
            want = {g: {n: v.shape for n, v in d.items()}
                    for g, d in j_init(j_build(cfg), 0).items()}
        assert shapes == want
        assert int(gold[f'{name}/n_params']) == sum(
            int(np.prod(s)) for d in shapes.values() for s in d.values())


def _write_golden():
    """The families golden with JAX on the CPU (x64 off, cKDTree)."""
    from sevennet_finetuning_tpu.calculator import Calculator as JCalculator
    from sevennet_finetuning_tpu.data.dataset import (
        GraphDataset as JGraphDataset, Loader as JLoader)
    from sevennet_finetuning_tpu.data.readers import read_extxyz as j_read
    from sevennet_finetuning_tpu.train.trainer import Trainer as JTrainer
    from tests.test_torch_train import jax_steps

    ft900 = j_read(str(FT900))
    stats = {}
    for cutoff in sorted({c[K.CUTOFF] for c in FAMILY_CONFIGS.values()}):
        ds = JGraphDataset.from_structures(ft900, cutoff, FAMILY_TYPE_MAP)
        stats[str(cutoff)] = (float(ds.per_atom_energy_mean()),
                              float(ds.force_rms()),
                              float(ds.avg_num_neigh()))
        print(f'ft900 at {cutoff} A: shift, scale, denominator '
              f'{stats[str(cutoff)]}', flush=True)
    structs = j_read(str(FT))
    configs = {}
    arrays = {}
    for name in FAMILY_CONFIGS:
        cfg = family_config(name, stats)
        spec = j_build(cfg)
        params = j_init(spec, 0)
        arrays[f'{name}/n_params'] = np.int64(sum(
            int(np.size(v)) for d in params.values() for v in d.values()))
        calc = JCalculator(spec, params)
        res = [calc.calculate(s) for s in structs]
        arrays[f'{name}/energy'] = np.array([r['energy'] for r in res])
        arrays[f'{name}/stress'] = np.stack([np.asarray(r['stress'],
                                                        np.float64)
                                             for r in res])
        for i, r in enumerate(res):
            arrays[f'{name}/forces_{i}'] = np.asarray(r['forces'],
                                                      np.float64)
        print(f'{name}: {arrays[f"{name}/n_params"]} parameters, energies '
              f'{arrays[f"{name}/energy"]}', flush=True)
        if name in FAMILY_TRAINED:
            tcfg = {**cfg, **FAMILY_TRAIN}
            jt = JTrainer(spec, params, tcfg)
            ds = JGraphDataset.from_structures(ft900[:1], cfg[K.CUTOFF],
                                               FAMILY_TYPE_MAP)
            batch = list(JLoader(ds, 1))[0]
            rows, grads, _ = jax_steps(jt, [batch] * FAMILY_TRAIN_STEPS,
                                       ['train'] * FAMILY_TRAIN_STEPS)
            for k in TRAIN_TERMS:
                arrays[f'{name}/train/{k}'] = np.array([r[k] for r in rows])
            for g, names in grads.items():
                for n, v in names.items():
                    arrays[f'{name}/grad/{g}/{n}'] = np.asarray(v,
                                                                np.float32)
            print(f'{name}: train totals {arrays[f"{name}/train/Total"]}',
                  flush=True)
        cfg[K.TYPE_MAP] = sorted(cfg[K.TYPE_MAP].items())
        configs[name] = cfg
    arrays['configs'] = np.array(json.dumps(configs, sort_keys=True))
    arrays['train_config'] = np.array(json.dumps(
        {'recipe': FAMILY_TRAIN, 'steps': FAMILY_TRAIN_STEPS,
         'trained': list(FAMILY_TRAINED)}, sort_keys=True))
    GOLDEN.parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(GOLDEN, **arrays)
    print(f'wrote {GOLDEN} ({GOLDEN.stat().st_size} bytes)')


if __name__ == '__main__':
    sys.path.insert(0, str(ROOT))
    os.environ['SEVENN_NO_NATIVE'] = '1'
    jax.config.update('jax_platforms', 'cpu')
    _write_golden()
