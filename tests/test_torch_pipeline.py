"""The port's pipeline pieces against the JAX package's, on the CPU.

- ``init_params`` gives the JAX package's arrays bit for bit;
- adamw / sgd / nesterov / adagrad / radam take optax's steps, and
  leave a frozen leaf alone;
- per-structure data weights: the Loader's weights and the weighted loss
  terms agree with JAX's;
- ``_check_continue_compat`` refuses what JAX refuses;
- the reEWC workflow at narrow width (channel 4, lmax 1, 2
  convolutions): from a checkpoint the JAX CLI wrote, the ``-fs`` stage
  writes a Fisher within 2e-4 of JAX's (per leaf, of its max) and the
  anchor bit for bit, and the fine-tune that consumes them (EWC and
  rehearsal) writes a log.csv within 1e-4 relative + 1e-7 of JAX's, row
  by row;
- every reader of ``_read_file`` (OUTCAR, POSCAR, structure_list, pickled
  and ase-read Atoms) reads synthetic files as JAX's does;
- each branch that is not ported raises ``NotImplementedError`` naming
  its ROADMAP item (A.8, A.3); the ``.sevenn_data`` options and a
  continue of a JAX checkpoint's optax state run.
"""

import argparse
import csv
import warnings
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import yaml

from sevennet_finetuning_tpu import keys as JK
from sevennet_finetuning_tpu import pipeline as j_pipeline
from sevennet_finetuning_tpu.data import dataset as j_dataset
from sevennet_finetuning_tpu.logger import Logger as JLogger
from sevennet_finetuning_tpu.main import cmd_train as j_cmd_train
from sevennet_finetuning_tpu.model.build import build_model_spec as j_build
from sevennet_finetuning_tpu.model.nequip import init_params as j_init
from sevennet_finetuning_tpu.train import loss as j_loss
from sevennet_finetuning_tpu.train import optim as j_optim
from sevennet_finetuning_tpu.train.checkpoint import (
    load_pytree as j_load_pytree)
from sevennet_finetuning_tpu_torch import keys as K
from sevennet_finetuning_tpu_torch import pipeline
from sevennet_finetuning_tpu_torch.config import (
    global_config, read_config_yaml)
from sevennet_finetuning_tpu_torch.data import dataset
from sevennet_finetuning_tpu_torch.data.readers import read_extxyz
from sevennet_finetuning_tpu_torch.logger import Logger
from sevennet_finetuning_tpu_torch.main import main as cli
from sevennet_finetuning_tpu_torch.model.build import build_model_spec
from sevennet_finetuning_tpu_torch.model.nequip import init_params
from sevennet_finetuning_tpu_torch.train import loss, optim
from sevennet_finetuning_tpu_torch.train.checkpoint import load_pytree

torch.set_num_threads(2)
ROOT = Path(__file__).resolve().parent.parent
FT = ROOT / 'experiments/ft_reewc/data/ft.extxyz'
REPLAY = ROOT / 'experiments/ft_reewc/data/replay.extxyz'
CKPT = ROOT / 'experiments/ft_reewc_900/conv_out/checkpoint_best.pth'
TYPE_MAP = {72: 0, 8: 1}
NARROW = {K.NUM_SPECIES: 2, K.TYPE_MAP: TYPE_MAP,
          K.NODE_FEATURE_MULTIPLICITY: 4, K.LMAX: 1, K.NUM_CONVOLUTION: 2,
          K.IS_PARITY: False, K.SELF_CONNECTION_TYPE: 'linear',
          K.CONV_DENOMINATOR: 12.5,
          K.SHIFT: -9.0, K.SCALE: 1.3, K.CUTOFF: 4.0}


@pytest.fixture(autouse=True, scope='module')
def _ckdtree_neighbor_list():
    """Both packages build this file's graphs with the cKDTree neighbor
    list (the native core orders edges otherwise); restored after."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv('SEVENN_NO_NATIVE', '1')
        yield


# --- init_params ------------------------------------------------------------

@pytest.mark.parametrize('extra', [
    {},
    {K.USE_BIAS_IN_LINEAR: True, K.READOUT_AS_FCN: True, K.LMAX: 2,
     K.SHIFT: [-9.0, -4.5], K.CONV_DENOMINATOR: [10.0, 20.0]},
], ids=['linear-readout', 'fcn-readout-biases'])
@pytest.mark.parametrize('seed', [1, 7])
def test_init_params_bit_equal(seed, extra):
    cfg = {**NARROW, **extra}
    want = j_init(j_build(cfg), seed)
    got = init_params(build_model_spec(cfg), seed)
    assert set(got) == set(want)
    for g, names in want.items():
        assert set(got[g]) == set(names), g
        for n, w in names.items():
            w = np.asarray(w)
            assert got[g][n].dtype == w.dtype, (g, n)
            np.testing.assert_array_equal(got[g][n], w, err_msg=f'{g}/{n}')


# --- optimizers -------------------------------------------------------------

OPTIMIZERS = [
    ('adamw', {'weight_decay': 0.05}),
    ('sgd', {}),
    ('sgd', {'momentum': 0.9}),
    ('sgd', {'momentum': 0.9, 'nesterov': True}),
    ('adagrad', {}),
    ('radam', {}),
]


@pytest.mark.parametrize('name,params', OPTIMIZERS,
                         ids=['adamw', 'sgd', 'momentum', 'nesterov',
                              'adagrad', 'radam'])
def test_optimizer_steps_match_optax(name, params):
    """Eight steps (radam rectifies from its sixth) against the JAX
    package's masked optax transform, in float32 as the JAX package runs
    (the test session enables x64, which would move optax's float32
    bias corrections and radam's rho)."""
    lr = 1e-2
    rng = np.random.default_rng(3)
    leaves = {'g': {'a': rng.normal(size=(4, 3)).astype(np.float32),
                    'frozen': rng.normal(size=(2,)).astype(np.float32)},
              'h': {'b': rng.normal(size=(5,)).astype(np.float32)}}
    mask = {'g': {'a': True, 'frozen': False}, 'h': {'b': True}}
    cfg = {K.OPTIMIZER: name, K.OPTIM_PARAM: {'lr': lr, **params},
           K.SCHEDULER: 'constant'}
    t_params = {g: {n: torch.nn.Parameter(torch.from_numpy(v.copy()))
                    for n, v in names.items()} for g, names in leaves.items()}
    opt, _ = optim.build_optimizer(cfg, t_params, mask)
    with jax.enable_x64(False):
        tx, _ = j_optim.build_optimizer(cfg, mask)
        j_params = jax.tree_util.tree_map(jnp.asarray, leaves)
        state = tx.init(j_params)
        for step in range(8):
            grads = {g: {n: rng.normal(size=v.shape).astype(np.float32)
                         for n, v in names.items()}
                     for g, names in leaves.items()}
            upd, state = tx.update(jax.tree_util.tree_map(jnp.asarray, grads),
                                   state, j_params)
            j_params = optax.apply_updates(j_params, upd)
            for g, names in t_params.items():
                for n, p in names.items():
                    p.grad = torch.from_numpy(grads[g][n])
            opt.step()
            for g, names in t_params.items():
                for n, p in names.items():
                    np.testing.assert_allclose(
                        p.detach().numpy(), np.asarray(j_params[g][n]),
                        rtol=0, atol=1e-6 * lr, err_msg=f'{step} {g}/{n}')
    np.testing.assert_array_equal(t_params['g']['frozen'].detach().numpy(),
                                  leaves['g']['frozen'])
    assert len(opt.state) == 2            # no state for the frozen leaf


def test_unknown_optimizer_raises():
    p = {'g': {'a': torch.nn.Parameter(torch.zeros(2))}}
    with pytest.raises(ValueError, match='unknown optimizer'):
        optim.build_optimizer({K.OPTIMIZER: 'lbfgs'}, p, {'g': {'a': True}})


# --- data weights -----------------------------------------------------------

@pytest.fixture(scope='module')
def weighted_sets():
    weights = {'a': {K.PER_ATOM_ENERGY: 2.0, K.FORCE: 0.5, K.STRESS: 3.0}}
    sets = []
    for reader, ds_cls in ((read_extxyz, dataset.GraphDataset),
                           (j_pipeline._read_file, j_dataset.GraphDataset)):
        structs = (reader(str(FT)) if reader is read_extxyz
                   else reader(str(FT), 'extxyz'))
        for i, s in enumerate(structs):
            s.info['label'] = 'a' if i % 2 else 'b'
        sets.append(ds_cls.from_structures(structs, 4.0, TYPE_MAP))
    return weights, sets


def test_loader_data_weights_match_jax(weighted_sets):
    weights, (t_ds, j_ds) = weighted_sets
    t_b = list(dataset.Loader(t_ds, 3, data_weights=weights))
    j_b = list(j_dataset.Loader(j_ds, 3, data_weights=weights))
    assert len(t_b) == len(j_b) == 2
    for a, b in zip(t_b, j_b):
        for wk in (K.PER_ATOM_ENERGY, K.FORCE, K.STRESS):
            np.testing.assert_array_equal(a[K.DATA_WEIGHT][wk],
                                          b[JK.DATA_WEIGHT][wk])
    assert set(t_b[0][K.DATA_WEIGHT][K.FORCE]) == {0.5, 1.0}


def test_weighted_loss_terms_match_jax(weighted_sets):
    """Random predictions on a weighted batch: each weighted term and the
    total agree with JAX's weighted loss."""
    from sevennet_finetuning_tpu_torch.model.nequip import batch_to_torch

    weights, (t_ds, _) = weighted_sets
    batch = next(iter(dataset.Loader(t_ds, 4, data_weights=weights)))
    rng = np.random.default_rng(5)
    out = {k: v for k, v in batch.items()
           if k not in (K.INFO, K.USER_LABEL)}
    for pred, ref, sd in ((K.PRED_TOTAL_ENERGY, K.ENERGY, 1.0),
                          (K.PRED_FORCE, K.FORCE, 1.0),
                          (K.PRED_STRESS, K.STRESS, 1e-3)):
        # padded slots carry NaN labels; a model predicts finite values
        out[pred] = (np.nan_to_num(batch[ref]) + sd * rng.normal(
            size=batch[ref].shape)).astype(np.float32)
    cfg = {K.LOSS: 'Huber', K.LOSS_PARAM: {'delta': 0.5},
           K.FORCE_WEIGHT: 1.0, K.STRESS_WEIGHT: 0.01,
           K.IS_TRAIN_STRESS: True, K.LOAD_DATASET_WITH_WEIGHTS: True}
    j_fn = j_loss.build_loss_fn(j_loss.loss_specs_from_config(cfg),
                                use_data_weights=True)
    t_fn = loss.build_loss_fn(loss.loss_specs_from_config(cfg),
                              use_data_weights=True)
    j_out = {k: ({wk: jnp.asarray(w) for wk, w in v.items()}
                 if k == K.DATA_WEIGHT else jnp.asarray(v))
             for k, v in out.items()}
    t_out = batch_to_torch(out, 'cpu')
    want_total, want = j_fn({}, j_out)
    got_total, got = t_fn({}, t_out)
    unweighted = loss.build_loss_fn(loss.loss_specs_from_config(cfg))(
        {}, t_out)[1]
    for k in ('Energy', 'Force', 'Stress'):
        assert float(got[k]) == pytest.approx(float(want[k]), rel=2e-6)
        assert float(got[k]) != pytest.approx(float(unweighted[k]), rel=1e-3)
    assert float(got_total) == pytest.approx(float(want_total), rel=2e-6)


def test_parallel_graph_build_matches_serial():
    """preprocess_num_cores > 1 builds the graphs in spawned workers:
    the same graphs, in the same order, as the serial build."""
    structs = read_extxyz(str(REPLAY))
    serial = dataset.GraphDataset.from_structures(structs, 4.0, TYPE_MAP)
    pooled = dataset.GraphDataset.from_structures(structs, 4.0, TYPE_MAP,
                                                  n_cores=2)
    assert len(pooled) == len(serial) == 5
    for a, b in zip(pooled.graphs, serial.graphs):
        assert set(a) == set(b)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_radial_embedding_statistics_match_jax(weighted_sets):
    """standardize_radial_embedding's (mean, std) over the train edges,
    in float32 on the host, against JAX's (float64 under the test
    session's x64)."""
    _, (t_ds, j_ds) = weighted_sets
    cfg = {**NARROW, K.CUTOFF_FUNCTION: {K.CUTOFF_FUNCTION_NAME: 'XPLOR',
                                         K.CUTOFF_ON: 3.5}}
    for cut in ({}, cfg):
        c = {**NARROW, **cut}
        got = pipeline._radial_embedding_std_mean(c, t_ds)
        want = j_pipeline._radial_embedding_std_mean(c, j_ds)
        np.testing.assert_allclose(got, want, rtol=1e-5)


# --- continue compatibility -------------------------------------------------

CP = {K.NODE_FEATURE_MULTIPLICITY: 128, K.LMAX: 2, K.CUTOFF: 5.0,
      K.TRAIN_DENOMINATOR: True, K.TRAIN_SHIFT_SCALE: False,
      K.CUTOFF_FUNCTION: {K.CUTOFF_FUNCTION_NAME: 'XPLOR',
                          K.CUTOFF_ON: 4.5}}


@pytest.mark.parametrize('config,cont', [
    ({K.NODE_FEATURE_MULTIPLICITY: 32}, {}),            # default: kept
    ({K.NODE_FEATURE_MULTIPLICITY: 64}, {}),            # explicit clash
    ({K.LMAX: 3}, {}),
    ({K.CUTOFF: 4.0}, {}),
    ({K.CUTOFF_FUNCTION: {K.CUTOFF_FUNCTION_NAME: 'XPLOR'}}, {}),
    ({K.CUTOFF_FUNCTION: {K.CUTOFF_FUNCTION_NAME: 'poly_cut',
                          K.POLY_CUT_P: 5}}, {}),
    ({K.TRAIN_DENOMINATOR: False}, {}),
    ({K.TRAIN_DENOMINATOR: False}, {K.RESET_OPTIMIZER: True}),
    ({K.TRAIN_DENOMINATOR: False}, {K.RESET_OPTIMIZER: True,
                                    K.RESET_SCHEDULER: True}),
    ({K.TRAIN_SHIFT_SCALE: True}, {}),
])
def test_continue_compat_refuses_what_jax_refuses(tmp_path, config, cont):
    def outcome(fn, logger):
        try:
            fn(dict(config), dict(CP), cont, logger)
        except ValueError as e:
            return str(e)
        finally:
            logger.close()
        return None

    want = outcome(j_pipeline._check_continue_compat,
                   JLogger(str(tmp_path / 'j.log'), screen=False))
    got = outcome(pipeline._check_continue_compat,
                  Logger(str(tmp_path / 't.log'), screen=False))
    assert got == want


# --- the reEWC workflow -----------------------------------------------------

def _yaml(path, model=None, train=None, data=None):
    cfg = {
        'model': {'chemical_species': 'auto', 'cutoff': 4.0, 'channel': 4,
                  'lmax': 1, 'num_convolution_layer': 2, 'is_parity': False,
                  'self_connection_type': 'linear', **(model or {})},
        'train': {'random_seed': 1, 'epoch': 1, 'per_epoch': 1,
                  'optim_param': {'lr': 0.005}, **(train or {})},
        'data': {'batch_size': 2, 'data_divide_ratio': 0.2,
                 'load_dataset_path': [str(FT)], **(data or {})},
    }
    Path(path).write_text(yaml.safe_dump(cfg))
    return str(path)


def _jax_cli(path, wd, fisher=False):
    j_cmd_train(argparse.Namespace(input=path, working_dir=str(wd),
                                   calc_fisher=fisher, distributed=False))


def _port_cli(path, wd, fisher=False):
    cli(['train', path, '-w', str(wd), '--device', 'cpu']
        + (['-fs'] if fisher else []))


@pytest.fixture(scope='module')
def stages(tmp_path_factory):
    """A checkpoint from the JAX CLI (1 epoch from scratch), then the
    Fisher stage and the reEWC fine-tune, each run by both CLIs; each
    fine-tune consumes its own package's Fisher artifacts."""
    tmp = tmp_path_factory.mktemp('stages')
    _jax_cli(_yaml(tmp / 'pre.yaml'), tmp / 'pre')
    ckpt = str(tmp / 'pre/checkpoint_1.pth')
    fs = _yaml(tmp / 'fs.yaml', train={
        'error_record': [['Energy', 'MAE'], ['Force', 'MAE'],
                         ['TotalLoss', 'None']],
        'continue': {'checkpoint': ckpt, 'loss_threshold': -1}},
        data={'batch_size': 1, 'load_dataset_path': [str(REPLAY)]})
    out = {}
    for side, run in (('jax', _jax_cli), ('port', _port_cli)):
        run(fs, tmp / side / 'fisher', fisher=True)
        ft = _yaml(tmp / f'ft_{side}.yaml', train={
            'epoch': 3, 'per_epoch': 2, 'loss': 'Huber',
            'loss_param': {'delta': 0.01}, 'force_loss_weight': 1.0,
            'stress_loss_weight': 0.01,
            'optim_param': {'lr': 1e-3}, 'scheduler': 'exponentiallr',
            'scheduler_param': {'gamma': 0.9},
            'error_record': [['Energy', 'RMSE'], ['Force', 'RMSE'],
                             ['Stress', 'MAE'], ['TotalLoss', 'None'],
                             ['EWCLoss', 'None']],
            'continue': {
                'checkpoint': ckpt, 'reset_optimizer': True,
                'reset_scheduler': True, 'reset_epoch': True,
                'fisher_information': str(tmp / side / 'fisher'
                                          / 'fisher_sevenn.pt'),
                'opt_params': str(tmp / side / 'fisher'
                                  / 'opt_params_sevenn.pt'),
                'ewc_lambda': 1000.0}},
            data={'rehearsal': True, 'load_memory_path': [str(REPLAY)],
                  'mem_batch_size': 2})
        run(ft, tmp / side / 'ft')
        out[side] = tmp / side
    return out


def test_fisher_stage_matches_jax(stages):
    for name in ('fisher_sevenn.pt', 'opt_params_sevenn.pt'):
        want = j_load_pytree(str(stages['jax'] / 'fisher' / name))
        got = load_pytree(str(stages['port'] / 'fisher' / name))
        assert set(got) == set(want)
        for g, names in want.items():
            for n, w in names.items():
                w = np.asarray(w)
                if name.startswith('opt_params'):
                    np.testing.assert_array_equal(got[g][n], w)
                else:
                    scale = max(float(np.abs(w).max()), 1e-30)
                    assert np.abs(got[g][n] - w).max() <= 2e-4 * scale, (
                        g, n)
    log = (stages['port'] / 'fisher' / 'log.sevenn').read_text()
    assert 'fisher from 4 samples saved' in log


def test_reewc_fine_tune_matches_jax(stages):
    def rows(side):
        with open(stages[side] / 'ft' / 'log.csv') as f:
            return list(csv.DictReader(f))

    got, want = rows('port'), rows('jax')
    assert [r['epoch'] for r in got] == ['1', '2', '3']
    assert list(got[0]) == list(want[0])
    assert 'memory_EWCLoss_None' in got[0]
    assert float(got[-1]['train_EWCLoss_None']) > 0
    for i, (g, w) in enumerate(zip(got, want)):
        for col in w:
            a, b = float(g[col]), float(w[col])
            assert abs(a - b) <= 1e-4 * abs(b) + 1e-7, (i, col, a, b)
    assert sorted(p.name for p in (stages['port'] / 'ft').iterdir()) == \
        sorted(p.name for p in (stages['jax'] / 'ft').iterdir())


# --- the readers beyond extxyz ---------------------------------------------

class DuckAtoms:
    """An ase.Atoms stand-in (ase is not installed): what
    ``atoms_list_to_structures`` calls, from an in-repo structure."""

    def __init__(self, s):
        self.s = s

    def get_chemical_symbols(self):
        return list(self.s.species)

    def get_positions(self):
        return np.array(self.s.pos)

    def get_cell(self):
        return np.array(self.s.cell)

    def get_pbc(self):
        return np.array(self.s.pbc)

    def get_potential_energy(self, force_consistent=False):
        return self.s.energy

    def get_forces(self, apply_constraint=True):
        return np.array(self.s.forces)

    def get_stress(self, voigt=True):
        # ours (xx yy zz xy yz zx, negated) -> ase Voigt (xx yy zz yz xz xy)
        return -np.asarray(self.s.stress)[[0, 1, 2, 4, 5, 3]]


def _grouped(s):
    """The structure with its atoms grouped by species (Hf, then O), as a
    VASP file lists them."""
    order = np.argsort([sp != 'Hf' for sp in s.species], kind='stable')
    s.species = [s.species[i] for i in order]
    s.pos, s.forces = s.pos[order], s.forces[order]
    return s


def _outcar_text(structs):
    """A minimal OUTCAR with one ionic step per structure (the lines
    ``read_outcar`` parses)."""
    s0 = structs[0]
    syms = list(dict.fromkeys(s0.species))
    counts = [s0.species.count(x) for x in syms]
    lines = [f'   POTCAR:    PAW_PBE {x} 06Sep2000' for x in syms] * 2
    lines.append('   ions per type =  ' + '  '.join(map(str, counts)))
    for s in structs:
        lines.append('      direct lattice vectors                 '
                     'reciprocal lattice vectors')
        for row in s.cell:
            lines.append(' '.join(f'{x:13.9f}' for x in row)
                         + '   0.000000000  0.000000000  0.000000000')
        kb = np.asarray(s.stress) * 1602.1766208
        lines.append('  in kB  ' + ' '.join(f'{x:11.5f}' for x in kb))
        lines.append(' POSITION                                       '
                     'TOTAL-FORCE (eV/Angst)')
        lines.append(' ' + '-' * 83)
        for p, f in zip(s.pos, s.forces):
            lines.append(' '.join(f'{x:12.5f}' for x in p) + '    '
                         + ' '.join(f'{x:13.6f}' for x in f))
        lines.append(' ' + '-' * 83)
        lines.append(f'  free  energy   TOTEN  =      {s.energy:.8f} eV')
    return '\n'.join(lines) + '\n'


def _poscar_text(s):
    syms = list(dict.fromkeys(s.species))
    out = ['HfO2', '1.0']
    out += [' '.join(f'{x:.10f}' for x in row) for row in s.cell]
    out += [' '.join(syms), ' '.join(str(s.species.count(x)) for x in syms),
            'Cartesian']
    out += [' '.join(f'{x:.10f}' for x in p) for p in s.pos]
    return '\n'.join(out) + '\n'


@pytest.mark.parametrize('name,fmt', [
    ('OUTCAR', 'structure_list'), ('POSCAR', 'structure_list'),
    ('structure_list', 'structure_list'), ('atoms.pkl', 'structure_list'),
    ('data.traj', 'ase'),
])
def test_readers_match_jax(tmp_path, monkeypatch, name, fmt):
    """Each structure format is read: synthetic files written from the
    12-atom structures of replay.extxyz, read by the port's
    ``_read_file`` as JAX's reads them, field by field, and as the
    structures they were written from."""
    import pickle
    import sys
    import types

    src = [_grouped(s) for s in read_extxyz(str(REPLAY))[1:4]]
    path = tmp_path / name
    if name == 'OUTCAR':
        path.write_text(_outcar_text(src))
    elif name == 'POSCAR':
        path.write_text(_poscar_text(src[0]))
        src = src[:1]
    elif name == 'structure_list':
        (tmp_path / 'OUTCAR_1').write_text(_outcar_text(src[:2]))
        (tmp_path / 'OUTCAR_2').write_text(_outcar_text(src[2:]))
        path.write_text('[bulk]\nOUTCAR_{1..2} :\n')
    elif name == 'atoms.pkl':
        with open(path, 'wb') as f:
            pickle.dump([DuckAtoms(s) for s in src], f)
    else:
        ase = types.ModuleType('ase')
        ase.io = types.ModuleType('ase.io')
        ase.io.read = lambda p, index=':': [DuckAtoms(s) for s in src]
        monkeypatch.setitem(sys.modules, 'ase', ase)
        monkeypatch.setitem(sys.modules, 'ase.io', ase.io)
    got = pipeline._read_file(str(path), fmt)
    want = j_pipeline._read_file(str(path), fmt)
    assert len(got) == len(want) == len(src)
    for g, w, s in zip(got, want, src):
        assert g.species == w.species == s.species
        assert g.info == w.info
        for key in ('pos', 'cell', 'forces', 'stress'):
            a, b = getattr(g, key), getattr(w, key)
            if name == 'POSCAR' and key in ('forces', 'stress'):
                assert a is None and b is None
                continue
            assert np.array_equal(a, b), key
            assert np.allclose(a, getattr(s, key), atol=1e-4), key
        if name != 'POSCAR':
            assert g.energy == w.energy
            assert abs(g.energy - s.energy) <= 1e-6


# --- what is not ported -----------------------------------------------------


@pytest.mark.parametrize('override,item', [
    ({K.IS_DDP: True}, 'A.8'),
    ({K.REMAT: True}, 'A.3'),
])
def test_unported_train_options_raise(tmp_path, override, item):
    cfg = global_config(*read_config_yaml(_yaml(tmp_path / 'in.yaml')))
    cfg.update(override)
    with pytest.raises(NotImplementedError, match=item.replace('.', r'\.')):
        pipeline.train(cfg, str(tmp_path / 'out'), device='cpu')


@pytest.mark.parametrize('case', ['save_dataset', 'load_sevenn_data',
                                  'optax_continue'])
def test_sevenn_data_and_optax_continue_train(tmp_path, case):
    """The train options that once raised run: ``save_dataset_path``
    writes the set, a ``.sevenn_data`` path trains, and a JAX
    checkpoint's optax state is continued without a reset (an adam state
    made by JAX's own optimizer over the narrow parameters)."""
    cfg = global_config(*read_config_yaml(_yaml(tmp_path / 'in.yaml')))
    if case == 'save_dataset':
        cfg[K.SAVE_DATASET] = str(tmp_path / 'total')
        pipeline.train(cfg, str(tmp_path / 'out'), device='cpu')
        assert len(dataset.load_sevenn_data(
            str(tmp_path / 'total.sevenn_data'))) == 5
        return
    if case == 'load_sevenn_data':
        art = tmp_path / 'ft.sevenn_data'
        cli(['graph_build', str(FT), '4.0', '-o', str(art)])
        cfg[K.LOAD_DATASET] = [str(art)]
        trainer = pipeline.train(cfg, str(tmp_path / 'out'), device='cpu')
        assert trainer.spec.num_species == 2
        assert (tmp_path / 'out' / 'log.csv').exists()
        return
    from sevennet_finetuning_tpu.train.checkpoint import (
        save_checkpoint as j_save)

    narrow = {**NARROW, K.TRAIN_SHIFT_SCALE: True,
              K.TRAIN_DENOMINATOR: True}
    params = j_init(j_build(narrow), 1)
    mask = jax.tree_util.tree_map(lambda _: True, params)
    with jax.enable_x64(False):
        tx, _ = j_optim.build_optimizer({K.OPTIMIZER: 'adam'}, mask)
        state = tx.init(params)
        grads = jax.tree_util.tree_map(jnp.ones_like, params)
        _, state = tx.update(grads, state, params)
    ckpt = tmp_path / 'jax.pth'
    j_save(str(ckpt), params, narrow, 7, optimizer_state=state,
           scheduler_state={'epoch': 7, 'lr': 1e-3})
    cfg[K.CONTINUE] = {K.CHECKPOINT: str(ckpt)}
    cfg.update({K.TRAIN_SHIFT_SCALE: True, K.TRAIN_DENOMINATOR: True,
                K.EPOCH: 8})
    with warnings.catch_warnings():
        warnings.simplefilter('error', UserWarning)   # state restored
        trainer = pipeline.train(cfg, str(tmp_path / 'out'), device='cpu')
    steps = {float(s['step'])
             for s in trainer.optimizer.state_dict()['state'].values()}
    assert steps == {1.0 + 2}       # JAX's count 1, two train batches
    assert 'optimizer state not restored' not in (
        tmp_path / 'out' / 'log.sevenn').read_text()


def test_unported_model_options_raise():
    # the FCTP ('nequip') self-connection is ported: its spec and the
    # JAX package's have the same parameter shapes
    spec = build_model_spec({**NARROW, K.SELF_CONNECTION_TYPE: 'nequip'})
    j_spec = j_build({**NARROW, K.SELF_CONNECTION_TYPE: 'nequip'})
    got = {g: {n: v.shape for n, v in d.items()}
           for g, d in init_params(spec, 0).items()}
    assert got == {g: {n: v.shape for n, v in d.items()}
                   for g, d in j_init(j_spec, 0).items()}
    assert got['0_self_connection_intro']
    # every interaction family builds (the MACE and Gaunt families give
    # the JAX package's parameter shapes); an unknown one raises in both
    for itype in ('mace', 'gaunt', 'gaunt_gate'):
        cfg = {**NARROW, K.INTERACTION_TYPE: itype, K.IS_PARITY: True}
        assert {g: {n: v.shape for n, v in d.items()}
                for g, d in init_params(build_model_spec(cfg), 0).items()
                } == {g: {n: v.shape for n, v in d.items()}
                      for g, d in j_init(j_build(cfg), 0).items()}
    with pytest.raises(NotImplementedError, match='not yet available'):
        build_model_spec({**NARROW, K.INTERACTION_TYPE: 'allegro'})
    # the custom loss loads its plugin (missing here) as JAX's does
    plugin = {'path': '/nonexistent/plugins', 'module': 'm',
              'function': 'f'}
    with pytest.raises(ValueError, match='no such plugin dir'):
        loss.loss_specs_from_config({K.LOSS: 'custom',
                                     K.LOSS_PARAM: plugin})


def test_pretrained_name_needs_its_directory(monkeypatch, tmp_path):
    from sevennet_finetuning_tpu_torch.compat.known_models import (
        pretrained_name_to_path)

    monkeypatch.delenv('SEVENN_PRETRAINED_DIR', raising=False)
    with pytest.raises(FileNotFoundError, match='SEVENN_PRETRAINED_DIR'):
        pretrained_name_to_path('SevenNet-0')
    with pytest.raises(ValueError, match='unknown pretrained'):
        pretrained_name_to_path('SevenNet-9')
    # a reference torch .pth release checkpoint: a zip archive without
    # the deploy artifact's __format__ entry
    import zipfile

    with zipfile.ZipFile(tmp_path / 'checkpoint_sevennet_0.pth', 'w') as zf:
        zf.writestr('archive/data.pkl', b'')
    monkeypatch.setenv('SEVENN_PRETRAINED_DIR', str(tmp_path))
    path = pretrained_name_to_path('7net-0')
    assert path == str(tmp_path / 'checkpoint_sevennet_0.pth')
    # the release checkpoint loads (here a reference training .pth of
    # narrow weights), as the JAX package's load_checkpoint reads it
    from sevennet_finetuning_tpu.train.checkpoint import (
        load_checkpoint as j_load_checkpoint)
    from sevennet_finetuning_tpu_torch.compat.state_dict_import import (
        state_dict_from_params)
    from sevennet_finetuning_tpu_torch.train.checkpoint import (
        load_checkpoint)

    params = init_params(build_model_spec(NARROW), 3)
    sd = state_dict_from_params(build_model_spec(NARROW), params)
    torch.save({'model_state_dict': {k: torch.from_numpy(v)
                                     for k, v in sd.items()},
                'config': NARROW, 'epoch': 9}, path)
    blob, want = load_checkpoint(path), j_load_checkpoint(path)
    assert blob['epoch'] == want['epoch'] == 9
    assert blob['config'] == want['config']
    for g, names in params.items():
        for n, v in names.items():
            assert np.array_equal(blob['model_state_dict'][g][n], v)
            assert np.array_equal(want['model_state_dict'][g][n], v)
