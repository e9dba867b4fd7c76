"""A JAX checkpoint's optax state on ``continue``, on the CPU.

For each optimizer the pipeline builds (adam, adamw, sgd with momentum,
adagrad, radam), the JAX Trainer trains a narrow model for one epoch and
writes a checkpoint with ``save_checkpoint`` (its optax state: an
``inject_hyperparams`` state over masked chains), then continues from
the state it reads back for a second epoch.  The port reads the same
checkpoint without jax or optax (``load_checkpoint`` keeps the optax
tree, ``optim.optax_state_dict`` translates it) and takes the same
second epoch: the epoch's metrics within 1e-4 relative + 1e-7 of JAX's
(the narrow train-slice limit of ``tests/test_torch_train.py``) and every
leaf's update over the epoch within 1e-3 of its max |update| plus two
float32 ulps of the leaf.  The same epoch from a reset optimizer misses
JAX's updates by more than 100 times that limit, so the check cannot
pass on a dropped state.  One CLI case: ``main train`` with
``continue:`` and no reset, in both packages, gives the same log.csv.

The narrow model: channel 4, lmax 1, 2 convolutions, trained
shift/scale, frozen denominators (so the masked states hold frozen
leaves); an exponential LR (gamma 0.5), so the LR of the saved optax
state is not the base LR.  The JAX side runs under
``jax.enable_x64(False)``.

The module's ``__main__`` regenerates ``golden/continue_ft900_jax_cpu.npz``
(``chip_smoke.py``'s compat phase: the in-repo SevenNet-0 checkpoint
continued with its own adam state for two batch-8 steps at LR 1e-4):

    PYTHONPATH=. python tests/test_torch_optax_state.py
"""

import argparse
import csv
import sys
import warnings
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

ROOT = Path(__file__).resolve().parent.parent
FT = ROOT / 'experiments/ft_reewc/data/ft.extxyz'
REPLAY = ROOT / 'experiments/ft_reewc/data/replay.extxyz'
CKPT = ROOT / 'experiments/ft_reewc_900/conv_out/checkpoint_best.pth'
FISHER = ROOT / 'experiments/ft_reewc/fisher_out/fisher_sevenn.pt'
OPT_PARAMS = ROOT / 'experiments/ft_reewc/fisher_out/opt_params_sevenn.pt'
FT900 = ROOT / 'experiments/ft_reewc_900/data/ft900.extxyz'
REPLAY900 = ROOT / 'experiments/ft_reewc_900/data/replay900.extxyz'
GOLDEN = (ROOT / 'sevennet_finetuning_tpu_torch/golden/'
          'continue_ft900_jax_cpu.npz')
TYPE_MAP = {72: 0, 8: 1}
OPTIMIZERS = {'adam': {}, 'adamw': {'weight_decay': 0.05},
              'sgd': {'momentum': 0.9}, 'adagrad': {}, 'radam': {}}

torch.set_num_threads(2)


@pytest.fixture(autouse=True, scope='module')
def _ckdtree_neighbor_list():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv('SEVENN_NO_NATIVE', '1')
        yield


def _config(name):
    from sevennet_finetuning_tpu_torch import keys as K

    return {
        K.NUM_SPECIES: 2, K.TYPE_MAP: dict(TYPE_MAP),
        K.NODE_FEATURE_MULTIPLICITY: 4, K.LMAX: 1, K.NUM_CONVOLUTION: 2,
        K.CUTOFF: 4.0, K.SELF_CONNECTION_TYPE: 'linear',
        K.IS_PARITY: False, K.CONV_DENOMINATOR: 12.5,
        K.SHIFT: [-9.0, -4.5], K.SCALE: [1.3, 1.1],
        K.TRAIN_SHIFT_SCALE: True, K.TRAIN_DENOMINATOR: False,
        K.IS_TRAIN_STRESS: True, K.OPTIMIZER: name,
        K.OPTIM_PARAM: {'lr': 2e-3, **OPTIMIZERS[name]},
        K.SCHEDULER: 'exponentiallr', K.SCHEDULER_PARAM: {'gamma': 0.5},
        K.ERROR_RECORD: [['Energy', 'RMSE'], ['Force', 'RMSE'],
                         ['Stress', 'RMSE'], ['TotalLoss', 'None']],
    }


def _structures(reader):
    """ft.extxyz's 12-atom structure and replay.extxyz's four 12-atom
    ones, as three unshuffled batches of 2, 2 and 1."""
    return ([s for s in reader(str(FT)) if len(s) == 12]
            + [s for s in reader(str(REPLAY)) if len(s) == 12])


def _jax_epochs(name, path):
    """The JAX Trainer: one epoch, the scheduler step, the checkpoint at
    ``path``, then a second epoch from the optax state read back.
    Returns (epoch-2 metrics, params before and after epoch 2)."""
    import jax

    from sevennet_finetuning_tpu.data.dataset import (
        GraphDataset, Loader)
    from sevennet_finetuning_tpu.data.readers import read_extxyz
    from sevennet_finetuning_tpu.model.build import build_model_spec
    from sevennet_finetuning_tpu.model.nequip import init_params
    from sevennet_finetuning_tpu.train.checkpoint import (
        load_checkpoint, save_checkpoint)
    from sevennet_finetuning_tpu.train.trainer import Trainer

    cfg = _config(name)
    with jax.enable_x64(False):
        spec = build_model_spec(cfg)
        loader = Loader(GraphDataset.from_structures(
            _structures(read_extxyz), cfg['cutoff'], TYPE_MAP), 2)
        jt = Trainer(spec, init_params(spec, seed=2), cfg)
        jt.run_one_epoch(loader, is_train=True)
        jt.scheduler_step()
        ck = jt.get_checkpoint_dict()
        save_checkpoint(str(path), ck['model_state_dict'], cfg, 1,
                        optimizer_state=ck['optimizer_state_dict'],
                        scheduler_state=ck['scheduler_state_dict'])
        before = jax.tree_util.tree_map(np.asarray, jt.params)
        jt.opt_state = jax.tree_util.tree_map(
            np.asarray, load_checkpoint(str(path))['optimizer_state_dict'])
        metrics = jt.run_one_epoch(loader, is_train=True)
        return metrics, before, jax.tree_util.tree_map(np.asarray,
                                                       jt.params)


@pytest.fixture(scope='module')
def jax_runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp('optax')
    return {name: (tmp / f'{name}.pth',) + _jax_epochs(
        name, tmp / f'{name}.pth') for name in OPTIMIZERS}


def _port_epoch(path, reset=False):
    """The port's second epoch from the checkpoint: (metrics, params)."""
    from sevennet_finetuning_tpu_torch.data.dataset import (
        GraphDataset, Loader)
    from sevennet_finetuning_tpu_torch.data.readers import read_extxyz
    from sevennet_finetuning_tpu_torch.train.checkpoint import (
        load_checkpoint, model_from_checkpoint)
    from sevennet_finetuning_tpu_torch.train.trainer import Trainer

    blob = load_checkpoint(str(path))
    model, cfg = model_from_checkpoint(str(path), device='cpu')
    trainer = Trainer(model, cfg, device='cpu')
    trainer.load_state_dicts(
        blob['model_state_dict'],
        None if reset else blob['optimizer_state_dict'],
        blob['scheduler_state_dict'])
    loader = Loader(GraphDataset.from_structures(
        _structures(read_extxyz), cfg['cutoff'], TYPE_MAP), 2)
    metrics = trainer.run_one_epoch(loader, is_train=True)
    return metrics, {g: {n: p.detach().numpy().copy()
                         for n, p in names.items()}
                     for g, names in trainer.params.items()}


def _update_errors(got, want, before):
    """Per leaf: max |got - want| over the leaf's limit, 1e-3 of max
    |want - before| (the JAX update over the epoch) plus two float32 ulps
    of max |want| (an update of 2e-5 on a weight of 3 is resolved to
    ~1e-2 of itself)."""
    out = {}
    for g, names in want.items():
        for n, w in names.items():
            step = float(np.abs(w - before[g][n]).max())
            if step > 0:
                limit = 1e-3 * step + 2 * float(
                    np.finfo(np.float32).eps) * float(np.abs(w).max())
                out[(g, n)] = float(np.abs(got[g][n] - w).max()) / limit
    return out


@pytest.mark.parametrize('name', list(OPTIMIZERS))
def test_continue_keeps_optax_state(jax_runs, name):
    path, j_metrics, before, j_after = jax_runs[name]
    metrics, after = _port_epoch(path)
    assert set(metrics) == set(j_metrics)
    for k, w in j_metrics.items():
        assert abs(metrics[k] - w) <= 1e-4 * abs(w) + 1e-7, (k, metrics,
                                                             j_metrics)
    errs = _update_errors(after, j_after, before)
    assert errs and max(errs.values()) <= 1, max(errs.items(),
                                                 key=lambda kv: kv[1])
    # the frozen denominators stay where the checkpoint put them
    for t in range(2):
        leaf = f'{t}_convolution'
        assert np.array_equal(after[leaf]['denominator'],
                              before[leaf]['denominator'])
    # from a reset optimizer the same epoch lands elsewhere
    _, reset = _port_epoch(path, reset=True)
    assert max(_update_errors(reset, j_after, before).values()) > 100


def test_optax_state_translation(jax_runs):
    """What the translation hands ``torch.optim.Adam``: JAX's count as
    every leaf's step, mu / nu of the trainable leaves only, and the LR
    the optax state holds (the scheduler's after one epoch)."""
    from sevennet_finetuning_tpu_torch.train.checkpoint import (
        OptaxState, load_checkpoint, model_from_checkpoint)
    from sevennet_finetuning_tpu_torch.train.trainer import Trainer

    path = jax_runs['adam'][0]
    blob = load_checkpoint(str(path))
    state = blob['optimizer_state_dict']
    assert isinstance(state, OptaxState)
    assert state.optax_name == 'InjectStatefulHyperparamsState'
    assert int(state.field('count')) == 3
    trainer = Trainer(model_from_checkpoint(str(path), device='cpu')[0],
                      blob['config'], device='cpu')
    trainer.load_optimizer_state(state)
    sd = trainer.optimizer.state_dict()
    assert sd['param_groups'][0]['lr'] == pytest.approx(1e-3, rel=1e-6)
    n_trainable = sum(len(g['params']) for g in sd['param_groups'])
    assert len(sd['state']) == n_trainable
    assert all(float(s['step']) == 3.0 for s in sd['state'].values())


def test_mismatched_optax_state_warns_and_reinitialises(jax_runs, tmp_path):
    """A continue whose optimizer is not the checkpoint's (sgd from an
    adam state) warns and starts from a fresh optimizer, as JAX's
    ``except`` branch does."""
    from sevennet_finetuning_tpu_torch import keys as K
    from sevennet_finetuning_tpu_torch import pipeline

    cfg = {K.CONTINUE: {K.CHECKPOINT: str(jax_runs['adam'][0])},
           K.CUTOFF: 4.0, K.OPTIMIZER: 'sgd', K.OPTIM_PARAM: {'lr': 1e-3},
           K.EPOCH: 2, K.BATCH_SIZE: 2, K.RATIO: 0.2,
           K.LOAD_DATASET: [str(FT)], K.DATA_FORMAT: 'extxyz',
           K.TRAIN_SHIFT_SCALE: True, K.TRAIN_DENOMINATOR: False,
           K.ERROR_RECORD: [['Energy', 'RMSE'], ['TotalLoss', 'None']]}
    with pytest.warns(UserWarning, match='optimizer state not restored'):
        pipeline.train(cfg, str(tmp_path / 'out'), device='cpu')
    log = (tmp_path / 'out' / 'log.sevenn').read_text()
    assert 'optimizer state not restored' in log


def _cli_yaml(path, ckpt):
    cfg = {'model': {'chemical_species': 'auto', 'cutoff': 4.0,
                     'train_shift_scale': True, 'train_denominator': False},
           'train': {'random_seed': 1, 'epoch': 2, 'per_epoch': 1,
                     'is_train_stress': True, 'optimizer': 'adam',
                     'optim_param': {'lr': 2e-3},
                     'scheduler': 'exponentiallr',
                     'scheduler_param': {'gamma': 0.5},
                     'error_record': [['Energy', 'RMSE'],
                                      ['Force', 'RMSE'],
                                      ['TotalLoss', 'None']],
                     'continue': {'checkpoint': str(ckpt)}},
           'data': {'batch_size': 2, 'data_divide_ratio': 0.2,
                    'load_dataset_path': [str(FT)]}}
    Path(path).write_text(yaml.safe_dump(cfg))
    return str(path)


def test_cli_continue_without_reset_matches_jax(jax_runs, tmp_path):
    from sevennet_finetuning_tpu.main import cmd_train
    from sevennet_finetuning_tpu_torch.main import main as cli

    path = _cli_yaml(tmp_path / 'in.yaml', jax_runs['adam'][0])
    with warnings.catch_warnings():
        warnings.simplefilter('error', UserWarning)   # state restored
        cli(['train', path, '-w', str(tmp_path / 'port'), '--device',
             'cpu'])
    cmd_train(argparse.Namespace(input=path, working_dir=str(
        tmp_path / 'jax'), calc_fisher=False, distributed=False))

    def rows(side):
        with open(tmp_path / side / 'log.csv') as f:
            return list(csv.DictReader(f))

    got, want = rows('port'), rows('jax')
    assert [r['epoch'] for r in got] == ['2'] and list(got[0]) == list(
        want[0])
    for col, w in want[0].items():
        a, b = float(got[0][col]), float(w)
        assert abs(a - b) <= 1e-4 * abs(b) + 1e-7, (col, a, b)
    assert 'optimizer state not restored' not in (
        tmp_path / 'port' / 'log.sevenn').read_text()


def test_continue_golden_starts_at_the_train_golden():
    """The continue golden's first step is the train golden's (the same
    parameters, batch and loss), so chip_smoke holds its gradients
    against ``train_ft900_jax_cpu.npz``; its second step moved by the
    restored state (the train golden's second step is the memory batch
    after a fresh adam step)."""
    gold = np.load(GOLDEN)
    train = np.load(GOLDEN.parent / 'train_ft900_jax_cpu.npz')
    assert gold['Total'][0] == train['Total'][0]
    assert int(gold['n_edge_slots']) == int(train['n_edge_slots'])
    assert not [k for k in gold.files if k.startswith('grad/')]
    assert len([k for k in gold.files if k.startswith('update/')]) == len(
        [k for k in train.files if k.startswith('grad/')]) == 63
    assert gold['Total'][1] != train['Total'][1]


# ---------------------------------------------------------------------------
# the golden file of chip_smoke.py's compat phase
# ---------------------------------------------------------------------------

def make_golden(out=GOLDEN):
    """The in-repo SevenNet-0 checkpoint (epoch 387, adam) continued with
    its optax state by the JAX Trainer under the reEWC recipe at a
    constant LR of 1e-4, two train steps: ft900's first batch-8 batch,
    then replay900's (the train phase's first rehearsal iteration).
    Stores each step's loss terms and every leaf's update over the first
    step.  The first step's gradient is ``train_ft900_jax_cpu.npz``'s
    (the same parameters and batch), which chip_smoke reads."""
    import os

    os.environ['SEVENN_NO_NATIVE'] = '1'
    import jax
    import jax.numpy as jnp
    import optax

    from sevennet_finetuning_tpu import keys as JK
    from sevennet_finetuning_tpu.data.dataset import GraphDataset, Loader
    from sevennet_finetuning_tpu.data.readers import read_extxyz
    from sevennet_finetuning_tpu.model.build import build_model_spec
    from sevennet_finetuning_tpu.model.nequip import apply_model
    from sevennet_finetuning_tpu.train.checkpoint import (
        load_checkpoint, load_pytree)
    from sevennet_finetuning_tpu.train.optim import set_lr
    from sevennet_finetuning_tpu.train.trainer import Trainer
    from sevennet_finetuning_tpu_torch.train.recipe import (
        reewc_recipe_config)

    jax.config.update('jax_platforms', 'cpu')
    blob = load_checkpoint(str(CKPT))
    cfg = reewc_recipe_config(blob['config'], FISHER, OPT_PARAMS)
    spec = build_model_spec(cfg)
    tm = dict(spec.type_map)
    params = jax.tree_util.tree_map(jnp.asarray, blob['model_state_dict'])
    jt = Trainer(spec, params, cfg, fisher=load_pytree(str(FISHER)),
                 opt_params=load_pytree(str(OPT_PARAMS)))
    jt.opt_state = set_lr(jax.tree_util.tree_map(
        np.asarray, blob['optimizer_state_dict']), 1e-4)
    batches = [next(iter(Loader(GraphDataset.from_structures(
        read_extxyz(str(p))[:24], spec.cutoff, tm), 8)))
        for p in (FT900, REPLAY900)]
    loss_fn, tx = jt.loss_fn, jt.tx

    @jax.jit
    def step(p, opt_state, batch):
        def lfn(q):
            total, terms = loss_fn(q, apply_model(spec, q, batch))
            return total, terms

        (total, terms), grads = jax.value_and_grad(lfn, has_aux=True)(p)
        updates, opt_state = tx.update(grads, opt_state, p)
        return optax.apply_updates(p, updates), opt_state, total, terms

    p, opt_state = jt.params, jt.opt_state
    res = {'n_edge_slots': np.int64(batches[0][JK.EDGE_IDX].shape[1])}
    for i, b in enumerate(batches):
        b = {k: jnp.asarray(v) for k, v in b.items()
             if k not in (JK.INFO, JK.USER_LABEL)}
        new_p, opt_state, total, terms = step(p, opt_state, b)
        res.setdefault('Total', []).append(float(total))
        for k, v in terms.items():
            res.setdefault(k, []).append(float(v))
        if i == 0:
            for g, names in p.items():
                for n in names:
                    res[f'update/{g}/{n}'] = np.asarray(
                        new_p[g][n]) - np.asarray(p[g][n])
        p = new_p
    np.savez_compressed(out, **{k: np.asarray(v) for k, v in res.items()})
    print(f'wrote {out}: totals {res["Total"]}')


if __name__ == '__main__':
    sys.path.insert(0, str(ROOT))
    make_golden()
