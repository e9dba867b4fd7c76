"""The port's train CLI against the JAX package's, on the CPU.

A narrow NequIP (channel 4, lmax 1, 2 convolutions, SE(3), linear
self-connection) is trained from scratch by both CLIs from one YAML on
the in-repo ft.extxyz with rehearsal on replay.extxyz: ``init_params``
draws the same weights, and every
log.csv value agrees within the narrow-epoch tolerance of
``test_torch_train.py`` (1e-4 relative + 1e-7: float32 sums in another
order through the double backward).  The JAX package's
``load_checkpoint`` reads the port's checkpoints.  A continue run
numbers its epochs on, appends to log.csv and restores the port's own
optimizer state, so that it equals an uninterrupted run.  Per-structure
data weights (``load_dataset_with_weights``) reach the loss: weights of 1
give the unweighted run, others another one (the JAX CLI cannot take
them: its Trainer hands the weight dict to ``jnp.asarray``; the weighted
loss terms are held against JAX's in ``test_torch_pipeline.py``).
``preset``
prints the port's copies of the presets (``train -d`` is held against
single-process training in ``test_torch_parallel.py``).
"""

import argparse
import csv
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

from sevennet_finetuning_tpu.main import cmd_train as j_cmd_train
from sevennet_finetuning_tpu.train.checkpoint import (
    load_checkpoint as j_load_checkpoint)
from sevennet_finetuning_tpu_torch.main import main as cli
from sevennet_finetuning_tpu_torch.train.checkpoint import load_checkpoint

torch.set_num_threads(2)
ROOT = Path(__file__).resolve().parent.parent
FT = ROOT / 'experiments/ft_reewc/data/ft.extxyz'
REPLAY = ROOT / 'experiments/ft_reewc/data/replay.extxyz'
CKPT = ROOT / 'experiments/ft_reewc_900/conv_out/checkpoint_best.pth'
RTOL, ATOL = 1e-4, 1e-7


@pytest.fixture(autouse=True, scope='module')
def _ckdtree_neighbor_list():
    """Both packages build this file's graphs with the cKDTree neighbor
    list (the native core orders edges otherwise); restored after."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv('SEVENN_NO_NATIVE', '1')
        yield


def narrow_input(path, extra_train=None, extra_data=None, epochs=2):
    """A narrow from-scratch config as YAML at ``path``."""
    cfg = {
        'model': {'chemical_species': 'auto', 'cutoff': 4.0, 'channel': 4,
                  'lmax': 1, 'num_convolution_layer': 2,
                  'is_parity': False, 'self_connection_type': 'linear'},
        'train': {'random_seed': 1, 'epoch': epochs, 'per_epoch': 1,
                  'optimizer': 'adam', 'optim_param': {'lr': 0.005},
                  'scheduler': 'exponentiallr',
                  'scheduler_param': {'gamma': 0.9},
                  'error_record': [['Energy', 'RMSE'], ['Force', 'RMSE'],
                                   ['Stress', 'RMSE'], ['Energy', 'MAE'],
                                   ['TotalLoss', 'None']]},
        'data': {'batch_size': 2, 'data_divide_ratio': 0.2,
                 'load_dataset_path': [str(FT)]},
    }
    cfg['train'].update(extra_train or {})
    cfg['data'].update(extra_data or {})
    Path(path).write_text(yaml.safe_dump(cfg))
    return str(path)


def run_jax(yaml_path, wd, fisher=False):
    j_cmd_train(argparse.Namespace(input=str(yaml_path), working_dir=str(wd),
                                   calc_fisher=fisher, distributed=False))


def run_port(yaml_path, wd, fisher=False):
    return cli(['train', str(yaml_path), '-w', str(wd), '--device', 'cpu']
               + (['-fs'] if fisher else []))


def read_csv(path):
    with open(path) as f:
        return list(csv.DictReader(f))


def assert_rows_close(got, want, rtol=RTOL, atol=ATOL):
    assert len(got) == len(want) and list(got[0]) == list(want[0])
    for i, (g, w) in enumerate(zip(got, want)):
        for col in w:
            a, b = float(g[col]), float(w[col])
            assert abs(a - b) <= rtol * abs(b) + atol, (i, col, a, b)


@pytest.fixture(scope='module')
def scratch(tmp_path_factory):
    """The from-scratch run with rehearsal, JAX and port."""
    tmp = tmp_path_factory.mktemp('scratch')
    y = narrow_input(
        tmp / 'input.yaml',
        extra_data={'rehearsal': True, 'load_memory_path': [str(REPLAY)],
                    'mem_batch_size': 2})
    run_jax(y, tmp / 'jax')
    trainer = run_port(y, tmp / 'port')
    return tmp, trainer


def test_from_scratch_log_matches_jax(scratch):
    tmp, _ = scratch
    got, want = read_csv(tmp / 'port/log.csv'), read_csv(tmp / 'jax/log.csv')
    assert [r['epoch'] for r in got] == ['1', '2']
    assert 'memory_TotalLoss_None' in got[0]
    assert_rows_close(got, want)


def test_from_scratch_writes_the_jax_layout(scratch):
    tmp, trainer = scratch
    names = sorted(p.name for p in (tmp / 'jax').iterdir())
    assert sorted(p.name for p in (tmp / 'port').iterdir()) == names
    assert 'log.sevenn' in names and 'checkpoint_best.pth' in names
    assert trainer.device == torch.device('cpu')
    assert trainer.loss_fn is not None
    for name in ('checkpoint_1.pth', 'checkpoint_2.pth'):
        port = j_load_checkpoint(str(tmp / 'port' / name))
        jx = j_load_checkpoint(str(tmp / 'jax' / name))
        assert port['epoch'] == jx['epoch']
        assert port['scheduler_state_dict'] == jx['scheduler_state_dict']
        assert set(port['model_state_dict']) == set(jx['model_state_dict'])
        for g, names_ in jx['model_state_dict'].items():
            for n, want in names_.items():
                got = port['model_state_dict'][g][n]
                assert isinstance(got, np.ndarray)
                want = np.asarray(want)
                np.testing.assert_allclose(
                    got, want, rtol=0,
                    atol=1e-4 * max(float(np.abs(want).max()), 1e-3))


def test_checkpoint_round_trip(scratch):
    """The JAX package reads the port's checkpoint (numpy only), and the
    port reads back its own optimizer state as tensors."""
    tmp, trainer = scratch
    path = str(tmp / 'port/checkpoint_2.pth')
    blob = j_load_checkpoint(path)
    assert blob['format'] == 'sevennet_finetuning_tpu_torch'
    state = blob['optimizer_state_dict']['state']
    assert all(isinstance(v, np.ndarray) for s in state.values()
               for v in s.values())
    own = load_checkpoint(path)
    assert not own.get('optax_state_dropped')
    want = trainer.optimizer.state_dict()
    got = own['optimizer_state_dict']
    assert got['param_groups'] == want['param_groups']
    for i, s in want['state'].items():
        for k, v in s.items():
            assert torch.equal(got['state'][i][k], v), (i, k)
    assert blob['config']['_type_map'] == {72: 0, 8: 1}


def _continue_input(tmp, name, ckpt, epochs, reset_optimizer=False):
    return narrow_input(
        tmp / name, epochs=epochs,
        extra_train={'train_shuffle': False, 'continue': {
            'checkpoint': str(ckpt), 'reset_optimizer': reset_optimizer}})


def test_continue_equals_an_uninterrupted_run(tmp_path):
    base = {'train_shuffle': False}
    run_port(narrow_input(tmp_path / 'full.yaml', base, epochs=3),
             tmp_path / 'full')
    run_port(narrow_input(tmp_path / 'half.yaml', base, epochs=2),
             tmp_path / 'split')
    run_port(_continue_input(tmp_path, 'cont.yaml',
                             tmp_path / 'split/checkpoint_2.pth', 3),
             tmp_path / 'split')
    full, split = (read_csv(tmp_path / 'full/log.csv'),
                   read_csv(tmp_path / 'split/log.csv'))
    assert [r['epoch'] for r in split] == ['1', '2', '3']  # appended
    assert 'epoch continues from 3' in (tmp_path / 'split/log.sevenn'
                                        ).read_text()
    assert_rows_close(split, full, rtol=1e-6, atol=0)
    # the restored moments matter: a reset optimizer takes another step
    run_port(_continue_input(tmp_path, 'reset.yaml',
                             tmp_path / 'full/checkpoint_2.pth', 3,
                             reset_optimizer=True), tmp_path / 'reset')
    reset = read_csv(tmp_path / 'reset/log.csv')
    assert [r['epoch'] for r in reset] == ['3']
    assert float(reset[0]['train_TotalLoss_None']) != float(
        full[2]['train_TotalLoss_None'])


def test_data_weights_reach_the_loss(scratch, tmp_path):
    tmp, _ = scratch
    rows = {}
    for name, w in (('ones', [1.0, 1.0, 1.0]), ('weighted', [1.0, 2.0, 0.5])):
        y = narrow_input(tmp_path / f'{name}.yaml', extra_data={
            'load_dataset_with_weights': [[str(FT)] + w],
            'rehearsal': True, 'load_memory_path': [str(REPLAY)],
            'mem_batch_size': 2})
        trainer = run_port(y, tmp_path / name)
        assert trainer.config['load_dataset_with_weights'] is True
        rows[name] = read_csv(tmp_path / name / 'log.csv')
    assert_rows_close(rows['ones'], read_csv(tmp / 'port/log.csv'),
                      rtol=0, atol=0)
    assert float(rows['weighted'][0]['train_TotalLoss_None']) != float(
        rows['ones'][0]['train_TotalLoss_None'])


def test_preset_prints_the_port_copy(capsys):
    cli(['preset', 'sevennet-0'])
    text = capsys.readouterr().out
    assert yaml.safe_load(text)['model']['channel'] == 128
    with pytest.raises(SystemExit, match='available'):
        cli(['preset', 'no-such-preset'])


@pytest.mark.parametrize('sub', ['get_model_torchscript', 'graph_build'])
def test_torchscript_and_graph_build_subcommands_run(tmp_path, sub):
    """``get_model --torchscript`` and ``graph_build`` write their
    artifacts: a TorchScript with pair_e3gnn's metadata from the in-repo
    SevenNet-0 checkpoint, and a .sevenn_data that loads back."""
    if sub == 'graph_build':
        from sevennet_finetuning_tpu_torch.data.dataset import (
            load_sevenn_data)

        out = tmp_path / 'ft.sevenn_data'
        cli(['graph_build', str(FT), '5.0', '-o', str(out)])
        assert len(load_sevenn_data(str(out))) == 5
        return
    cli(['get_model', str(CKPT), '--torchscript', '-o',
         str(tmp_path / 'deployed_serial.sevenn')])
    extra = {'num_species': '', 'cutoff': '', 'model_type': ''}
    torch.jit.load(str(tmp_path / 'deployed_serial.pt'), _extra_files=extra)
    assert extra == {'num_species': b'89', 'cutoff': b'5.0',
                     'model_type': b'E3_equivariant_model'}


def test_train_needs_cuda_unless_asked(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    y = narrow_input(tmp_path / 'input.yaml')
    with pytest.raises(RuntimeError, match='CUDA'):
        cli(['train', y, '-w', str(tmp_path / 'out')])
    assert not (tmp_path / 'out/log.csv').exists()
