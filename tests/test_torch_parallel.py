"""Data-parallel training of the port over gloo, against the JAX package.

The port's data parallelism (``parallel/data_parallel``, the Trainer's
``data_parallel`` mode, the sharded ``Loader``, ``main train -d``) runs
in two gloo processes on the CPU, spawned once for the module
(``dp_run``), with several cases in them:

- one epoch of the Trainer in data-parallel mode from ``init_params`` on
  ``Loader(n_shards=2, shard_offset=rank)``, against JAX's
  ``Trainer(mesh=make_mesh(2))`` with ``Loader(n_shards=2)`` on the
  8-device virtual mesh of ``tests/conftest.py``: the epoch's metrics
  within 1e-4 relative, every parameter within JAX's own data-parallel
  limits (``rtol=2e-3, atol=2e-5``, ``tests/test_dp_pipeline.py``); both
  ranks end with the same parameters bit for bit;
- a rehearsal epoch under data parallelism (finite metrics, equal on
  both ranks, parameters bit-equal), mirroring
  ``test_dp_rehearsal_epoch_runs``;
- ``main train -d`` at batch 2 a rank against the single-process port
  CLI at batch 4 on the same data (the same global batches): log.csv,
  written once by rank 0, within ``rel=2e-3, abs=1e-6`` value by value,
  the final parameters within ``rtol=2e-3, atol=2e-5`` (mirroring
  ``test_dp_training_matches_single_device``), no file of rank 1;
- no rank process imports jax, optax or the JAX package.

``chip_smoke.py``'s ddp phase holds two gloo ranks on the card against
``golden/pipeline_ft_dp2_jax_cpu.npz``, the JAX CLI's 2-shard run of the
pipeline's reEWC fine-tune; regenerate it with (JAX on the CPU, several
minutes)

    PYTHONPATH=. python tests/test_torch_parallel.py

The loader's shard slices are held against JAX's stacked batches bit for
bit.  Every spawn and wait has a timeout, so a deadlocked collective
fails its test instead of hanging the run.
"""

import csv
import os
import pickle
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

from sevennet_finetuning_tpu import keys as JK
from sevennet_finetuning_tpu.data.dataset import (
    GraphDataset as JGraphDataset, Loader as JLoader)
from sevennet_finetuning_tpu.data.vasp import Structure as JStructure
from sevennet_finetuning_tpu_torch import keys as K
from sevennet_finetuning_tpu_torch.data.dataset import GraphDataset, Loader
from sevennet_finetuning_tpu_torch.data.elements import z_to_symbol
from sevennet_finetuning_tpu_torch.data.vasp import Structure

ROOT = Path(__file__).resolve().parent.parent
TIMEOUT_S = 240
torch.set_num_threads(2)


@pytest.fixture(autouse=True, scope='module')
def _ckdtree_neighbor_list():
    """Both packages build this file's graphs with the cKDTree neighbor
    list; restored after."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv('SEVENN_NO_NATIVE', '1')
        yield


def _arrays(n, n_atoms=10, seed=0):
    """The JAX test's random structures as plain arrays
    (``tests/test_dp_pipeline.py::_structures``)."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        cell = np.eye(3) * max(4.0, (n_atoms / 0.05) ** (1.0 / 3.0))
        out.append(dict(
            species=[z_to_symbol(int(rng.choice([8, 72])))
                     for _ in range(n_atoms)],
            pos=rng.uniform(0, cell[0, 0], (n_atoms, 3)), cell=cell,
            energy=float(-5.0 * n_atoms + rng.normal()),
            forces=rng.normal(size=(n_atoms, 3)),
            stress=rng.normal(size=6) * 0.01))
    return out


def _structures(arrays, cls):
    return [cls(**a) for a in arrays]


def _config(**over):
    cfg = {
        K.NODE_FEATURE_MULTIPLICITY: 8, K.LMAX: 1, K.NUM_CONVOLUTION: 2,
        K.CUTOFF: 4.5, K.IS_PARITY: False, K.SELF_CONNECTION_TYPE: 'linear',
        K.CONV_DENOMINATOR: 'avg_num_neigh', K.SHIFT: 'per_atom_energy_mean',
        K.SCALE: 'force_rms', K.IS_TRAIN_STRESS: True, K.OPTIMIZER: 'adam',
        K.OPTIM_PARAM: {'lr': 1e-3}, K.FORCE_WEIGHT: 0.1,
        K.STRESS_WEIGHT: 1e-6, K.EPOCH: 2, K.PER_EPOCH: 0,
        K.TRAIN_SHUFFLE: False, K.RANDOM_SEED: 1, K.RATIO: 0.5,
        K.CHEMICAL_SPECIES: 'Auto', K.REMAT: False,
    }
    cfg.update(over)
    return cfg


# --- the sharded loader ------------------------------------------------------

def _both_datasets(n, seed):
    arrays = _arrays(n, n_atoms=8, seed=seed)
    tm = {8: 0, 72: 1}
    return (GraphDataset.from_structures(_structures(arrays, Structure), 4.5,
                                         tm),
            JGraphDataset.from_structures(_structures(arrays, JStructure),
                                          4.5, tm))


def _same_batch(got, want):
    for k, v in want.items():
        if k in (K.INFO, K.USER_LABEL):
            continue
        assert np.array_equal(got[k], np.asarray(v), equal_nan=True), k


@pytest.mark.parametrize('shuffle', [False, True])
def test_loader_sharding_shapes_and_cycling(shuffle):
    """6 graphs over 4 shards of batch 1: 2 global steps, the tail
    cycled from the front; each rank's shard (``shard_offset = rank``)
    equals JAX's stacked batch at that index, at JAX's capacities."""
    ds, jds = _both_datasets(6, seed=3)
    jl = JLoader(jds, batch_size=1, n_shards=4, shuffle=shuffle, seed=7)
    want = list(jl)
    assert len(want) == 2
    for d in range(4):
        part = Loader(ds, batch_size=1, n_shards=4, shard_offset=d,
                      shuffle=shuffle, seed=7)
        assert len(part) == 2 and part.is_sharded
        assert (part.n_node, part.n_edge) == (jl.n_node, jl.n_edge)
        got = list(part)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert g[K.POS].ndim == 2
            assert g[K.EDGE_IDX].shape[0] == 2
            _same_batch(g, {k: v[d] for k, v in w.items()
                            if k not in (JK.INFO, JK.USER_LABEL)})


def test_loader_local_shard_slice():
    """The processes holding shards 2 and 3 collate exactly JAX's slice
    [2, 4) of the global order (JAX's multi-process emulation, a
    process holding both); with cache=True the sharded loader keeps
    JAX's capacities (no balanced packing)."""
    ds, jds = _both_datasets(8, seed=4)
    jpart = list(JLoader(jds, batch_size=1, n_shards=4, n_local_shards=2,
                         shard_offset=2))
    assert len(jpart) == 2
    for d in (2, 3):
        got = list(Loader(ds, batch_size=1, n_shards=4, shard_offset=d))
        assert len(got) == len(jpart)
        for pb, jb in zip(got, jpart):
            assert np.asarray(jb[JK.POS]).shape[0] == 2
            np.testing.assert_array_equal(np.asarray(jb[JK.POS])[d - 2],
                                          pb[K.POS])
    cj = JLoader(jds, batch_size=2, n_shards=2, cache=True)
    cp = Loader(ds, batch_size=2, n_shards=2, cache=True, shard_offset=1)
    assert (cp.n_node, cp.n_edge) == (cj.n_node, cj.n_edge)
    for got, want in zip(cp.materialize(), cj.materialize()):
        _same_batch(got, {k: v[1] for k, v in want.items()
                          if k not in (JK.INFO, JK.USER_LABEL)})


# --- two gloo ranks ----------------------------------------------------------

WORKER = r'''
import os, pickle, sys
import numpy as np
import torch
torch.set_num_threads(1)
from sevennet_finetuning_tpu_torch import keys as K
from sevennet_finetuning_tpu_torch.data.dataset import GraphDataset, Loader
from sevennet_finetuning_tpu_torch.data.vasp import Structure
from sevennet_finetuning_tpu_torch.main import main as cli
from sevennet_finetuning_tpu_torch.model.build import build_model_spec
from sevennet_finetuning_tpu_torch.model.nequip import (
    NequIP, init_params, load_jax_params)
from sevennet_finetuning_tpu_torch.parallel import data_parallel as dp
from sevennet_finetuning_tpu_torch.train.trainer import Trainer

work = sys.argv[1]
assert dp.maybe_init_distributed('cpu', timeout_s=120)
rank = dp.process_rank()
assert dp.world_size() == 2 and torch.distributed.get_backend() == 'gloo'
with open(os.path.join(work, 'inputs.pkl'), 'rb') as f:
    inp = pickle.load(f)
cfg = inp['config']
tm = cfg[K.TYPE_MAP]
spec = build_model_spec(cfg)


def dataset(arrays):
    return GraphDataset.from_structures([Structure(**a) for a in arrays],
                                        cfg[K.CUTOFF], tm)


def trainer():
    model = load_jax_params(NequIP(spec), init_params(spec, 0))
    return Trainer(model, dict(cfg), device='cpu', data_parallel=True)


def params(tr):
    return {f'{g}/{n}': p.detach().numpy().copy()
            for g, names in tr.params.items() for n, p in names.items()}


out = {}
# the mean of the gradients and the sum of the accumulators
p, q = torch.nn.Parameter(torch.zeros(3)), torch.nn.Parameter(torch.zeros(2))
p.grad = torch.full((3,), float(rank + 1))
dp.average_gradients([p, q])
acc = {'a_sum': torch.tensor(rank + 1.0), 'a_cnt': torch.tensor(1.0)}
dp.sum_accumulators(acc)
out['reduce'] = (p.grad.numpy().copy(), q.grad, float(acc['a_sum']),
                 float(acc['a_cnt']))
# one data-parallel epoch
tr = trainer()
tl = Loader(dataset(inp['train']), 2, n_shards=2, shard_offset=rank)
out['epoch'] = tr.run_one_epoch(tl, is_train=True)
out['epoch_params'] = params(tr)
# a rehearsal epoch
tr = trainer()
tl = Loader(dataset(inp['train']), 1, n_shards=2, shard_offset=rank)
ml = Loader(dataset(inp['memory']), 1, n_shards=2, shard_offset=rank,
            shuffle=True, seed=3)
out['rehearsal'] = tr.run_one_epoch_rehearsal(tl, ml, is_train=True)
out['rehearsal_params'] = params(tr)
# the CLI
tr = cli(['train', inp['yaml'], '-w', os.path.join(work, 'dp'), '-d',
          '--device', 'cpu'])
out['cli_params'] = params(tr)
out['bad'] = sorted(m for m in sys.modules
                    if m.split('.')[0] in ('jax', 'jaxlib', 'optax',
                                           'sevennet_finetuning_tpu'))
with open(os.path.join(work, f'rank{rank}.pkl'), 'wb') as f:
    pickle.dump(out, f)
torch.distributed.destroy_process_group()
print('RANK', rank, 'DP_OK')
'''


def free_port() -> int:
    with socket.socket() as s:
        s.bind(('localhost', 0))
        return s.getsockname()[1]


def spawn_ranks(script: Path, args, world: int, extra_env=None):
    """``world`` processes of ``script`` in one gloo group (the env that
    torchrun sets, plus ``extra_env``); returns the Popen objects."""
    port = free_port()
    procs = []
    for rank in range(world):
        env = {k: v for k, v in os.environ.items()
               if k not in ('XLA_FLAGS', 'JAX_PLATFORMS', 'SEVENN_NO_NATIVE')}
        env.update(PYTHONPATH=str(ROOT), MASTER_ADDR='localhost',
                   MASTER_PORT=str(port), RANK=str(rank),
                   WORLD_SIZE=str(world), LOCAL_RANK=str(rank),
                   OMP_NUM_THREADS='1', **(extra_env or {}))
        procs.append(subprocess.Popen(
            [sys.executable, str(script), *map(str, args)], cwd=str(ROOT),
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    return procs


def wait_ranks(procs, timeout=TIMEOUT_S):
    """Wait for every rank (killing all at the timeout); each must exit
    0.  Returns their outputs."""
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for rank, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f'rank {rank} failed:\n{out[-4000:]}'
    return outs


def _write_yaml(path, data_path, batch):
    path.write_text(yaml.safe_dump({
        'model': {'chemical_species': 'auto', 'cutoff': 4.5, 'channel': 8,
                  'lmax': 1, 'num_convolution_layer': 2,
                  'is_parity': False, 'self_connection_type': 'linear'},
        'train': {'random_seed': 1, 'epoch': 2, 'per_epoch': 0,
                  'optimizer': 'adam', 'optim_param': {'lr': 1e-3},
                  'force_loss_weight': 0.1, 'stress_loss_weight': 1e-6,
                  'train_shuffle': False},
        'data': {'batch_size': batch, 'data_divide_ratio': 0.5,
                 'load_dataset_path': [str(data_path)]},
    }))
    return str(path)


def _read_csv(path):
    with open(path) as f:
        return list(csv.DictReader(f))


@pytest.fixture(scope='module')
def dp_run(tmp_path_factory):
    """Two gloo ranks (the module's one spawn) beside the JAX 2-shard
    epoch and the single-process port CLI run on the same data."""
    import jax

    from sevennet_finetuning_tpu.logger import Logger as JLogger
    from sevennet_finetuning_tpu.model.build import build_model_spec
    from sevennet_finetuning_tpu.model.nequip import init_params
    from sevennet_finetuning_tpu.parallel.data_parallel import make_mesh
    from sevennet_finetuning_tpu.pipeline import (resolve_statistics,
                                                  setup_species)
    from sevennet_finetuning_tpu.train.trainer import Trainer as JTrainer
    from sevennet_finetuning_tpu_torch.data.readers import write_extxyz
    from sevennet_finetuning_tpu_torch.main import main as cli

    work = tmp_path_factory.mktemp('dp')
    train_a = _arrays(16, n_atoms=8, seed=1)
    mem_a = _arrays(8, n_atoms=8, seed=2)
    cli_a = _arrays(16, n_atoms=10, seed=0)
    data = work / 'data.extxyz'
    write_extxyz(str(data), _structures(cli_a, Structure))

    with jax.enable_x64(False):
        cfg = _config()
        jtrain = _structures(train_a, JStructure)
        setup_species(cfg, jtrain)
        jset = JGraphDataset.from_structures(jtrain, cfg[K.CUTOFF],
                                             cfg[K.TYPE_MAP])
        resolve_statistics(cfg, jset, JLogger(os.devnull))
    with open(work / 'inputs.pkl', 'wb') as f:
        pickle.dump(dict(config=cfg, train=train_a, memory=mem_a,
                         yaml=_write_yaml(work / 'dp.yaml', data, 2)), f)
    script = work / 'worker.py'
    script.write_text(WORKER)
    procs = spawn_ranks(script, [work], 2, {'SEVENN_NO_NATIVE': '1'})
    try:
        with jax.enable_x64(False):
            spec = build_model_spec(cfg)
            jt = JTrainer(spec, init_params(spec, seed=0), cfg,
                          mesh=make_mesh(2))
            jm = jt.run_one_epoch(JLoader(jset, 2, n_shards=2),
                                  is_train=True)
            jp = {f'{g}/{n}': np.asarray(v)
                  for g, names in jax.device_get(jt.params).items()
                  for n, v in names.items()}
        single = cli(['train', _write_yaml(work / 'single.yaml', data, 4),
                      '-w', str(work / 'single'), '--device', 'cpu'])
    finally:
        outs = wait_ranks(procs)
    ranks = []
    for r in range(2):
        with open(work / f'rank{r}.pkl', 'rb') as f:
            ranks.append(pickle.load(f))
    sp = {f'{g}/{n}': p.detach().numpy()
          for g, names in single.params.items() for n, p in names.items()}
    return dict(work=work, jax_metrics=jm, jax_params=jp, ranks=ranks,
                single_params=sp, outs=outs)


def test_dp_epoch_matches_jax_two_shards(dp_run):
    got, want = dp_run['ranks'][0]['epoch'], dp_run['jax_metrics']
    assert set(got) == set(want)
    for k, v in want.items():
        assert got[k] == pytest.approx(float(v), rel=1e-4), k
    assert dp_run['ranks'][1]['epoch'] == got
    params = dp_run['ranks'][0]['epoch_params']
    assert set(params) == set(dp_run['jax_params'])
    for k, v in dp_run['jax_params'].items():
        np.testing.assert_allclose(params[k], v, rtol=2e-3, atol=2e-5,
                                   err_msg=k)


@pytest.mark.parametrize('case', ['epoch', 'rehearsal', 'cli'])
def test_dp_ranks_end_bit_equal(dp_run, case):
    a, b = (r[f'{case}_params'] for r in dp_run['ranks'])
    assert set(a) == set(b)
    for k in a:
        assert np.array_equal(a[k], b[k]), k


def test_dp_gradients_are_averaged_and_metrics_summed(dp_run):
    for r in dp_run['ranks']:
        grad, none, a_sum, a_cnt = r['reduce']
        assert np.array_equal(grad, np.full(3, 1.5, np.float32))
        assert none is None and (a_sum, a_cnt) == (3.0, 2.0)


def test_dp_rehearsal_epoch_runs(dp_run):
    (t0, m0), (t1, m1) = (r['rehearsal'] for r in dp_run['ranks'])
    assert (t0, m0) == (t1, m1)
    for v in list(t0.values()) + list(m0.values()):
        assert np.isfinite(v)


def test_dp_cli_matches_single_process(dp_run):
    work = dp_run['work']
    rows1 = _read_csv(work / 'single' / 'log.csv')
    rows2 = _read_csv(work / 'dp' / 'log.csv')
    assert len(rows1) == len(rows2) == 2
    for r1, r2 in zip(rows1, rows2):
        assert r1.keys() == r2.keys()
        for col in r1:
            if col in ('epoch', 'lr'):
                assert r1[col] == r2[col]
                continue
            assert float(r2[col]) == pytest.approx(
                float(r1[col]), rel=2e-3, abs=1e-6), col
    log = (work / 'dp' / 'log.sevenn').read_text()
    assert 'data-parallel training: 2 ranks, backend gloo' in log
    # rank 0 alone wrote: one header, one row an epoch
    assert (work / 'dp' / 'log.csv').read_text().count('epoch,lr') == 1
    for k, v in dp_run['single_params'].items():
        np.testing.assert_allclose(dp_run['ranks'][0]['cli_params'][k], v,
                                   rtol=2e-3, atol=2e-5, err_msg=k)


def test_dp_ranks_import_no_jax(dp_run):
    for r, out in zip(dp_run['ranks'], dp_run['outs']):
        assert r['bad'] == []
        assert 'DP_OK' in out


def test_trainer_data_parallel_needs_a_group(monkeypatch):
    from sevennet_finetuning_tpu_torch.model.build import build_model_spec
    from sevennet_finetuning_tpu_torch.model.nequip import (
        NequIP, init_params, load_jax_params)
    from sevennet_finetuning_tpu_torch.parallel import data_parallel as dp
    from sevennet_finetuning_tpu_torch.train.trainer import Trainer

    cfg = _config(**{K.NUM_SPECIES: 2, K.TYPE_MAP: {8: 0, 72: 1},
                     K.SHIFT: 0.0, K.SCALE: 1.0, K.CONV_DENOMINATOR: 10.0})
    spec = build_model_spec(cfg)
    model = load_jax_params(NequIP(spec), init_params(spec, 0))
    for var in ('RANK', 'WORLD_SIZE', 'MASTER_ADDR', 'MASTER_PORT'):
        monkeypatch.delenv(var, raising=False)
    assert not dp.maybe_init_distributed('cpu')
    assert not dp.is_distributed() and dp.process_rank() == 0
    with pytest.raises(ValueError, match='process group'):
        Trainer(model, cfg, device='cpu', data_parallel=True)


# --- the data-parallel pipeline golden ---------------------------------------

def _write_dp_pipeline_golden():
    """``golden/pipeline_ft_dp2_jax_cpu.npz``: the fine-tune stage of
    ``recipe.pipeline_stages`` through the JAX CLI with ``-d`` on a
    2-device virtual mesh at batch 2 and memory batch 2 a shard (the
    global batches of the single-process golden's batch 4), from the
    JAX Fisher stage's artifacts: its log.csv, a column an array over the
    epochs (``csv/<column>``), as ``pipeline_ft_jax_cpu.npz`` holds the
    single-process run's.  ``chip_smoke.py``'s ddp phase holds its two
    gloo ranks against it."""
    import argparse
    import tempfile

    from sevennet_finetuning_tpu.main import cmd_train as j_cmd_train
    from sevennet_finetuning_tpu_torch.train.recipe import pipeline_stages

    import jax

    assert jax.device_count() == 2, jax.devices()
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        fisher, ft = pipeline_stages(ROOT, str(tmp / 'fisher_out'))
        ft['data'].update(batch_size=2, mem_batch_size=2)
        for name, cfg, wd, fs, d in (('fisher', fisher, 'fisher_out', True,
                                      False),
                                     ('ft', ft, 'ft_out', False, True)):
            path = tmp / f'{name}_input.yaml'
            path.write_text(yaml.safe_dump(cfg))
            j_cmd_train(argparse.Namespace(
                input=str(path), working_dir=str(tmp / wd), calc_fisher=fs,
                distributed=d))
        rows = _read_csv(tmp / 'ft_out' / 'log.csv')
        assert 'data-parallel training: 2 devices' in (
            tmp / 'ft_out' / 'log.sevenn').read_text()
    arrays = {f'csv/{col}': np.array([float(r[col]) for r in rows])
              for col in rows[0]}
    out = ROOT / ('sevennet_finetuning_tpu_torch/golden/'
                  'pipeline_ft_dp2_jax_cpu.npz')
    np.savez_compressed(out, **arrays)
    print(f'wrote {out}: valid totals {arrays["csv/valid_TotalLoss_None"]}')


if __name__ == '__main__':
    # JAX on the CPU with a 2-device mesh; the pipeline goldens are made
    # on the cKDTree neighbor list
    os.environ['XLA_FLAGS'] = '--xla_force_host_platform_device_count=2'
    os.environ['SEVENN_NO_NATIVE'] = '1'
    import jax

    jax.config.update('jax_platforms', 'cpu')
    sys.path.insert(0, str(ROOT))
    _write_dp_pipeline_golden()
