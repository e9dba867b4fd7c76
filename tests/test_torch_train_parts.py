"""The port's training modules, one by one, against the JAX package.

- ``train/loss.py``: every loss term (Huber and MSE, NaN labels, padded
  nodes and graphs, stress in kbar) and the EWC penalty against JAX
  ``build_loss_fn`` on the same numpy inputs;
- ``train/optim.py``: every LR controller over 1,000 epochs, and one masked
  adam step (frozen leaves untouched) against optax;
- ``train/metrics.py``: the accumulators and ``finalize`` against JAX;
- ``data/dataset.py``: statistics, ``divide``, the size-balanced packing and
  capacities, and the seeded shuffle draw the same batches as JAX;
- ``model``: ``trainable_mask`` equals JAX's;
- ``train/checkpoint.py`` / ``Trainer``: the Fisher artifacts load through
  the stub unpickler; a checkpoint dict round-trips.

Tolerances: loss terms and metrics 1e-6 relative (float32, the same
operations); LR controllers 1e-12 relative (the same float64 formulas);
the adam step 1e-6 of lr.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from sevennet_finetuning_tpu import keys as JK
from sevennet_finetuning_tpu.data import dataset as j_dataset
from sevennet_finetuning_tpu.data.readers import read_extxyz as j_read
from sevennet_finetuning_tpu.model.build import build_model_spec as j_build
from sevennet_finetuning_tpu.model.nequip import (
    init_params, trainable_mask as j_trainable_mask)
from sevennet_finetuning_tpu.train import loss as j_loss
from sevennet_finetuning_tpu.train import metrics as j_metrics
from sevennet_finetuning_tpu.train import optim as j_optim
from sevennet_finetuning_tpu_torch import keys as K
from sevennet_finetuning_tpu_torch.data import dataset
from sevennet_finetuning_tpu_torch.data.readers import read_extxyz
from sevennet_finetuning_tpu_torch.model.build import build_model_spec
from sevennet_finetuning_tpu_torch.model.nequip import (
    NequIP, load_jax_params, trainable_mask)
from sevennet_finetuning_tpu_torch.train import loss, metrics, optim
from sevennet_finetuning_tpu_torch.train.checkpoint import load_pytree
from sevennet_finetuning_tpu_torch.train.trainer import Trainer

ROOT = Path(__file__).resolve().parent.parent
FISHER = ROOT / 'experiments/ft_reewc/fisher_out/fisher_sevenn.pt'
OPT_PARAMS = ROOT / 'experiments/ft_reewc/fisher_out/opt_params_sevenn.pt'
FT900 = ROOT / 'experiments/ft_reewc_900/data/ft900.extxyz'
TYPE_MAP = {72: 0, 8: 1}


@pytest.fixture(autouse=True, scope='module')
def _ckdtree_neighbor_list():
    """Both packages build this file's graphs with the cKDTree neighbor
    list (the native core orders edges otherwise); restored after."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv('SEVENN_NO_NATIVE', '1')
        yield


def _rel_close(got, want, rtol=1e-6, atol=0.0):
    got = float(got)
    want = float(want)
    assert abs(got - want) <= rtol * abs(want) + atol, (got, want)


def _outputs(seed=0):
    """A padded batch's labels and predictions: 3 real graphs of 4 slots,
    10 real nodes of 12, NaN labels on one energy, one force row and one
    stress component."""
    rng = np.random.default_rng(seed)

    def f(*s):
        return rng.standard_normal(s).astype(np.float32)

    out = {
        K.NUM_ATOMS: np.array([3, 4, 3, 0], np.int32),
        K.NODE_MASK: np.array([1] * 10 + [0, 0], np.float32),
        K.BATCH: np.array([0] * 3 + [1] * 4 + [2] * 3 + [0, 0], np.int32),
        K.PRED_TOTAL_ENERGY: f(4) * 3, K.ENERGY: f(4) * 3,
        K.PRED_FORCE: f(12, 3) * 0.02, K.FORCE: f(12, 3) * 0.02,
        K.PRED_STRESS: f(4, 6) * 1e-3, K.STRESS: f(4, 6) * 1e-3,
    }
    out[K.ENERGY][1] = np.nan
    out[K.FORCE][4] = np.nan
    out[K.STRESS][2, 3] = np.nan
    return out


@pytest.mark.parametrize('crit', [('Huber', {'delta': 0.01}),
                                  ('mse', {})])
def test_loss_terms_match_jax(crit):
    name, params = crit
    cfg = {K.LOSS: name, K.LOSS_PARAM: params, K.FORCE_WEIGHT: 1.0,
           K.STRESS_WEIGHT: 0.01, K.IS_TRAIN_STRESS: True,
           K.CONTINUE: {K.FISHER: 'f', K.OPT_PARAMS: 'o',
                        K.EWC_LAMBDA: 1e5}}
    rng = np.random.default_rng(1)
    p = {'a': {'w0': rng.normal(size=(3, 4)).astype(np.float32)},
         'b': {'w0': rng.normal(size=(5,)).astype(np.float32),
               'w1': rng.normal(size=(2,)).astype(np.float32)}}
    fisher = {g: {n: np.abs(rng.normal(size=v.shape)).astype(np.float32)
                  for n, v in names.items()} for g, names in p.items()}
    anchor = {g: {n: (v + 0.01 * rng.normal(size=v.shape)).astype(
        np.float32) for n, v in names.items()} for g, names in p.items()}
    out = _outputs()
    j_specs = j_loss.loss_specs_from_config(cfg)
    t_specs = loss.loss_specs_from_config(cfg)
    assert [(s.name, s.weight) for s in t_specs] == [
        (s.name, s.weight) for s in j_specs]
    j_fn = j_loss.build_loss_fn(j_specs, fisher=fisher, opt_params=anchor)
    want_total, want = j_fn(jax.tree_util.tree_map(jnp.asarray, p),
                            {k: jnp.asarray(v) for k, v in out.items()})

    def t(tree):
        return {g: {n: torch.from_numpy(v) for n, v in names.items()}
                for g, names in tree.items()}

    t_fn = loss.build_loss_fn(t_specs, fisher=t(fisher), opt_params=t(anchor))
    got_total, got = t_fn(t(p), {k: torch.from_numpy(v)
                                 for k, v in out.items()})
    _rel_close(got_total, want_total)
    assert set(got) == set(want) == {'Energy', 'Force', 'Stress', 'EWC'}
    for k in want:
        _rel_close(got[k], want[k])


def test_custom_and_weighted_loss_options(tmp_path):
    # the custom loss plugin: the callback's terms, in its order
    (tmp_path / 'loss_plugin.py').write_text(
        'def build(config):\n'
        '    return [("Energy", 1.0, lambda p, o: o["e"].sum()),\n'
        '            ("Reg", 0.5, lambda p, o: o["e"].abs().sum())]\n')
    specs = loss.loss_specs_from_config({K.LOSS: 'custom', K.LOSS_PARAM: {
        'path': str(tmp_path), 'module': 'loss_plugin', 'function': 'build'}})
    assert [(s.name, s.weight) for s in specs] == [('Energy', 1.0),
                                                   ('Reg', 0.5)]
    total, terms = loss.build_loss_fn(specs)({}, {'e': torch.tensor([
        -2.0, 3.0])})
    assert float(total) == 1.0 + 0.5 * 5.0
    assert {k: float(v) for k, v in terms.items()} == {'Energy': 1.0,
                                                       'Reg': 5.0}
    # per-structure data weights are ported: the terms stay the same ones
    assert [s.name for s in loss.loss_specs_from_config(
        {K.LOAD_DATASET_WITH_WEIGHTS: True})] == ['Energy', 'Force']


CONTROLLERS = [
    ('constant', {}),
    ('exponentiallr', {'gamma': 0.995}),
    ('steplr', {'step_size': 70, 'gamma': 0.5}),
    ('multisteplr', {'milestones': [100, 400, 650], 'gamma': 0.3}),
    ('cosineannealinglr', {'T_max': 300, 'eta_min': 1e-6}),
    ('linearlr', {'start_factor': 0.2, 'total_iters': 40}),
    ('reducelronplateau', {'factor': 0.5, 'patience': 3}),
    ('cosineannealingwarmuplr', {'first_cycle_steps': 200, 'max_lr': 1e-4,
                                 'min_lr': 0.0, 'warmup_steps': 50,
                                 'gamma': 0.999, 'cycle_mult': 1.5}),
]


@pytest.mark.parametrize('name,params', CONTROLLERS)
def test_lr_controllers_match_jax(name, params):
    j_ctl = j_optim.SCHEDULERS[name](1e-3, **params)
    t_ctl = optim.SCHEDULERS[name](1e-3, **params)
    metric = np.abs(np.random.default_rng(2).normal(size=1000)) + np.repeat(
        np.linspace(1.0, 0.1, 10), 100)
    for epoch in range(1000):
        assert abs(t_ctl.lr - j_ctl.lr) <= 1e-12 * abs(j_ctl.lr), epoch
        j_ctl.step(float(metric[epoch]))
        t_ctl.step(float(metric[epoch]))
    assert t_ctl.state_dict() == j_ctl.state_dict()


def test_masked_adam_step_matches_optax():
    rng = np.random.default_rng(3)
    params = {'g': {'a': rng.normal(size=(4, 3)).astype(np.float32),
                    'frozen': rng.normal(size=(2,)).astype(np.float32)},
              'h': {'b': rng.normal(size=(5,)).astype(np.float32)}}
    mask = {'g': {'a': True, 'frozen': False}, 'h': {'b': True}}
    cfg = {K.OPTIMIZER: 'adam', K.OPTIM_PARAM: {'lr': 1e-3},
           K.SCHEDULER: 'constant'}
    tx, _ = j_optim.build_optimizer(cfg, mask)
    state = tx.init(jax.tree_util.tree_map(jnp.asarray, params))
    j_params = jax.tree_util.tree_map(jnp.asarray, params)
    t_params = {g: {n: torch.nn.Parameter(torch.from_numpy(v.copy()))
                    for n, v in names.items()} for g, names in params.items()}
    opt, ctl = optim.build_optimizer(cfg, t_params, mask)
    assert ctl.lr == 1e-3
    for step in range(3):
        grads = {g: {n: rng.normal(size=v.shape).astype(np.float32)
                     * 10.0 ** -step for n, v in names.items()}
                 for g, names in params.items()}
        upd, state = tx.update(jax.tree_util.tree_map(jnp.asarray, grads),
                               state, j_params)
        j_params = optax.apply_updates(j_params, upd)
        for g, names in t_params.items():
            for n, p in names.items():
                p.grad = torch.from_numpy(grads[g][n])
        opt.step()
    for g, names in params.items():
        for n, v in names.items():
            got = t_params[g][n].detach().numpy()
            np.testing.assert_allclose(got, np.asarray(j_params[g][n]),
                                       rtol=0, atol=1e-6 * 1e-3)
    np.testing.assert_array_equal(
        t_params['g']['frozen'].detach().numpy(), params['g']['frozen'])
    assert len(opt.state) == 2            # no moments for the frozen leaf
    optim.set_lr(opt, 5e-4)
    assert all(grp['lr'] == 5e-4 for grp in opt.param_groups)
    with pytest.raises(ValueError, match='unknown optimizer'):
        optim.build_optimizer({**cfg, K.OPTIMIZER: 'lbfgs'}, t_params, mask)


def test_metrics_match_jax():
    cfg = {K.LOSS: 'Huber', K.LOSS_PARAM: {'delta': 0.01},
           K.IS_TRAIN_STRESS: True,
           K.ERROR_RECORD: [['Energy', 'RMSE'], ['Force', 'RMSE'],
                            ['Stress', 'RMSE'], ['Energy', 'MAE'],
                            ['Force', 'MAE'], ['Stress', 'MAE'],
                            ['TotalEnergy', 'RMSE'], ['Force', 'VectorMAE'],
                            ['Force', 'ComponentRMSE'], ['Force', 'Loss'],
                            ['Stress_GPa', 'RMSE'], ['TotalLoss', 'None'],
                            ['EWCLoss', 'None']]}
    j_specs = j_metrics.metric_specs_from_config(cfg)
    t_specs = metrics.metric_specs_from_config(cfg)
    assert [s.label for s in t_specs] == [s.label for s in j_specs]
    j_acc = j_metrics.init_accumulators(j_specs)
    t_acc = metrics.init_accumulators(t_specs)
    for seed in range(3):
        out = _outputs(seed)
        terms = {'EWC': np.float32(0.1 * seed)}
        total = np.float32(1.5 + seed)
        j_acc = j_metrics.update_accumulators(
            j_specs, j_acc, {k: jnp.asarray(v) for k, v in out.items()},
            terms, total)
        t_acc = metrics.update_accumulators(
            t_specs, t_acc, {k: torch.from_numpy(v) for k, v in out.items()},
            {k: torch.tensor(v) for k, v in terms.items()},
            torch.tensor(total))
    want = j_metrics.finalize(j_specs, jax.device_get(j_acc))
    got = metrics.finalize(t_specs, metrics.fetch_accumulators(t_acc)[0])
    assert set(got) == set(want)
    for k in want:
        _rel_close(got[k], want[k], rtol=2e-6)


@pytest.fixture(scope='module')
def graphs():
    structs = j_read(str(FT900))[:21]
    j_ds = j_dataset.GraphDataset.from_structures(structs, 5.0, TYPE_MAP)
    t_ds = dataset.GraphDataset.from_structures(
        read_extxyz(str(FT900))[:21], 5.0, TYPE_MAP)
    return j_ds, t_ds


def test_dataset_statistics_and_divide_match_jax(graphs):
    j_ds, t_ds = graphs
    for name in ('per_atom_energy_mean', 'per_atom_energy_std', 'force_rms',
                 'avg_num_neigh'):
        _rel_close(getattr(t_ds, name)(), getattr(j_ds, name)(), rtol=1e-12)
    np.testing.assert_allclose(t_ds.species_ref_energies(2),
                               j_ds.species_ref_energies(2), rtol=1e-12)
    np.testing.assert_allclose(t_ds.species_force_rms(2),
                               j_ds.species_force_rms(2), rtol=1e-12)
    (jt, jv), (tt, tv) = j_ds.divide(0.2, seed=4), t_ds.divide(0.2, seed=4)
    for a, b in ((jt, tt), (jv, tv)):
        assert [int(g[JK.ENERGY][0] * 1e3) for g in a.graphs] == [
            int(g[K.ENERGY][0] * 1e3) for g in b.graphs]


@pytest.mark.parametrize('cache', [False, True])
def test_loader_draws_the_same_batches_as_jax(graphs, cache):
    j_ds, t_ds = graphs
    jl = j_dataset.Loader(j_ds, 4, shuffle=True, seed=7, cache=cache)
    tl = dataset.Loader(t_ds, 4, shuffle=True, seed=7, cache=cache)
    assert (tl.n_node, tl.n_edge, tl.n_graph, len(tl)) == (
        jl.n_node, jl.n_edge, jl.n_graph, len(jl))
    for _ in range(2):                     # two epochs: the rng advances
        for jb, tb in zip(jl, tl):
            for k in jb:
                if k in (JK.INFO, JK.USER_LABEL):
                    continue
                np.testing.assert_array_equal(jb[k], tb[k], err_msg=k)


def test_trainable_mask_matches_jax():
    cfg = {K.NUM_SPECIES: 2, K.TYPE_MAP: dict(TYPE_MAP),
           K.NODE_FEATURE_MULTIPLICITY: 4, K.LMAX: 1, K.NUM_CONVOLUTION: 2,
           K.SELF_CONNECTION_TYPE: 'linear', K.TRAIN_DENOMINATOR: True,
           K.RADIAL_BASIS: {K.RADIAL_BASIS_NAME: 'bessel',
                            'trainable_coeff': False}}
    for shift_scale in (False, True):
        c = {**cfg, K.TRAIN_SHIFT_SCALE: shift_scale}
        j_spec = j_build(c)
        want = j_trainable_mask(j_spec, init_params(j_spec, seed=0))
        assert trainable_mask(build_model_spec(c)) == want


def test_fisher_artifacts_load_and_checkpoint_roundtrips():
    fisher = load_pytree(str(FISHER))
    anchor = load_pytree(str(OPT_PARAMS))
    assert set(fisher) == set(anchor)
    cfg = {K.NUM_SPECIES: 2, K.TYPE_MAP: dict(TYPE_MAP),
           K.NODE_FEATURE_MULTIPLICITY: 4, K.LMAX: 1, K.NUM_CONVOLUTION: 2,
           K.SELF_CONNECTION_TYPE: 'linear', K.OPTIM_PARAM: {'lr': 1e-3},
           K.SCHEDULER: 'exponentiallr', K.SCHEDULER_PARAM: {'gamma': 0.5}}
    params = jax.tree_util.tree_map(np.asarray,
                                    init_params(j_build(cfg), seed=1))
    trainer = Trainer(load_jax_params(NequIP(build_model_spec(cfg)), params),
                      cfg, device='cpu')
    trainer.scheduler_step()
    assert trainer.get_lr() == 5e-4
    ckpt = trainer.get_checkpoint_dict()
    other = Trainer(NequIP(build_model_spec(cfg)), cfg, device='cpu')
    other.load_state_dicts(ckpt['model_state_dict'],
                           ckpt['optimizer_state_dict'],
                           ckpt['scheduler_state_dict'])
    assert other.get_lr() == 5e-4
    assert all(g['lr'] == 5e-4 for g in other.optimizer.param_groups)
    for g, names in params.items():
        for n, v in names.items():
            np.testing.assert_array_equal(
                other.params[g][n].detach().numpy(), v)
