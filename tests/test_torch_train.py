"""The port's train step against the JAX package's Trainer.

- A narrow NequIP (2 convolutions, channel 4, lmax 2, SE(3), linear
  self-connection) with numpy-seeded parameters, Fisher and anchor is
  trained by both Trainers for 3 rehearsal iterations (3 train batches,
  2 memory batches cycling) on in-repo structures: per-step loss terms,
  first-step gradients of every leaf and the epoch metrics agree.
- ``compute_fisher_matrix`` agrees with JAX on batch-1 samples.
- The full-width SevenNet-0 checkpoint trained for 2 steps on the 12-atom
  structure of ft.extxyz agrees with a committed JAX-CPU golden file.

The golden files hold the JAX Trainer's per-step loss terms under the
reEWC recipe of ``experiments/ft_reewc_900/ft900_timing_r5.yaml`` (Huber
delta 0.01, force weight 1, stress weight 0.01, EWC lambda 1e5 with the
in-repo Fisher and anchor), from ``checkpoint_best.pth``, with one
change: a constant LR of 1e-4, because the recipe's cosine warmup starts
at min_lr = 0 and its first epoch would not move the parameters at all.

- ``train_ft12_jax_cpu.npz``: 2 steps on the 12-atom structure of
  ft.extxyz, plus the first step's gradient of every leaf;
- ``train_ft900_jax_cpu.npz``: 3 rehearsal iterations at batch 8 (the
  first 24 structures of ft900.extxyz and of replay900.extxyz, unshuffled),
  per-step terms, the first step's gradient of every leaf and the epoch
  metrics, and each of the six batches' loss terms at the checkpoint's
  parameters (``eval/``); ``chip_smoke.py`` holds the GPU train step
  against it.

Regenerate both with

    python tests/test_torch_train.py

and the pipeline golden (``pipeline_ft_jax_cpu.npz``: the JAX CLI's
Fisher and reEWC fine-tune stages of ``recipe.pipeline_stages``, which
``chip_smoke.py`` holds the port's CLI against) with

    python tests/test_torch_train.py pipeline

Tolerances (float32 sums in another order through a double backward):
per-step total loss rel 1e-4; each term within 1e-4 of the step's total
loss (the per-atom energy term squares an error of ~1e-4 eV/atom, which
float32 resolves to ~1e-2 relative only); first-step gradients within
1e-3 x max|g| of each leaf at full width (2e-2 for the atomic-energy
shift, whose gradient is the float32-resolved energy residual), 1e-4 on
the narrow model.
"""

import os
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from sevennet_finetuning_tpu import keys as JK
from sevennet_finetuning_tpu.data.dataset import (
    GraphDataset as JGraphDataset, Loader as JLoader)
from sevennet_finetuning_tpu.data.readers import read_extxyz as j_read
from sevennet_finetuning_tpu.model.build import build_model_spec as j_build
from sevennet_finetuning_tpu.model.nequip import (
    apply_model as j_apply_model, init_params)
from sevennet_finetuning_tpu.train.metrics import (
    finalize as j_finalize, init_accumulators as j_init_acc,
    update_accumulators as j_update_acc)
from sevennet_finetuning_tpu.train.trainer import Trainer as JTrainer
from sevennet_finetuning_tpu_torch import keys as K
from sevennet_finetuning_tpu_torch.data.dataset import GraphDataset, Loader
from sevennet_finetuning_tpu_torch.data.readers import read_extxyz
from sevennet_finetuning_tpu_torch.model.build import build_model_spec
from sevennet_finetuning_tpu_torch.model.nequip import (
    NequIP, apply_model, load_jax_params)
from sevennet_finetuning_tpu_torch.train.checkpoint import (
    load_pytree, model_from_checkpoint)
from sevennet_finetuning_tpu_torch.train.metrics import init_accumulators
from sevennet_finetuning_tpu_torch.train.recipe import reewc_recipe_config
from sevennet_finetuning_tpu_torch.train.trainer import Trainer

torch.set_num_threads(2)
ROOT = Path(__file__).resolve().parent.parent
CKPT = ROOT / 'experiments/ft_reewc_900/conv_out/checkpoint_best.pth'
FISHER = ROOT / 'experiments/ft_reewc/fisher_out/fisher_sevenn.pt'
OPT_PARAMS = ROOT / 'experiments/ft_reewc/fisher_out/opt_params_sevenn.pt'
FT = ROOT / 'experiments/ft_reewc/data/ft.extxyz'
FT900 = ROOT / 'experiments/ft_reewc_900/data/ft900.extxyz'
REPLAY900 = ROOT / 'experiments/ft_reewc_900/data/replay900.extxyz'
GOLDEN = ROOT / 'sevennet_finetuning_tpu_torch/golden'
GOLDEN_FT12 = GOLDEN / 'train_ft12_jax_cpu.npz'
GOLDEN_FT900 = GOLDEN / 'train_ft900_jax_cpu.npz'
TERMS = ('Total', 'Energy', 'Force', 'Stress', 'EWC')
TYPE_MAP = {72: 0, 8: 1}


def _no_native():
    """The JAX neighbor list on its scipy path, the one the port copies."""
    os.environ['SEVENN_NO_NATIVE'] = '1'


def _jax_device(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()
            if k not in (JK.INFO, JK.USER_LABEL)}


def jax_steps(jt, batches, kinds):
    """Run the JAX Trainer's train step (its value_and_grad, optax update
    and accumulators, with the loss terms and gradients exposed) over
    ``batches``; ``kinds`` names the accumulator ('train' / 'mem') of
    each step.  Returns per-step terms, the first step's gradients and
    the finalized metrics of each kind."""
    spec, loss_fn, tx, mspecs = jt.spec, jt.loss_fn, jt.tx, jt.metric_specs

    @jax.jit
    def step(params, opt_state, batch, acc):
        def lfn(p):
            out = j_apply_model(spec, p, batch, remat=jt.remat)
            total, terms = loss_fn(p, out)
            return total, (out, terms)

        (total, (out, terms)), grads = jax.value_and_grad(
            lfn, has_aux=True)(params)
        updates, opt_state = tx.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        acc = j_update_acc(mspecs, acc, out, terms, total)
        return params, opt_state, acc, total, terms, grads

    params, opt_state = jt.params, jt.opt_state
    accs = {k: j_init_acc(mspecs) for k in set(kinds)}
    rows, first_grads = [], None
    for batch, kind in zip(batches, kinds):
        params, opt_state, accs[kind], total, terms, grads = step(
            params, opt_state, _jax_device(batch), accs[kind])
        rows.append({'Total': float(total),
                     **{k: float(v) for k, v in terms.items()}})
        if first_grads is None:
            first_grads = jax.tree_util.tree_map(np.asarray, grads)
    metrics = {k: j_finalize(mspecs, jax.device_get(a))
               for k, a in accs.items()}
    return rows, first_grads, metrics


def port_steps(trainer, batches):
    """Port train steps; per-step terms and the first step's gradients."""
    acc = init_accumulators(trainer.metric_specs, trainer.device)
    rows, first_grads = [], None
    for batch in batches:
        acc, terms = trainer.train_step(trainer.place_batch(batch), acc)
        rows.append({k: float(v) for k, v in terms.items()})
        if first_grads is None:
            first_grads = {g: {n: p.grad.detach().cpu().numpy()
                               for n, p in names.items()}
                           for g, names in trainer.params.items()}
    return rows, first_grads


def assert_terms_close(got_rows, want_rows, weights, rtol=1e-4):
    """Total within rtol; each weighted term within rtol of the total."""
    assert len(got_rows) == len(want_rows)
    for i, (got, want) in enumerate(zip(got_rows, want_rows)):
        total = abs(want['Total'])
        assert abs(got['Total'] - want['Total']) <= rtol * total, (
            i, got, want)
        for k, w in weights.items():
            assert w * abs(got[k] - want[k]) <= rtol * total, (i, k, got,
                                                               want)


def loss_weights(trainer):
    return {ls.name: ls.weight for ls in trainer.loss_specs}


# the atomic-energy shift's gradient is the per-atom energy residual
# itself (~1e-4 eV/atom on the fine-tuned checkpoint), which float32
# resolves to ~1e-2 relative at a total energy of ~100 eV
ENERGY_RESIDUAL_LEAVES = {('rescale_atomic_energy', 'shift'): 2e-2}


def assert_grads_close(got, want, rtol, loose=None):
    """Every leaf within rtol x max|g| (``loose``: per-leaf overrides)."""
    worst = 0.0
    for g, names in want.items():
        for n, w in names.items():
            tol = (loose or {}).get((g, n), rtol)
            scale = max(float(np.abs(w).max()), 1e-30)
            err = float(np.abs(got[g][n] - w).max())
            assert err <= tol * scale, (g, n, err, scale)
            worst = max(worst, err / scale)
    return worst


# ---------------------------------------------------------------------------
# narrow model: the JAX Trainer and the port on the same numpy-seeded state
# ---------------------------------------------------------------------------

def _narrow_config():
    return {
        K.NUM_SPECIES: 2, K.TYPE_MAP: dict(TYPE_MAP),
        K.NODE_FEATURE_MULTIPLICITY: 4, K.LMAX: 2, K.NUM_CONVOLUTION: 2,
        K.CUTOFF: 5.0, K.SELF_CONNECTION_TYPE: 'linear',
        K.CONV_DENOMINATOR: 30.0, K.SHIFT: [-9.0, -4.5],
        K.SCALE: [1.7, 1.3], K.IS_PARITY: False,
        K.CUTOFF_FUNCTION: {K.CUTOFF_FUNCTION_NAME: 'XPLOR',
                            K.CUTOFF_ON: 4.5},
        K.TRAIN_SHIFT_SCALE: True, K.TRAIN_DENOMINATOR: True,
        K.IS_TRAIN_STRESS: True, K.LOSS: 'Huber',
        K.LOSS_PARAM: {'delta': 0.01}, K.OPTIMIZER: 'adam',
        K.OPTIM_PARAM: {'lr': 1e-3}, K.SCHEDULER: 'constant',
        K.FORCE_WEIGHT: 1.0, K.STRESS_WEIGHT: 0.01,
        K.CONTINUE: {K.FISHER: 'fisher', K.OPT_PARAMS: 'anchor',
                     K.EWC_LAMBDA: 10.0},
        K.ERROR_RECORD: [['Energy', 'RMSE'], ['Force', 'RMSE'],
                         ['Stress', 'RMSE'], ['Force', 'MAE'],
                         ['TotalLoss', 'None'], ['EWCLoss', 'None']],
    }


def _small_structures(reader):
    """Twelve-atom HfO2 cells of ft900 (train) and the first four replay
    structures (60 + 3 x 12 atoms, memory)."""
    ft = reader(str(FT900))
    train = [s for s in ft[:40] if len(s) == 12][:6]
    return train, reader(str(REPLAY900))[:4]


@pytest.fixture(scope='module')
def narrow():
    _no_native()
    cfg = _narrow_config()
    j_spec = j_build(cfg)
    params = jax.tree_util.tree_map(np.asarray, init_params(j_spec, seed=5))
    rng = np.random.default_rng(6)
    fisher = jax.tree_util.tree_map(
        lambda a: np.abs(rng.standard_normal(a.shape)).astype(np.float32),
        params)
    anchor = jax.tree_util.tree_map(
        lambda a: (a + 0.01 * rng.standard_normal(a.shape)).astype(
            np.float32), params)
    j_train, j_mem = _small_structures(j_read)
    t_train, t_mem = _small_structures(read_extxyz)
    jl = JLoader(JGraphDataset.from_structures(j_train, 5.0, TYPE_MAP), 2)
    jml = JLoader(JGraphDataset.from_structures(j_mem, 5.0, TYPE_MAP), 2)
    tl = Loader(GraphDataset.from_structures(t_train, 5.0, TYPE_MAP), 2)
    tml = Loader(GraphDataset.from_structures(t_mem, 5.0, TYPE_MAP), 2)
    assert (len(jl), len(jml)) == (3, 2)

    jt = JTrainer(j_spec, jax.tree_util.tree_map(jnp.asarray, params), cfg,
                  fisher=fisher, opt_params=anchor)
    jb, jmb = list(jl), list(jml)
    order = [jb[0], jmb[0], jb[1], jmb[1], jb[2], jmb[0]]
    kinds = ['train', 'mem'] * 3
    j_rows, j_grads, j_metrics = jax_steps(jt, order, kinds)

    def port_trainer():
        model = load_jax_params(NequIP(build_model_spec(cfg)), params)
        return Trainer(model, cfg, fisher=fisher, opt_params=anchor,
                       device='cpu')

    tb, tmb = list(tl), list(tml)
    tt = port_trainer()
    t_rows, t_grads = port_steps(
        tt, [tb[0], tmb[0], tb[1], tmb[1], tb[2], tmb[0]])
    t_metrics = port_trainer().run_one_epoch_rehearsal(tl, tml)
    return dict(j_rows=j_rows, j_grads=j_grads, j_metrics=j_metrics,
                t_rows=t_rows, t_grads=t_grads, t_metrics=t_metrics,
                weights=loss_weights(tt), cfg=cfg, params=params,
                fisher=fisher, anchor=anchor,
                j_spec=j_spec, jb=jb, tb=tb)


def test_narrow_loss_trajectory_matches_jax(narrow):
    assert_terms_close(narrow['t_rows'], narrow['j_rows'],
                       narrow['weights'])
    # the loss moves: adam at lr 1e-3 over six steps
    assert narrow['t_rows'][4]['Total'] != narrow['t_rows'][0]['Total']


def test_narrow_first_step_grads_match_jax(narrow):
    assert_grads_close(narrow['t_grads'], narrow['j_grads'], 1e-4)


def test_narrow_rehearsal_epoch_metrics_match_jax(narrow):
    t_train, t_mem = narrow['t_metrics']
    for got, want in ((t_train, narrow['j_metrics']['train']),
                      (t_mem, narrow['j_metrics']['mem'])):
        assert set(got) == set(want)
        for k, w in want.items():
            assert abs(got[k] - w) <= 1e-4 * abs(w) + 1e-7, (k, got, want)


def test_narrow_frozen_leaves_do_not_move():
    cfg = {**_narrow_config(), K.TRAIN_SHIFT_SCALE: False,
           K.TRAIN_DENOMINATOR: False, K.CONTINUE: {}}
    spec = build_model_spec(cfg)
    params = jax.tree_util.tree_map(np.asarray,
                                    init_params(j_build(cfg), seed=5))
    trainer = Trainer(load_jax_params(NequIP(spec), params), cfg,
                      device='cpu')
    train, _ = _small_structures(read_extxyz)
    loader = Loader(GraphDataset.from_structures(train[:2], 5.0, TYPE_MAP),
                    2)
    trainer.run_one_epoch(loader, is_train=True)
    after = trainer.get_checkpoint_dict()['model_state_dict']
    frozen = [('rescale_atomic_energy', 'shift'),
              ('rescale_atomic_energy', 'scale'),
              ('0_convolution', 'denominator')]
    for g, n in frozen:
        np.testing.assert_array_equal(after[g][n], params[g][n])
    assert not np.array_equal(after['0_convolution']['weight_nn_w0'],
                              params['0_convolution']['weight_nn_w0'])
    held = {id(p) for grp in trainer.optimizer.param_groups
            for p in grp['params']}
    for g, n in frozen:
        assert id(trainer.params[g][n]) not in held


def test_fisher_matches_jax(narrow):
    cfg = {**narrow['cfg'], K.CONTINUE: {}}     # the data loss only
    train, _ = _small_structures(j_read)
    jl = JLoader(JGraphDataset.from_structures(train[:3], 5.0, TYPE_MAP), 1)
    jt = JTrainer(narrow['j_spec'],
                  jax.tree_util.tree_map(jnp.asarray, narrow['params']), cfg)
    t_train, _ = _small_structures(read_extxyz)
    tl = Loader(GraphDataset.from_structures(t_train[:3], 5.0, TYPE_MAP), 1)
    model = load_jax_params(NequIP(build_model_spec(cfg)), narrow['params'])
    tt = Trainer(model, cfg, device='cpu')
    totals = sorted(
        float(tt.loss_fn(tt.params, apply_model(tt.model,
                                                tt.place_batch(b)))[0]
              .detach()) for b in tl)
    # no threshold, then one between the two smallest sample losses
    for thr, n_taken in ((-1.0, 3), (0.5 * (totals[0] + totals[1]), 1)):
        jf, jo, jn = jt.compute_fisher_matrix(jl, loss_thr=thr)
        tf, to, tn = tt.compute_fisher_matrix(tl, loss_thr=thr)
        assert (tn, jn) == (n_taken, n_taken), (tn, jn, n_taken, totals)
        # squared gradients: twice the gradients' relative error
        assert_grads_close(tf, jf, 2e-4)
        assert_grads_close(to, jo, 0.0)


# ---------------------------------------------------------------------------
# full width: SevenNet-0 from the checkpoint against the JAX-CPU golden
# ---------------------------------------------------------------------------

def ft12_batches(reader, cutoff, type_map, n_steps=2):
    """The 12-atom structure of ft.extxyz as one batch, ``n_steps`` times."""
    ds_cls = GraphDataset if reader is read_extxyz else JGraphDataset
    loader_cls = Loader if reader is read_extxyz else JLoader
    s = [x for x in reader(str(FT)) if len(x) == 12]
    loader = loader_cls(ds_cls.from_structures(s, cutoff, type_map), 1)
    return list(loader) * n_steps


def test_full_width_ft12_matches_golden():
    gold = np.load(GOLDEN_FT12)
    model, config = model_from_checkpoint(str(CKPT), device='cpu')
    cfg = reewc_recipe_config(config, FISHER, OPT_PARAMS)
    trainer = Trainer(model, cfg, fisher=load_pytree(str(FISHER)),
                      opt_params=load_pytree(str(OPT_PARAMS)),
                      device='cpu')
    batches = ft12_batches(read_extxyz, model.spec.cutoff,
                           dict(model.spec.type_map))
    rows, grads = port_steps(trainer, batches)
    want = [{k: float(gold[k][i]) for k in TERMS} for i in range(len(rows))]
    assert_terms_close(rows, want, loss_weights(trainer))
    want_g = {}
    for key in gold.files:
        if key.startswith('grad/'):
            _, g, n = key.split('/')
            want_g.setdefault(g, {})[n] = gold[key]
    assert sum(v.size for names in want_g.values()
               for v in names.values()) == 842_623
    assert_grads_close(grads, want_g, 1e-3, loose=ENERGY_RESIDUAL_LEAVES)


# ---------------------------------------------------------------------------
# golden files (JAX on the CPU)
# ---------------------------------------------------------------------------

def _jax_trainer():
    from sevennet_finetuning_tpu.train.checkpoint import (
        load_checkpoint as j_load_checkpoint, load_pytree as j_load_pytree)

    blob = j_load_checkpoint(str(CKPT))
    cfg = reewc_recipe_config(blob['config'], FISHER, OPT_PARAMS)
    spec = j_build(cfg)
    jt = JTrainer(spec, jax.tree_util.tree_map(jnp.asarray,
                                               blob['model_state_dict']),
                  cfg, fisher=j_load_pytree(str(FISHER)),
                  opt_params=j_load_pytree(str(OPT_PARAMS)))
    return jt, cfg


def ft900_loaders(reader, ds_cls, loader_cls, cutoff, type_map):
    """Batch-8 loaders over the first 24 structures of ft900.extxyz and of
    replay900.extxyz, unshuffled."""
    train = ds_cls.from_structures(reader(str(FT900))[:24], cutoff,
                                   type_map)
    mem = ds_cls.from_structures(reader(str(REPLAY900))[:24], cutoff,
                                 type_map)
    return loader_cls(train, 8), loader_cls(mem, 8)


def _write_goldens():
    _no_native()
    jt, cfg = _jax_trainer()
    tm = cfg[JK.TYPE_MAP]
    batches = ft12_batches(j_read, cfg[JK.CUTOFF], tm)
    rows, grads, _ = jax_steps(jt, batches, ['train'] * len(batches))
    arrays = {k: np.array([r[k] for r in rows]) for k in TERMS}
    for g, names in grads.items():
        for n, v in names.items():
            arrays[f'grad/{g}/{n}'] = np.asarray(v, np.float32)
    GOLDEN.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(GOLDEN_FT12, **arrays)
    print(f'wrote {GOLDEN_FT12}: totals {arrays["Total"]}')

    jt, cfg = _jax_trainer()
    jl, jml = ft900_loaders(j_read, JGraphDataset, JLoader, cfg[JK.CUTOFF],
                            tm)
    jb, jmb = list(jl), list(jml)
    order = [b for pair in zip(jb, jmb) for b in pair]
    kinds = ['train', 'mem'] * len(jb)
    # every batch's loss at the checkpoint's parameters (no update)
    evaluate = jax.jit(lambda p, b: jt.loss_fn(p, j_apply_model(jt.spec, p,
                                                                b)))
    evals = []
    for b in order:
        total, terms = evaluate(jt.params, _jax_device(b))
        evals.append({'Total': float(total),
                      **{k: float(v) for k, v in terms.items()}})
    rows, grads, metrics = jax_steps(jt, order, kinds)
    arrays = {k: np.array([r[k] for r in rows]) for k in TERMS}
    arrays.update({f'eval/{k}': np.array([r[k] for r in evals])
                   for k in TERMS})
    for g, names in grads.items():
        for n, v in names.items():
            arrays[f'grad/{g}/{n}'] = np.asarray(v, np.float32)
    arrays['is_mem'] = np.array([k == 'mem' for k in kinds])
    for kind, m in metrics.items():
        for key, v in m.items():
            arrays[f'{kind}/{key}'] = np.float64(v)
    arrays['n_edge_slots'] = np.int64(jl.n_edge)
    arrays['real_edges'] = np.array(
        [int(b[JK.EDGE_MASK].sum()) for b in order])
    np.savez_compressed(GOLDEN_FT900, **arrays)
    print(f'wrote {GOLDEN_FT900}: totals {arrays["Total"]}')


def run_jax_stages(workdir):
    """The two stages of ``recipe.pipeline_stages`` through the JAX
    package's CLI (``cmd_train``, as ``main train`` runs it) in
    ``workdir``: the Fisher stage with ``-fs`` into ``fisher_out``, then
    the fine-tune into ``ft_out``."""
    import argparse

    import yaml

    from sevennet_finetuning_tpu.main import cmd_train as j_cmd_train
    from sevennet_finetuning_tpu_torch.train.recipe import pipeline_stages

    _no_native()
    workdir = Path(workdir)
    fisher_dir = workdir / 'fisher_out'
    for name, cfg, wd, fs in zip(
            ('fisher', 'ft'), pipeline_stages(ROOT, str(fisher_dir)),
            (fisher_dir, workdir / 'ft_out'), (True, False)):
        path = workdir / f'{name}_input.yaml'
        path.write_text(yaml.safe_dump(cfg))
        j_cmd_train(argparse.Namespace(input=str(path), working_dir=str(wd),
                                       calc_fisher=fs, distributed=False))
    return fisher_dir, workdir / 'ft_out'


def _write_pipeline_golden():
    """``golden/pipeline_ft_jax_cpu.npz``: the Fisher stage's Fisher
    leaves (``fisher/<group>/<name>``) and the sha256 of each anchor leaf
    (``opt_params_sha256/...``), and the fine-tune's log.csv, a column
    an array over the epochs (``csv/<column>``)."""
    import csv
    import hashlib
    import tempfile

    from sevennet_finetuning_tpu.train.checkpoint import (
        load_pytree as j_load_pytree)

    with tempfile.TemporaryDirectory() as tmp:
        fisher_dir, ft_dir = run_jax_stages(tmp)
        arrays = {}
        fisher = j_load_pytree(str(fisher_dir / 'fisher_sevenn.pt'))
        anchor = j_load_pytree(str(fisher_dir / 'opt_params_sevenn.pt'))
        for g, names in fisher.items():
            for n, v in names.items():
                arrays[f'fisher/{g}/{n}'] = np.asarray(v, np.float32)
                a = np.ascontiguousarray(anchor[g][n], np.float32)
                arrays[f'opt_params_sha256/{g}/{n}'] = np.array(
                    hashlib.sha256(a.tobytes()).hexdigest())
        with open(ft_dir / 'log.csv') as f:
            rows = list(csv.DictReader(f))
        for col in rows[0]:
            arrays[f'csv/{col}'] = np.array([float(r[col]) for r in rows])
        arrays['checkpoints'] = np.array(sorted(
            p.name for p in ft_dir.glob('checkpoint_*.pth')))
    out = GOLDEN / 'pipeline_ft_jax_cpu.npz'
    np.savez_compressed(out, **arrays)
    print(f'wrote {out}: epochs {arrays["csv/epoch"]}, valid totals '
          f'{arrays["csv/valid_TotalLoss_None"]}')


if __name__ == '__main__':
    sys.path.insert(0, str(ROOT))
    jax.config.update('jax_platforms', 'cpu')
    if sys.argv[1:] == ['pipeline']:
        _write_pipeline_golden()
    else:
        _write_goldens()
