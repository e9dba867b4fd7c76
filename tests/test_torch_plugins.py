"""The plugin hooks of the port against the JAX package's: the custom
interaction block and the custom loss (reference:
sevenn/model_build.py:92-100, sevenn/train/loss.py:312-321).

Each package loads its own plugin from ``tmp_path`` (JAX's
``tests/test_plugins.py`` writes its source the same way); the two
sources differ only in their array library.  On the narrow 24-atom Si-O
cell of ``test_torch_mace.py``, JAX side under ``jax.enable_x64(False)``:

- the custom block's ``init_params`` bit for bit, the model's energy,
  forces and stress (1e-5 relative), one train step (loss terms 1e-5,
  per-leaf gradients 1e-4 of the leaf's max|g|) and a few steps that
  lower the loss;
- the custom loss's terms (``Energy``, ``Reg``) and gradients for one
  train step of a narrow NequIP, and the EWC term it keeps;
- ``main train`` with both plugins from one YAML each (one epoch on
  ft.extxyz) against the JAX CLI's log.csv.
"""

import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

from sevennet_finetuning_tpu_torch import keys as K
from sevennet_finetuning_tpu_torch.model.build import build_model_spec
from sevennet_finetuning_tpu_torch.train import loss
from tests.test_torch_mace import (_ckdtree,  # noqa: F401
                                   check_model_matches_jax,
                                   check_train_step_matches_jax,
                                   narrow_batches, narrow_config)

torch.set_num_threads(2)

JAX_PLUGIN = '''
import jax
import jax.numpy as jnp

from sevennet_finetuning_tpu import keys as K
from sevennet_finetuning_tpu.model.nequip import CustomBlockSpec
from sevennet_finetuning_tpu.ops.linear import (
    apply_linear, init_linear_weights, linear_spec,
)


def build_block(t, irreps_x, irreps_filter, irreps_out, num_species,
                radial_hidden, bessel_num, config):
    """A linear mix plus radially weighted messages summed at dst."""
    lin = linear_spec(irreps_x, irreps_out)

    def init(rng):
        return {f'w{i}': w
                for i, w in enumerate(init_linear_weights(lin, rng))}

    def apply(params, x, ctx):
        h = apply_linear(
            lin, [params[f'w{i}'] for i in range(len(params))], x
        )
        agg = jax.ops.segment_sum(
            h[ctx['edge_src']] * ctx['emb'][:, :1],
            ctx['edge_dst'], num_segments=ctx['n_node'],
        )
        return h + agg / 10.0

    return CustomBlockSpec(t=t, irreps_x=irreps_x, irreps_out=irreps_out,
                           init=init, apply=apply)


def build_losses(config):
    def energy_mse(params, out):
        n = jnp.maximum(out[K.NUM_ATOMS], 1).astype(jnp.float32)
        mask = jnp.isfinite(out[K.ENERGY]) & (out[K.NUM_ATOMS] > 0)
        err = (out[K.PRED_TOTAL_ENERGY] / n
               - jnp.where(mask, out[K.ENERGY], 0.0) / n) ** 2
        return jnp.sum(err * mask) / jnp.maximum(jnp.sum(mask), 1)

    def l2_reg(params, out):
        return sum(jnp.sum(w ** 2)
                   for w in jax.tree_util.tree_leaves(params))

    return [('Energy', 1.0, energy_mse), ('Reg', 1e-4, l2_reg)]
'''

TORCH_PLUGIN = '''
import torch

from sevennet_finetuning_tpu_torch import keys as K
from sevennet_finetuning_tpu_torch.model.nequip import CustomBlockSpec
from sevennet_finetuning_tpu_torch.ops.linear import (
    apply_linear, init_linear_weights, linear_spec,
)
from sevennet_finetuning_tpu_torch.ops.scatter import (
    aggregate_messages, gather_rows,
)


def build_block(t, irreps_x, irreps_filter, irreps_out, num_species,
                radial_hidden, bessel_num, config):
    """A linear mix plus radially weighted messages summed at dst."""
    lin = linear_spec(irreps_x, irreps_out)

    def init(rng):
        return {f'w{i}': w
                for i, w in enumerate(init_linear_weights(lin, rng))}

    def apply(params, x, ctx):
        h = apply_linear(
            lin, [params[f'w{i}'] for i in range(len(params))], x
        )
        agg = aggregate_messages(
            gather_rows(h, ctx['edge_src']) * ctx['emb'][:, :1],
            ctx['edge_dst'], ctx['n_node'], True,
        )
        return h + agg / 10.0

    return CustomBlockSpec(t=t, irreps_x=irreps_x, irreps_out=irreps_out,
                           init=init, apply=apply)


def build_losses(config):
    def energy_mse(params, out):
        n = torch.clamp(out[K.NUM_ATOMS], min=1).to(torch.float32)
        mask = torch.isfinite(out[K.ENERGY]) & (out[K.NUM_ATOMS] > 0)
        ref = torch.where(mask, out[K.ENERGY], torch.zeros_like(n))
        err = (out[K.PRED_TOTAL_ENERGY] / n - ref / n) ** 2
        return torch.sum(err * mask) / torch.clamp(mask.sum(), min=1)

    def l2_reg(params, out):
        return sum(torch.sum(w ** 2)
                   for names in params.values() for w in names.values())

    return [('Energy', 1.0, energy_mse), ('Reg', 1e-4, l2_reg)]
'''


@pytest.fixture(scope='module')
def plugins(tmp_path_factory):
    """The directory of both packages' plugin modules, under names of
    their own (a module is imported once per process)."""
    d = tmp_path_factory.mktemp('plugins')
    (d / 'jax_plugin.py').write_text(textwrap.dedent(JAX_PLUGIN))
    (d / 'torch_plugin.py').write_text(textwrap.dedent(TORCH_PLUGIN))
    return str(d)


def _block_configs(path):
    def cfg(module):
        return narrow_config('custom', **{
            K._CUSTOM_INTERACTION_BLOCK_CALLBACK: {
                'path': path, 'module': module, 'function': 'build_block'}})

    return cfg('jax_plugin'), cfg('torch_plugin')


def _loss_configs(path):
    def cfg(module):
        return narrow_config('nequip', **{
            K.LOSS: 'custom',
            K.LOSS_PARAM: {'path': path, 'module': module,
                           'function': 'build_losses'}})

    return cfg('jax_plugin'), cfg('torch_plugin')


def test_custom_block_matches_jax(plugins):
    j_cfg, t_cfg = _block_configs(plugins)
    spec = build_model_spec(t_cfg)
    assert [b.block_type for b in spec.blocks] == ['custom', 'custom']
    check_model_matches_jax(j_cfg, t_cfg=t_cfg)


def test_custom_block_train_step_matches_jax(plugins):
    j_cfg, t_cfg = _block_configs(plugins)
    trainer = check_train_step_matches_jax(j_cfg, t_cfg)
    assert set(trainer.params['0_custom_block']) == {'w0'}
    # the plugin's leaves train; a custom block has no denominator
    from sevennet_finetuning_tpu_torch.model.nequip import trainable_mask
    assert trainable_mask(trainer.spec)['1_custom_block'] == {'w0': True}


def test_custom_block_trains(plugins):
    """Five steps of the port's Trainer on the narrow cell lower the
    loss."""
    from sevennet_finetuning_tpu_torch.model.nequip import (
        NequIP, init_params, load_jax_params)
    from sevennet_finetuning_tpu_torch.train.metrics import (
        init_accumulators)
    from sevennet_finetuning_tpu_torch.train.trainer import Trainer

    _, t_cfg = _block_configs(plugins)
    t_cfg = {**t_cfg, K.OPTIMIZER: 'adam', K.OPTIM_PARAM: {'lr': 0.01}}
    spec = build_model_spec(t_cfg)
    trainer = Trainer(load_jax_params(NequIP(spec), init_params(spec, 0)),
                      t_cfg, device='cpu')
    _, tb = narrow_batches(t_cfg, forces=True)
    batch = trainer.place_batch(tb)
    acc = init_accumulators(trainer.metric_specs, trainer.device)
    totals = []
    for _ in range(5):
        acc, terms = trainer.train_step(batch, acc)
        totals.append(float(terms['Total']))
    assert np.isfinite(totals).all() and totals[-1] < totals[0]


def test_custom_loss_matches_jax(plugins):
    j_cfg, t_cfg = _loss_configs(plugins)
    specs = loss.loss_specs_from_config(t_cfg)
    assert [(s.name, s.weight) for s in specs] == [('Energy', 1.0),
                                                   ('Reg', 1e-4)]
    assert all(s.custom_fn is not None for s in specs)
    check_train_step_matches_jax(j_cfg, t_cfg, terms=('Total', 'Energy',
                                                      'Reg'))


def test_custom_loss_keeps_ewc(plugins):
    """With a Fisher and an anchor the custom terms are followed by the
    EWC term (weight lambda / 2), as in the JAX package."""
    from sevennet_finetuning_tpu.train import loss as j_loss

    j_cfg, t_cfg = _loss_configs(plugins)
    cont = {K.CONTINUE: {K.FISHER: 'f.pt', K.OPT_PARAMS: 'o.pt',
                         K.EWC_LAMBDA: 10.0}}
    got = loss.loss_specs_from_config({**t_cfg, **cont})
    want = j_loss.loss_specs_from_config({**j_cfg, **cont})
    assert [(s.name, s.weight) for s in got] == [(s.name, s.weight)
                                                 for s in want]
    assert got[-1].name == 'EWC' and got[-1].weight == 5.0


def test_main_train_custom_block_and_loss_match_jax_cli(plugins, tmp_path):
    """``main train`` from a YAML with ``interaction_type: custom`` (the
    model section's ``_custom_interaction_block_callback``) and ``loss:
    custom``, one epoch on ft.extxyz: each CLI loads its own plugin and
    the log.csv values agree within the CLI tests' limits."""
    from tests.test_torch_cli import (assert_rows_close, narrow_input,
                                      read_csv, run_jax, run_port)

    logs = {}
    for pkg, run in (('jax', run_jax), ('torch', run_port)):
        y = narrow_input(tmp_path / f'{pkg}.yaml', epochs=1)
        cfg = yaml.safe_load(Path(y).read_text())
        cfg['model'].update({
            'interaction_type': 'custom',
            '_custom_interaction_block_callback': {
                'path': plugins, 'module': f'{pkg}_plugin',
                'function': 'build_block'}})
        cfg['train'].update({
            'loss': 'custom', 'loss_param': {
                'path': plugins, 'module': f'{pkg}_plugin',
                'function': 'build_losses'},
            'error_record': [['Energy', 'RMSE'], ['TotalLoss', 'None']]})
        Path(y).write_text(yaml.safe_dump(cfg))
        out = run(y, tmp_path / pkg)
        logs[pkg] = read_csv(tmp_path / pkg / 'log.csv')
    assert [b.block_type for b in out.spec.blocks] == ['custom', 'custom']
    assert [s.name for s in out.loss_specs] == ['Energy', 'Reg']
    assert_rows_close(logs['torch'], logs['jax'])
