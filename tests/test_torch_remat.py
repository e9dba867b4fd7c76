"""Per-block rematerialization of the port against the JAX package's.

- ``resolve_remat`` decides as JAX's over a grid: SevenNet-0 (the
  in-repo checkpoint), the families golden's MACE, Gaunt and Gaunt-gate
  configurations and a custom plugin block; edge slots around each
  threshold, two budgets set through ``SEVENNET_TPU_ACT_BUDGET_GB``,
  ``('auto', 2.0)``, True and False.  Unset, the budget is 5/8 of the
  device's memory (the CPU's physical RAM here).
- ``run_blocks(remat=True)`` gives ``remat=False``'s features bit for bit
  for every block family (nequip, mace, gaunt, gaunt_gate, custom) on the
  narrow 24-atom cell of ``test_torch_mace.py``, dst-sorted and
  unsorted; in float64 its force-pass and parameter gradients (a loss on
  the forces differentiated once more) lie within 1e-9 of the plain
  path's max.
- A narrow train step with ``remat: True`` against JAX's
  ``value_and_grad`` over ``apply_model(remat=True)`` (loss terms 1e-4
  of the total, gradients 1e-4 of each leaf's max|g|, the narrow limits
  of ``test_torch_train.py``), and against the port's own ``remat:
  False`` in float64 (1e-9 of the total and of each leaf's max); the
  Fisher with remat against the Fisher without.
- The tensors saved for backward after the force pass of a 5-block
  model: with remat under half the plain path's bytes (a
  ``torch.utils.checkpoint`` of each block keeps nearly all of them,
  because the force pass recomputes the activations and the double
  backward's graph holds them).
- ``remat=True`` refuses intermediate capture and the halo exchange
  (``ValueError``), and the Trainer resolves 'auto' per batch.
- The launch census of a SevenNet-0 remat train step, counted on the
  plain versions on the 12-atom structure, is ``chip_smoke.py``'s
  ``REMAT_TRAIN_CENSUS`` at ``remat_segment_shapes``.
"""

import contextlib
import dataclasses
import os
import sys
import textwrap
import weakref
from collections import Counter
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sevennet_finetuning_tpu.data.dataset import (
    GraphDataset as JGraphDataset, Loader as JLoader)
from sevennet_finetuning_tpu.data.readers import read_extxyz as j_read
from sevennet_finetuning_tpu.model.build import build_model_spec as j_build
from sevennet_finetuning_tpu.model.nequip import (
    init_params as j_init, resolve_remat as j_resolve_remat)
from sevennet_finetuning_tpu.train.trainer import Trainer as JTrainer
from sevennet_finetuning_tpu_torch import keys as K
from sevennet_finetuning_tpu_torch.data.dataset import GraphDataset, Loader
from sevennet_finetuning_tpu_torch.data.readers import read_extxyz
from sevennet_finetuning_tpu_torch.model import nequip
from sevennet_finetuning_tpu_torch.model.build import build_model_spec
from sevennet_finetuning_tpu_torch.model.nequip import (
    NequIP, apply_model_train, batch_to_torch, compute_edge_vec,
    embed_edges, embed_nodes, energy_network, init_params, load_jax_params,
    resolve_remat, run_blocks)
from sevennet_finetuning_tpu_torch.ops import cg_tables
from sevennet_finetuning_tpu_torch.ops import fused_conv_agg as A
from sevennet_finetuning_tpu_torch.ops import fused_conv_multi as M
from sevennet_finetuning_tpu_torch.ops import scatter as S
from sevennet_finetuning_tpu_torch.train.checkpoint import (
    load_pytree, model_from_checkpoint)
from sevennet_finetuning_tpu_torch.train.metrics import init_accumulators
from sevennet_finetuning_tpu_torch.train.recipe import reewc_recipe_config
from sevennet_finetuning_tpu_torch.train.trainer import Trainer
from tests.test_torch_mace import golden_configs, narrow_batches
from tests.test_torch_mace import narrow_config as family_config
from tests.test_torch_plugins import TORCH_PLUGIN
from tests.test_torch_train import (
    CKPT, FISHER, FT, OPT_PARAMS, TYPE_MAP, _narrow_config,
    _small_structures, assert_grads_close, assert_terms_close, jax_steps,
    loss_weights, port_steps)

torch.set_num_threads(2)
ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
import chip_smoke  # noqa: E402

BUDGET = 'SEVENNET_TPU_ACT_BUDGET_GB'
FAMILIES = ('nequip', 'mace', 'gaunt', 'gaunt_gate', 'custom')
PLUGIN_MODULE = 'torch_remat_plugin'
# remat against the plain path in float64: only the order of sums differs
F64_TOL = 1e-9


@pytest.fixture(autouse=True, scope='module')
def _ckdtree_neighbor_list():
    """This file's graphs come from the cKDTree neighbor list, as
    ``test_torch_train.py``'s do; restored after."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv('SEVENN_NO_NATIVE', '1')
        mp.delenv(BUDGET, raising=False)
        yield


@pytest.fixture(scope='module')
def plugin_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp('remat_plugin')
    (d / f'{PLUGIN_MODULE}.py').write_text(textwrap.dedent(TORCH_PLUGIN))
    return str(d)


def _family_cfg(itype, plugin_dir):
    if itype != 'custom':
        return family_config(itype)
    return family_config('custom', **{
        K._CUSTOM_INTERACTION_BLOCK_CALLBACK: {
            'path': plugin_dir, 'module': PLUGIN_MODULE,
            'function': 'build_block'}})


# --- resolve_remat ----------------------------------------------------------

def _mid(spec):
    return sum(b.conv_tp.irreps_out.dim if getattr(b, 'conv_tp', None)
               is not None else 4 * b.irreps_x.dim for b in spec.blocks)


def _specs(name, plugin_dir):
    """(port spec, JAX spec) of one configuration of the grid."""
    if name == 'sevennet0':
        model, config = model_from_checkpoint(str(CKPT), device='cpu')
        return model.spec, j_build(config)
    if name == 'custom':
        from sevennet_finetuning_tpu.model.nequip import CustomBlockSpec

        cfg = _family_cfg('custom', plugin_dir)
        spec = build_model_spec(cfg)
        # JAX's side of the same blocks: its CustomBlockSpec, no conv_tp
        jspec = j_build(family_config('nequip'))
        jblocks = tuple(CustomBlockSpec(t=b.t, irreps_x=b.irreps_x,
                                        irreps_out=b.irreps_out, init=None,
                                        apply=None) for b in spec.blocks)
        return spec, dataclasses.replace(jspec, blocks=jblocks)
    _, cfgs = golden_configs()
    cfg = next(c for n, c in cfgs.items() if n.startswith(name + '_'))
    return build_model_spec(cfg), j_build(cfg)


@pytest.mark.parametrize('name', ['sevennet0', 'mace', 'gaunt',
                                  'gaunt_gate', 'custom'])
def test_resolve_remat_matches_jax(name, plugin_dir, monkeypatch):
    spec, jspec = _specs(name, plugin_dir)
    mid = _mid(spec)
    decided = set()
    for budget in (0.5, 3.0):
        monkeypatch.setenv(BUDGET, str(budget))
        t = int(budget * 2 ** 30 / (12 * mid))
        for n in (t // 2, t // 2 + 1, t - 1, t, t + 1, 2 * t):
            for remat in ('auto', ('auto', 2.0), True, False):
                got = resolve_remat(spec, n, remat, 'cpu')
                assert got == j_resolve_remat(jspec, n, remat), (
                    budget, n, remat)
                if remat == 'auto':
                    decided.add(got)
    assert decided == {True, False}


def test_resolve_remat_sevennet0_thresholds(monkeypatch):
    """SevenNet-0's message irreps sum to 10,784 a slot: under JAX's 10
    GiB budget 'auto' turns remat on above 82,973 edge slots, above
    41,486 at scale 2.0; the batch-8 train cell (38,272) stays under
    both."""
    spec, jspec = _specs('sevennet0', None)
    assert _mid(spec) == 10_784
    monkeypatch.setenv(BUDGET, '10')
    for n, remat, want in ((82_973, 'auto', False), (82_974, 'auto', True),
                           (41_486, ('auto', 2.0), False),
                           (41_487, ('auto', 2.0), True),
                           (38_272, ('auto', 2.0), False)):
        assert resolve_remat(spec, n, remat, 'cpu') is want
        assert j_resolve_remat(jspec, n, remat) is want


def test_resolve_remat_default_budget_is_device_memory():
    """Unset, the budget is 5/8 of the device's memory: the CPU's
    physical RAM."""
    assert BUDGET not in os.environ
    spec, _ = _specs('sevennet0', None)
    ram = os.sysconf('SC_PAGE_SIZE') * os.sysconf('SC_PHYS_PAGES')
    t = int(5 / 8 * ram / (12 * _mid(spec)))
    assert resolve_remat(spec, t, 'auto', 'cpu') is False
    assert resolve_remat(spec, t + 1, 'auto', 'cpu') is True


# --- run_blocks: every family, sorted and unsorted ---------------------------

def _family_setup(itype, plugin_dir, dtype):
    cfg = _family_cfg(itype, plugin_dir)
    spec = build_model_spec(cfg)
    model = load_jax_params(NequIP(spec), init_params(spec, 0)).to(dtype)
    _, tb = narrow_batches(cfg)
    data = {k: v.to(dtype) if v.is_floating_point() else v
            for k, v in batch_to_torch(tb, 'cpu').items()
            if isinstance(v, torch.Tensor)}
    return model, data


def _blocks_pass(model, data, remat, edges_sorted, seed=0):
    """Features of run_blocks on the cell (its edges permuted, numpy seed
    ``seed``, where unsorted), then fij of a seeded projection of them
    with create_graph and the parameter gradient of a loss on fij."""
    spec, p = model.spec, model.params
    edge_vec = compute_edge_vec(data).detach().requires_grad_(True)
    _, emb, attr = embed_edges(spec, p, edge_vec, data[K.EDGE_MASK])
    onehot, x = embed_nodes(spec, p, data[K.ATOM_TYPE], edge_vec.dtype)
    idx = data[K.EDGE_IDX]
    E = idx.shape[1]
    if edges_sorted:
        order = torch.arange(E)
        kw = dict(src_perm=data[K.EDGE_SRC_PERM],
                  src_inv=data[nequip.EDGE_SRC_INV_PERM])
    else:
        order = torch.from_numpy(np.random.default_rng(seed).permutation(E))
        kw = {}
    y = run_blocks(spec, p, x, onehot, emb[order], attr[order],
                   idx[1][order], idx[0][order], x.shape[0], remat=remat,
                   edges_sorted=edges_sorted, **kw)
    proj = torch.from_numpy(np.random.default_rng(1).standard_normal(
        tuple(y.shape))).to(y.dtype)
    fij, = torch.autograd.grad((y * proj).sum(), edge_vec,
                               create_graph=True)
    w = torch.from_numpy(np.random.default_rng(2).standard_normal(
        tuple(fij.shape))).to(y.dtype)
    leaves = [v for g in p.values() for v in g.values()]
    grads = torch.autograd.grad((fij * w).sum() + (y * proj).sum(), leaves,
                                allow_unused=True)
    return y.detach(), fij.detach(), [
        torch.zeros_like(v) if g is None else g
        for g, v in zip(grads, leaves)]


@pytest.mark.parametrize('edges_sorted', [True, False],
                         ids=['sorted', 'unsorted'])
@pytest.mark.parametrize('itype', FAMILIES)
def test_run_blocks_remat_equals_plain(itype, edges_sorted, plugin_dir):
    model, data = _family_setup(itype, plugin_dir, torch.float32)
    with torch.no_grad():
        spec, p = model.spec, model.params
        edge_vec = compute_edge_vec(data)
        _, emb, attr = embed_edges(spec, p, edge_vec, data[K.EDGE_MASK])
    # the features bit for bit (the recompute runs the same kernels)
    plain = _blocks_pass(model, data, False, edges_sorted)
    remat = _blocks_pass(model, data, True, edges_sorted)
    assert torch.isfinite(plain[0]).all()
    assert torch.equal(remat[0], plain[0])
    # the gradients in float64, where only the order of sums differs
    model, data = _family_setup(itype, plugin_dir, torch.float64)
    plain = _blocks_pass(model, data, False, edges_sorted)
    remat = _blocks_pass(model, data, True, edges_sorted)
    assert torch.equal(remat[0], plain[0])
    for got, want in [(remat[1], plain[1])] + list(zip(remat[2], plain[2])):
        scale = float(want.abs().max())
        assert float((got - want).abs().max()) <= F64_TOL * scale


# --- train step, Fisher ------------------------------------------------------

@pytest.fixture(scope='module')
def narrow_remat():
    """Two steps (a train batch, then a memory batch) of the narrow
    model of ``test_torch_train.py`` with remat on, by the JAX Trainer
    and the port's."""
    cfg = {**_narrow_config(), K.REMAT: True}
    j_spec = j_build(cfg)
    params = jax.tree_util.tree_map(np.asarray, j_init(j_spec, seed=5))
    rng = np.random.default_rng(6)
    fisher = jax.tree_util.tree_map(
        lambda a: np.abs(rng.standard_normal(a.shape)).astype(np.float32),
        params)
    anchor = jax.tree_util.tree_map(
        lambda a: (a + 0.01 * rng.standard_normal(a.shape)).astype(
            np.float32), params)
    j_train, j_mem = _small_structures(j_read)
    t_train, t_mem = _small_structures(read_extxyz)
    jb = [next(iter(JLoader(JGraphDataset.from_structures(s, 5.0, TYPE_MAP),
                            2))) for s in (j_train, j_mem)]
    tb = [next(iter(Loader(GraphDataset.from_structures(s, 5.0, TYPE_MAP),
                           2))) for s in (t_train, t_mem)]
    jt = JTrainer(j_spec, jax.tree_util.tree_map(jnp.asarray, params), cfg,
                  fisher=fisher, opt_params=anchor)
    assert jt.remat is True
    j_rows, j_grads, _ = jax_steps(jt, jb, ['train', 'mem'])

    model = load_jax_params(NequIP(build_model_spec(cfg)), params)
    tt = Trainer(model, cfg, fisher=fisher, opt_params=anchor, device='cpu')
    t_rows, t_grads = port_steps(tt, tb)
    return dict(j_rows=j_rows, j_grads=j_grads, t_rows=t_rows,
                t_grads=t_grads, weights=loss_weights(tt), cfg=cfg,
                params=params, fisher=fisher, anchor=anchor, tb=tb)


def test_remat_train_step_matches_jax(narrow_remat):
    assert_terms_close(narrow_remat['t_rows'], narrow_remat['j_rows'],
                       narrow_remat['weights'])
    assert_grads_close(narrow_remat['t_grads'], narrow_remat['j_grads'],
                       1e-4)


@contextlib.contextmanager
def _default_dtype(dtype):
    old = torch.get_default_dtype()
    torch.set_default_dtype(dtype)
    try:
        yield
    finally:
        torch.set_default_dtype(old)


def _f64_steps(d, remat):
    """The narrow fixture's two steps in float64 with ``remat``: per-step
    loss terms and the first step's gradients."""
    with _default_dtype(torch.float64):
        model = load_jax_params(NequIP(build_model_spec(d['cfg'])),
                                d['params']).to(torch.float64)
        trainer = Trainer(model, {**d['cfg'], K.REMAT: remat},
                          fisher=d['fisher'], opt_params=d['anchor'],
                          device='cpu')
        acc = init_accumulators(trainer.metric_specs, trainer.device)
        rows, grads = [], None
        for b in d['tb']:
            batch = {k: v.to(torch.float64) if isinstance(v, torch.Tensor)
                     and v.is_floating_point() else v
                     for k, v in trainer.place_batch(b).items()}
            acc, terms = trainer.train_step(batch, acc)
            rows.append({k: float(v) for k, v in terms.items()})
            if grads is None:
                grads = {(g, n): p.grad.clone()
                         for g, names in trainer.params.items()
                         for n, p in names.items()}
    return rows, grads


def test_remat_train_step_equals_plain_in_float64(narrow_remat):
    rows, grads = _f64_steps(narrow_remat, True)
    p_rows, p_grads = _f64_steps(narrow_remat, False)
    for got, want in zip(rows, p_rows):
        for k, v in want.items():
            assert abs(got[k] - v) <= F64_TOL * abs(want['Total']), k
    for key, want in p_grads.items():
        scale = float(want.abs().max())
        assert float((grads[key] - want).abs().max()) <= F64_TOL * scale, \
            key


def test_remat_fisher_equals_plain(narrow_remat):
    cfg = {**narrow_remat['cfg'], K.CONTINUE: {}}
    train, _ = _small_structures(read_extxyz)
    loader = Loader(GraphDataset.from_structures(train[:3], 5.0, TYPE_MAP),
                    1)
    out = {}
    for remat in (True, False):
        model = load_jax_params(NequIP(build_model_spec(cfg)),
                                narrow_remat['params'])
        trainer = Trainer(model, {**cfg, K.REMAT: remat}, device='cpu')
        out[remat] = trainer.compute_fisher_matrix(loader)
    (f, o, n), (pf, po, pn) = out[True], out[False]
    assert n == pn == 3
    assert_grads_close(o, po, 0.0)
    # squared gradients in float32: twice their relative rounding
    assert_grads_close(f, pf, 1e-5)


# --- memory ------------------------------------------------------------------

def saved_bytes(model, batch, remat):
    """Bytes of the distinct storages that the autograd graph still holds
    for backward after ``apply_model_train``'s force pass: every tensor
    saved under ``saved_tensors_hooks`` that is alive then.  The hook
    keeps a detached alias: the tensor itself, where it is an output of
    the node that saves it, would tie the node to itself and outlive the
    graph."""
    refs = []

    def pack(t):
        alias = t.detach()
        refs.append(weakref.ref(alias))
        return alias

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        out = apply_model_train(model, batch, remat=remat)
    live = {}
    for r in refs:
        t = r()
        if t is not None:
            st = t.untyped_storage()
            live[st.data_ptr()] = st.nbytes()
    del out
    return sum(live.values())


def test_remat_keeps_under_half_the_saved_bytes():
    cfg = {**_narrow_config(), K.NUM_CONVOLUTION: 5,
           K.NODE_FEATURE_MULTIPLICITY: 8, K.CONTINUE: {}}
    spec = build_model_spec(cfg)
    model = load_jax_params(NequIP(spec), init_params(spec, 5))
    train, _ = _small_structures(read_extxyz)
    batch = batch_to_torch(next(iter(Loader(GraphDataset.from_structures(
        train[:2], 5.0, TYPE_MAP), 2))), 'cpu')
    plain = saved_bytes(model, batch, False)
    remat = saved_bytes(model, batch, True)
    assert plain > 0 and remat < 0.5 * plain, (plain, remat)


# --- refusals, 'auto' ---------------------------------------------------------

def test_remat_refuses_capture_and_halo(plugin_dir):
    model, data = _family_setup('nequip', plugin_dir, torch.float32)
    spec, p = model.spec, model.params
    edge_vec = compute_edge_vec(data)
    _, emb, attr = embed_edges(spec, p, edge_vec, data[K.EDGE_MASK])
    onehot, x = embed_nodes(spec, p, data[K.ATOM_TYPE], edge_vec.dtype)
    idx = data[K.EDGE_IDX]
    args = (spec, p, x, onehot, emb, attr, idx[1], idx[0], x.shape[0])
    with pytest.raises(ValueError, match='capture'):
        run_blocks(*args, cap=lambda name, val: None, remat=True)
    with pytest.raises(ValueError, match='capture'):
        energy_network(model, data, edge_vec, intermediates={}, remat=True)
    with pytest.raises(ValueError, match='swaps'):
        run_blocks(*args, exchange_fn=lambda v: v, remat=True)
    with pytest.raises(ValueError, match='swaps'):
        run_blocks(*args, halo_split={}, remat=True)
    # a differentiable tensor the block would close over
    with pytest.raises(ValueError, match='closes over'):
        run_blocks(*args[:3], onehot.requires_grad_(True), *args[4:],
                   remat=True)


@contextlib.contextmanager
def _count_remat_blocks():
    calls = []
    apply = nequip._RematBlock.apply

    def counted(*a):
        calls.append(1)
        return apply(*a)

    nequip._RematBlock.apply = counted
    try:
        yield calls
    finally:
        nequip._RematBlock.apply = apply


def test_trainer_resolves_auto_per_batch(monkeypatch):
    """The Trainer's default 'auto' rematerializes a batch over the
    budget and no other; the eval step never does."""
    cfg = {**_narrow_config(), K.CONTINUE: {}}
    cfg.pop(K.REMAT, None)
    spec = build_model_spec(cfg)
    train, _ = _small_structures(read_extxyz)
    loader = Loader(GraphDataset.from_structures(train[:2], 5.0, TYPE_MAP),
                    2)
    n_edge = next(iter(loader))[K.EDGE_IDX].shape[1]
    est_gib = 12 * _mid(spec) * n_edge / 2 ** 30
    counts = {}
    for budget in (0.5 * est_gib, 2.0 * est_gib):
        monkeypatch.setenv(BUDGET, repr(budget))
        trainer = Trainer(load_jax_params(NequIP(spec), init_params(spec, 5)),
                          cfg, device='cpu')
        assert trainer.remat == 'auto'
        with _count_remat_blocks() as calls:
            trainer.run_one_epoch(loader, is_train=True)
            n_train = len(calls)
            trainer.run_one_epoch(loader, is_train=False)
        counts[budget < est_gib] = (n_train, len(calls))
    n_blocks = len(spec.blocks)
    assert counts == {True: (n_blocks, n_blocks), False: (0, 0)}


# --- the card's census, counted on the plain versions -------------------------

@contextlib.contextmanager
def plain_census():
    """Counts the plain versions' calls as the CUDA wrappers count their
    launches (``cg_gmulti`` a launch per pass), with the (E, D, n_rows)
    of each segment sum."""
    counts, shapes = Counter(), Counter()
    orig = (S.segment_sum_plain, A.agg_plain, M.multi_plain, M.gagg_plain,
            M.gmulti_plain)

    def seg(msg, dst, n_rows):
        counts['segment_sum'] += 1
        shapes[(msg.shape[0], msg.shape[1], n_rows)] += 1
        return orig[0](msg, dst, n_rows)

    def counted(name, fn):
        def call(*args):
            counts[name] += 1
            return fn(*args)
        return call

    def gmulti(ybar, pool, dst, jobs, groups, *rest):
        gidx = {g: i for i, g in enumerate(groups)}
        norm = tuple((m, bi, ci, gidx[g]) for (m, bi, ci, g) in jobs)
        counts['cg_gmulti'] += len(cg_tables.gmulti_passes(norm,
                                                           len(groups)))
        return orig[4](ybar, pool, dst, jobs, groups, *rest)

    (S.segment_sum_plain, A.agg_plain, M.multi_plain, M.gagg_plain,
     M.gmulti_plain) = (seg, counted('cg_agg', orig[1]),
                        counted('cg_multi', orig[2]),
                        counted('cg_gagg', orig[3]), gmulti)
    try:
        yield counts, shapes
    finally:
        (S.segment_sum_plain, A.agg_plain, M.multi_plain, M.gagg_plain,
         M.gmulti_plain) = orig


def test_sevennet0_remat_census_is_chip_smokes():
    """One reEWC train step of SevenNet-0 on the 12-atom structure, with
    and without remat: the plain versions' census is the card's
    (``TRAIN_CENSUS``, ``REMAT_TRAIN_CENSUS``) at the segment-sum shapes
    ``chip_smoke.py`` asserts, and the remat step's loss is the plain
    step's."""
    s12 = [s for s in read_extxyz(str(FT)) if len(s) == 12]
    totals = {}
    for remat, census, shapes_of in (
            (False, chip_smoke.TRAIN_CENSUS, chip_smoke.train_segment_shapes),
            (True, chip_smoke.REMAT_TRAIN_CENSUS,
             chip_smoke.remat_segment_shapes)):
        model, config = model_from_checkpoint(str(CKPT), device='cpu')
        cfg = {**reewc_recipe_config(config, FISHER, OPT_PARAMS),
               K.REMAT: remat}
        trainer = Trainer(model, cfg, fisher=load_pytree(str(FISHER)),
                          opt_params=load_pytree(str(OPT_PARAMS)),
                          device='cpu')
        batch = trainer.place_batch(next(iter(Loader(
            GraphDataset.from_structures(s12, model.spec.cutoff,
                                         dict(model.spec.type_map)), 1))))
        acc = init_accumulators(trainer.metric_specs, trainer.device)
        with plain_census() as (counts, shapes):
            _, terms = trainer.train_step(batch, acc)
        assert {k: v for k, v in census.items() if v} == dict(counts)
        assert dict(shapes) == shapes_of(batch[K.EDGE_IDX].shape[1],
                                         batch[K.POS].shape[0],
                                         batch[K.CELL].shape[0])
        totals[remat] = float(terms['Total'])
    assert totals[True] == totals[False]
