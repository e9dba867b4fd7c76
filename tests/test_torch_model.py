"""The port's model against the JAX package's on ft.extxyz.

A narrow NequIP (channel 16, lmax 2, 3 convolutions, linear
self-connection; the parity variant also with the FCTP self-connection)
is initialised by JAX ``init_params`` and carried across
with ``load_jax_params``; energy, forces, stress and every captured
intermediate (``cap``) are compared.  Two variants: SevenNet-0-like
(SE(3), XPLOR cutoff, linear readout) and E(3) parity with the polynomial
cutoff and the FCN readout.  The graph and batch builders are
held bit-for-bit (same neighbor-list path on both sides).

Tolerances: intermediates, energy, forces and stress 1e-5 relative to
the largest magnitude of the JAX value (float32 sums in another order).
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sevennet_finetuning_tpu import keys as JK
from sevennet_finetuning_tpu.data.readers import read_extxyz as j_read
from sevennet_finetuning_tpu.model import graph as j_graph
from sevennet_finetuning_tpu.model.build import build_model_spec as j_build
from sevennet_finetuning_tpu.model.nequip import (
    apply_model as j_apply_model,
    compute_edge_vec as j_edge_vec,
    energy_network as j_energy_network,
    init_params,
)
from sevennet_finetuning_tpu_torch import keys as K
from sevennet_finetuning_tpu_torch.data.readers import read_extxyz
from sevennet_finetuning_tpu_torch.model import graph
from sevennet_finetuning_tpu_torch.model.build import build_model_spec
from sevennet_finetuning_tpu_torch.model.nequip import (
    NequIP,
    apply_model,
    batch_to_torch,
    compute_edge_vec,
    energy_network,
    load_jax_params,
)

torch.set_num_threads(2)
RTOL = 1e-5
ROOT = Path(__file__).resolve().parent.parent
FT = ROOT / 'experiments/ft_reewc/data/ft.extxyz'
TYPE_MAP = {72: 0, 8: 1}


def _config(variant):
    cfg = {
        K.NUM_SPECIES: 2,
        K.TYPE_MAP: dict(TYPE_MAP),
        K.NODE_FEATURE_MULTIPLICITY: 16,
        K.LMAX: 2,
        K.NUM_CONVOLUTION: 3,
        K.CUTOFF: 5.0,
        K.SELF_CONNECTION_TYPE: 'linear',
        K.CONV_DENOMINATOR: 30.0,
        K.SHIFT: [-9.0, -4.5],
        K.SCALE: [1.7, 1.3],
    }
    if variant == 'sevennet0_like':
        cfg[K.IS_PARITY] = False
        cfg[K.CUTOFF_FUNCTION] = {K.CUTOFF_FUNCTION_NAME: 'XPLOR',
                                  K.CUTOFF_ON: 4.5}
    else:
        cfg[K.IS_PARITY] = True
        cfg[K.READOUT_AS_FCN] = True
        cfg[K.READOUT_FCN_HIDDEN_NEURONS] = [12, 12]
    return cfg


def _rel_close(got, want, rtol=RTOL, name=''):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= rtol * scale, (name, err, scale)


@pytest.fixture(scope='module')
def batches():
    """The same five structures collated by both packages, both on the
    scipy neighbor list (the two builders order a node's edges
    differently, so the packages must share one)."""
    import os

    old = os.environ.get('SEVENN_NO_NATIVE')
    os.environ['SEVENN_NO_NATIVE'] = '1'
    try:
        jg = [j_graph.structure_to_graph(s, 5.0, TYPE_MAP)
              for s in j_read(str(FT))]
        tg = [graph.structure_to_graph(s, 5.0, TYPE_MAP)
              for s in read_extxyz(str(FT))]
    finally:
        if old is None:
            del os.environ['SEVENN_NO_NATIVE']
        else:
            os.environ['SEVENN_NO_NATIVE'] = old
    n_node = graph.bucket_capacity(sum(len(g[K.POS]) for g in tg))
    n_edge = graph.bucket_capacity(sum(g[K.EDGE_IDX].shape[1] for g in tg))
    jb = j_graph.collate(jg, n_node=n_node, n_edge=n_edge, n_graph=6)
    tb = graph.collate(tg, n_node=n_node, n_edge=n_edge, n_graph=6)
    return jb, tb


def test_collate_is_bit_identical(batches):
    jb, tb = batches
    assert set(jb) == set(tb)
    for k in jb:
        if k in (K.INFO, K.USER_LABEL):
            continue
        assert jb[k].dtype == tb[k].dtype, k
        np.testing.assert_array_equal(jb[k], tb[k], err_msg=k)
    idx = tb[K.EDGE_IDX]
    assert np.all(np.diff(idx[0]) >= 0)                  # dst-sorted
    n_node = tb[K.POS].shape[0]
    assert np.all(np.diff(idx[1][tb[K.EDGE_SRC_PERM]]) >= 0)
    pad = tb[K.EDGE_MASK] == 0
    assert np.all(idx[:, pad] == n_node)                 # the sentinel


@pytest.fixture(scope='module', params=['sevennet0_like', 'parity'])
def models(request):
    cfg = _config(request.param)
    j_spec = j_build(cfg)
    params = jax.tree_util.tree_map(np.asarray, init_params(j_spec, seed=3))
    model = load_jax_params(NequIP(build_model_spec(cfg)), params)
    model.requires_grad_(False)
    return j_spec, params, model


def test_intermediates_match(models, batches):
    j_spec, params, model = models
    jb, tb = batches
    jdata = {k: jnp.asarray(v) for k, v in jb.items()
             if k not in (K.INFO, K.USER_LABEL)}
    tdata = batch_to_torch(tb, 'cpu')
    want_caps = {}
    j_params = jax.tree_util.tree_map(jnp.asarray, params)
    want = j_energy_network(j_spec, j_params, jdata, j_edge_vec(jdata),
                            intermediates=want_caps)
    got_caps = {}
    got = energy_network(model, tdata, compute_edge_vec(tdata),
                         intermediates=got_caps)
    assert set(got_caps) == set(want_caps)
    assert len(got_caps) == 1 + 5 * 3
    # the edge inputs of the convolutions first, so that a disagreement
    # names the earliest stage it starts at
    for key in (JK.EDGE_LENGTH, JK.EDGE_ATTR, JK.EDGE_EMBEDDING):
        _rel_close(got[key], want[key], name=key)
    for name, v in want_caps.items():
        _rel_close(got_caps[name], v, name=name)
    for key in (JK.PRED_TOTAL_ENERGY, JK.ATOMIC_ENERGY):
        _rel_close(got[key], want[key], name=key)


def test_energy_forces_stress_match(models, batches):
    j_spec, params, model = models
    jb, tb = batches
    jdata = {k: jnp.asarray(v) for k, v in jb.items()
             if k not in (K.INFO, K.USER_LABEL)}
    want = jax.jit(lambda p, b: j_apply_model(j_spec, p, b))(
        jax.tree_util.tree_map(jnp.asarray, params), jdata)
    got = apply_model(model, batch_to_torch(tb, 'cpu'))
    n_real = int(tb[K.NODE_MASK].sum())
    _rel_close(got[K.PRED_TOTAL_ENERGY][:5], want[JK.PRED_TOTAL_ENERGY][:5],
               name='energy')
    _rel_close(got[K.PRED_FORCE][:n_real], want[JK.PRED_FORCE][:n_real],
               name='forces')
    _rel_close(got[K.PRED_STRESS][:5], want[JK.PRED_STRESS][:5],
               name='stress')
    assert torch.isfinite(got[K.PRED_FORCE]).all()
    # padded graph: no atoms, zero energy
    assert float(got[K.PRED_TOTAL_ENERGY][5]) == 0.0


def test_load_jax_params_checks_names_and_shapes(models):
    _, params, model = models
    bad = {g: dict(v) for g, v in params.items()}
    bad['0_convolution'] = dict(bad['0_convolution'])
    del bad['0_convolution']['denominator']
    with pytest.raises(KeyError):
        load_jax_params(NequIP(model.spec), bad)
    bad = {g: dict(v) for g, v in params.items()}
    bad['onehot_to_feature_x'] = {'w0': np.zeros((3, 3), np.float32)}
    with pytest.raises(ValueError):
        load_jax_params(NequIP(model.spec), bad)
    n_port = sum(p.numel() for p in model.parameters())
    n_jax = sum(np.asarray(v).size for g in params.values()
                for v in g.values())
    assert n_port == n_jax


def test_checkpoint_model_matches_architecture():
    from sevennet_finetuning_tpu_torch.train.checkpoint import (
        model_from_checkpoint)

    model, config = model_from_checkpoint(
        str(ROOT / 'experiments/ft_reewc_900/conv_out/checkpoint_best.pth'),
        device='cpu')
    assert sum(p.numel() for p in model.parameters()) == 842_623
    assert len(model.spec.blocks) == 5
    assert config[K.INTERACTION_TYPE] == 'nequip'


def test_mace_spec_and_fctp_self_connection_match_jax(batches):
    """The mace interaction builds the JAX package's blocks (kinds and
    parameter shapes); the FCTP ('nequip') self-connection gives JAX's
    energies, forces and stress (E(3) parity variant, 1e-5 relative)."""
    cfg = _config('parity')
    mace = {**cfg, K.INTERACTION_TYPE: 'mace', K.NODE_FEATURE_MULTIPLICITY: 4}
    spec, j_spec = build_model_spec(mace), j_build(mace)
    assert [b.block_type for b in spec.blocks] == [
        b.block_type for b in j_spec.blocks] == ['mace'] * 3
    assert {g: {n: v.shape for n, v in d.items()} for g, d in
            init_params(j_spec, seed=0).items()} == {
        g: {n: tuple(p.shape) for n, p in d.items()}
        for g, d in NequIP(spec).params.items()}
    cfg = {**cfg, K.SELF_CONNECTION_TYPE: 'nequip'}
    j_spec = j_build(cfg)
    params = jax.tree_util.tree_map(np.asarray, init_params(j_spec, seed=3))
    model = load_jax_params(NequIP(build_model_spec(cfg)), params)
    model.requires_grad_(False)
    test_energy_forces_stress_match((j_spec, params, model), batches)
