""".sevenn_data datasets of the port against the JAX package, on the CPU.

- a reference artifact (a ``torch.save`` of ``AtomGraphDataset`` with
  ``sevenn.*`` / ``torch_geometric.*`` classes, fabricated as
  ``tests/test_data_layer.py`` does): both importers give the same
  structures and graphs;
- each package reads the other's own artifact: graphs bit-equal, the
  stored structures equal (a JAX artifact pickles the JAX package's
  ``Structure``, which the port maps to its own copy);
- a cutoff or type map other than the stored one rebuilds from the
  stored structures; without them both packages raise the same way;
- ``main graph_build`` writes what JAX's ``load_sevenn_data`` reads, the
  graphs of JAX's ``cmd_graph_build``;
- ``load_dataset`` / ``load_structures`` take .sevenn_data paths, and a
  narrow ``pipeline.train`` from a .sevenn_data equals the same run from
  the extxyz file, whether the artifact's graphs are reused or rebuilt
  from its structures;
- the ``save_dataset_path`` / ``save_by_label`` / ``save_by_train_valid``
  keys write artifacts that JAX's ``load_sevenn_data`` reads, with the
  graphs of JAX's ``GraphDataset.from_structures``.

Both packages build graphs with the cKDTree neighbor list here.
"""

import argparse
import csv
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

ROOT = Path(__file__).resolve().parent.parent
FT = ROOT / 'experiments/ft_reewc/data/ft.extxyz'
REPLAY = ROOT / 'experiments/ft_reewc/data/replay.extxyz'
TYPE_MAP = {8: 0, 72: 1}

torch.set_num_threads(2)


@pytest.fixture(autouse=True, scope='module')
def _ckdtree_neighbor_list():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv('SEVENN_NO_NATIVE', '1')
        yield


def _make_fake_reference_sevenn_data(path):
    """Fabricate a torch.save'd AtomGraphDataset the way the reference
    writes it (reference: sevenn/train/dataset.py:453-465): classes under
    sevenn.* / torch_geometric.* module paths, PyG-style nesting
    Data.__dict__['_store'].__dict__['_mapping'] (a copy of the helper of
    tests/test_data_layer.py)."""
    import sys
    import types

    mods = {}
    for name in ('sevenn', 'sevenn.train', 'sevenn.train.dataset',
                 'sevenn.atom_graph_data', 'torch_geometric',
                 'torch_geometric.data', 'torch_geometric.data.storage'):
        mods[name] = sys.modules.get(name) or types.ModuleType(name)

    class GlobalStorage:
        pass

    class AtomGraphData:
        pass

    class AtomGraphDataset:
        pass

    GlobalStorage.__module__ = 'torch_geometric.data.storage'
    GlobalStorage.__qualname__ = 'GlobalStorage'
    AtomGraphData.__module__ = 'sevenn.atom_graph_data'
    AtomGraphData.__qualname__ = 'AtomGraphData'
    AtomGraphDataset.__module__ = 'sevenn.train.dataset'
    AtomGraphDataset.__qualname__ = 'AtomGraphDataset'
    mods['torch_geometric.data.storage'].GlobalStorage = GlobalStorage
    mods['sevenn.atom_graph_data'].AtomGraphData = AtomGraphData
    mods['sevenn.train.dataset'].AtomGraphDataset = AtomGraphDataset

    rng = np.random.default_rng(3)

    def one_graph(e0):
        fields = {
            'pos': torch.tensor(rng.uniform(0, 5, (3, 3)),
                                dtype=torch.float64),
            'cell_lattice_vectors': torch.eye(3, dtype=torch.float64) * 5,
            'atomic_numbers': torch.tensor([72, 8, 8]),
            'x': torch.tensor([72, 8, 8]),
            'total_energy': torch.tensor(e0, dtype=torch.float64),
            'force_of_atoms': torch.tensor(rng.normal(size=(3, 3))),
            'stress': torch.tensor(rng.normal(size=(1, 6)) * 0.01),
            'user_label': 'label_x',
            'data_info': {},
        }
        store = GlobalStorage()
        store.__dict__['_mapping'] = fields
        g = AtomGraphData()
        g.__dict__['_store'] = store
        return g

    ds = AtomGraphDataset()
    ds.__dict__.update({
        'dataset': {'label_x': [one_graph(-20.0), one_graph(-21.0)]},
        'cutoff': 4.0,
        'meta': {},
        'user_labels': ['label_x'],
        'x_is_one_hot_idx': False,
    })

    old = {k: sys.modules.get(k) for k in mods}
    sys.modules.update(mods)
    try:
        torch.save(ds, path)
    finally:
        for k, v in old.items():
            if v is None:
                sys.modules.pop(k, None)
            else:
                sys.modules[k] = v


def _same_structures(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.species == y.species and tuple(x.pbc) == tuple(y.pbc)
        assert x.info == y.info and x.energy == y.energy
        for key in ('pos', 'cell', 'forces', 'stress'):
            u, v = getattr(x, key), getattr(y, key)
            assert (u is None and v is None) or np.array_equal(u, v), key


def _same_graphs(a, b):
    assert len(a) == len(b)
    for g, h in zip(a, b):
        assert set(g) == set(h)
        for k in g:
            if isinstance(g[k], np.ndarray):
                assert g[k].dtype == h[k].dtype and np.array_equal(
                    g[k], h[k], equal_nan=True), k
            else:
                assert g[k] == h[k], k


def test_reference_artifact_matches_jax(tmp_path):
    from sevennet_finetuning_tpu.compat import sevenn_data_import as J
    from sevennet_finetuning_tpu.data import dataset as jds
    from sevennet_finetuning_tpu_torch.compat import sevenn_data_import as P
    from sevennet_finetuning_tpu_torch.data import dataset as ds

    path = str(tmp_path / 'ref.sevenn_data')
    _make_fake_reference_sevenn_data(path)
    assert P.is_reference_sevenn_data(path) and J.is_reference_sevenn_data(
        path)
    got = P.reference_sevenn_data_structures(path)
    _same_structures(got, J.reference_sevenn_data_structures(path))
    assert got[0].species == ['Hf', 'O', 'O']
    assert got[0].info['label'] == 'label_x'
    assert P.reference_sevenn_data_cutoff(path) == 4.0 == \
        J.reference_sevenn_data_cutoff(path)
    _same_structures(ds.sevenn_data_structures(path),
                     jds.sevenn_data_structures(path))
    for cutoff, tm in ((4.0, TYPE_MAP), (None, None)):
        _same_graphs(ds.load_sevenn_data(path, cutoff, tm).graphs,
                     jds.load_sevenn_data(path, cutoff, tm).graphs)


@pytest.fixture(scope='module')
def artifacts(tmp_path_factory):
    """The replay.extxyz graphs written by each package, with their
    structures, at the run's type map."""
    from sevennet_finetuning_tpu.data import dataset as jds
    from sevennet_finetuning_tpu.data.readers import read_extxyz as j_read
    from sevennet_finetuning_tpu_torch.data import dataset as ds
    from sevennet_finetuning_tpu_torch.data.readers import read_extxyz

    tmp = tmp_path_factory.mktemp('sevenn_data')
    structs, j_structs = read_extxyz(str(REPLAY)), j_read(str(REPLAY))
    port = ds.GraphDataset.from_structures(structs, 4.0, TYPE_MAP)
    jax_ds = jds.GraphDataset.from_structures(j_structs, 4.0, TYPE_MAP)
    _same_graphs(port.graphs, jax_ds.graphs)
    ds.save_sevenn_data(str(tmp / 'port.sevenn_data'), port, 4.0, TYPE_MAP,
                        structures=structs)
    jds.save_sevenn_data(str(tmp / 'jax.sevenn_data'), jax_ds, 4.0,
                         TYPE_MAP, structures=j_structs)
    return tmp, structs, port


@pytest.mark.parametrize('writer', ['port', 'jax'])
def test_artifacts_read_both_ways(artifacts, writer):
    from sevennet_finetuning_tpu.compat.sevenn_data_import import (
        is_reference_sevenn_data as j_is_ref)
    from sevennet_finetuning_tpu.data import dataset as jds
    from sevennet_finetuning_tpu_torch.compat.sevenn_data_import import (
        is_reference_sevenn_data)
    from sevennet_finetuning_tpu_torch.data import dataset as ds
    from sevennet_finetuning_tpu_torch.data.vasp import Structure

    tmp, structs, port = artifacts
    path = str(tmp / f'{writer}.sevenn_data')
    assert not is_reference_sevenn_data(path) and not j_is_ref(path)
    for load in (ds.load_sevenn_data, jds.load_sevenn_data):
        _same_graphs(load(path, 4.0, TYPE_MAP).graphs, port.graphs)
        _same_graphs(load(path).graphs, port.graphs)
    stored = ds.sevenn_data_structures(path)
    assert all(type(s) is Structure for s in stored)
    _same_structures(stored, structs)
    _same_structures(jds.sevenn_data_structures(path), structs)


def test_rebuild_and_missing_structures_like_jax(artifacts, tmp_path):
    from sevennet_finetuning_tpu.data import dataset as jds
    from sevennet_finetuning_tpu_torch.data import dataset as ds

    tmp, _, port = artifacts
    path = str(tmp / 'jax.sevenn_data')
    for cutoff, tm in ((3.5, TYPE_MAP), (4.0, {72: 0, 8: 1})):
        got = ds.load_sevenn_data(path, cutoff, tm)
        _same_graphs(got.graphs, jds.load_sevenn_data(path, cutoff,
                                                      tm).graphs)
        assert not all(np.array_equal(g['atom_type'], h['atom_type'])
                       and g['edge_index'].shape == h['edge_index'].shape
                       for g, h in zip(got.graphs, port.graphs))
    bare = str(tmp_path / 'bare.sevenn_data')
    ds.save_sevenn_data(bare, port, 4.0, TYPE_MAP)
    assert ds.sevenn_data_structures(bare) is None
    msgs = []
    for load in (ds.load_sevenn_data, jds.load_sevenn_data):
        with pytest.raises(ValueError, match='no structures') as info:
            load(bare, 3.5, TYPE_MAP)
        msgs.append(str(info.value))
    assert msgs[0] == msgs[1]


def test_unpickler_resolves_only_what_artifacts_need(tmp_path):
    """A pickle that names anything but numpy's array globals and a
    Structure class is refused before it runs."""
    import pickle

    from sevennet_finetuning_tpu_torch.data.dataset import load_sevenn_data

    path = tmp_path / 'evil.sevenn_data'
    with open(path, 'wb') as f:
        pickle.dump({'version': 2, 'cutoff': 4.0, 'type_map': {},
                     'graphs': [], 'structures': None,
                     'payload': argparse.Namespace()}, f)
    with pytest.raises(pickle.UnpicklingError, match='argparse'):
        load_sevenn_data(str(path))


def test_graph_build_is_read_by_jax(tmp_path):
    from sevennet_finetuning_tpu.data import dataset as jds
    from sevennet_finetuning_tpu.main import cmd_graph_build
    from sevennet_finetuning_tpu_torch.main import main as cli

    out = tmp_path / 'port.sevenn_data'
    cli(['graph_build', str(REPLAY), '4.0', '-o', str(out)])
    cmd_graph_build(argparse.Namespace(source=str(REPLAY), cutoff=4.0,
                                       output=str(tmp_path / 'jax.sevenn_data'),
                                       num_cores=1))
    got = jds.load_sevenn_data(str(out))
    _same_graphs(got.graphs,
                 jds.load_sevenn_data(str(tmp_path / 'jax.sevenn_data')).graphs)
    assert len(got) == 5
    _same_structures(jds.sevenn_data_structures(str(out)),
                     jds.sevenn_data_structures(str(tmp_path /
                                                    'jax.sevenn_data')))


def test_load_dataset_and_structures_take_sevenn_data(artifacts):
    from sevennet_finetuning_tpu_torch import keys as K
    from sevennet_finetuning_tpu_torch import pipeline

    tmp, structs, port = artifacts
    cfg = {K.LOAD_DATASET: [str(tmp / 'jax.sevenn_data'), str(FT)],
           K.DATA_FORMAT: 'extxyz'}
    got = pipeline.load_dataset(cfg, K.LOAD_DATASET, 4.0, TYPE_MAP)
    assert len(got) == len(port) + 5
    _same_graphs(got.graphs[:len(port)], port.graphs)
    loaded = pipeline.load_structures(cfg)
    assert len(loaded) == len(structs) + 5
    _same_structures(loaded[:len(structs)], structs)


def _narrow_yaml(path, data, **train):
    cfg = {'model': {'chemical_species': 'auto', 'cutoff': 4.0,
                     'channel': 4, 'lmax': 1, 'num_convolution_layer': 2,
                     'is_parity': False, 'self_connection_type': 'linear'},
           'train': {'random_seed': 1, 'epoch': 2, 'per_epoch': 1,
                     'optim_param': {'lr': 0.005}, **train},
           'data': {'batch_size': 2, 'data_divide_ratio': 0.2,
                    'load_dataset_path': [str(data)]}}
    Path(path).write_text(yaml.safe_dump(cfg))
    return str(path)


def _csv(path):
    with open(path) as f:
        return list(csv.DictReader(f))


@pytest.mark.parametrize('built', ['run_type_map', 'file_species'])
def test_train_from_sevenn_data_equals_extxyz(tmp_path, built):
    """The same run from the extxyz file and from its .sevenn_data: the
    same log.csv, whether the stored graphs are reused (built with the
    run's type map and cutoff) or rebuilt from the stored structures
    (``graph_build`` at another cutoff)."""
    from sevennet_finetuning_tpu_torch.data import dataset as ds
    from sevennet_finetuning_tpu_torch.data.elements import (
        type_map_from_species)
    from sevennet_finetuning_tpu_torch.main import main as cli
    from sevennet_finetuning_tpu_torch.pipeline import _read_file

    art = tmp_path / 'ft.sevenn_data'
    structs = _read_file(str(FT), 'structure_list')
    run_tm = type_map_from_species({sp for s in structs for sp in s.species})
    if built == 'run_type_map':
        ds.save_sevenn_data(str(art), ds.GraphDataset.from_structures(
            structs, 4.0, run_tm), 4.0, run_tm, structures=structs)
    else:
        cli(['graph_build', str(FT), '3.5', '-o', str(art)])
    for name, data in (('xyz', FT), ('art', art)):
        cli(['train', _narrow_yaml(tmp_path / f'{name}.yaml', data), '-w',
             str(tmp_path / name), '--device', 'cpu'])
    assert _csv(tmp_path / 'art' / 'log.csv') == _csv(
        tmp_path / 'xyz' / 'log.csv')


def test_save_keys_write_what_jax_reads(tmp_path):
    from sevennet_finetuning_tpu.data import dataset as jds
    from sevennet_finetuning_tpu.data.elements import type_map_from_species
    from sevennet_finetuning_tpu.pipeline import _read_file
    from sevennet_finetuning_tpu_torch.main import main as cli

    y = _narrow_yaml(tmp_path / 'in.yaml', FT, epoch=1)
    cfg = yaml.safe_load(Path(y).read_text())
    cfg['data'].update({'save_dataset_path': str(tmp_path / 'total'),
                        'save_by_label': True, 'save_by_train_valid': True})
    Path(y).write_text(yaml.safe_dump(cfg))
    cli(['train', y, '-w', str(tmp_path / 'out'), '--device', 'cpu'])
    structs = _read_file(str(FT), 'extxyz')
    want = jds.GraphDataset.from_structures(structs, 4.0, type_map_from_species(
        {sp for s in structs for sp in s.species}))
    total = jds.load_sevenn_data(str(tmp_path / 'total.sevenn_data'))
    _same_graphs(total.graphs, want.graphs)
    assert len(jds.sevenn_data_structures(
        str(tmp_path / 'total.sevenn_data'))) == 5
    label = str(FT).replace('/', '_')
    by_label = jds.load_sevenn_data(
        str(tmp_path / 'out' / f'{label}.sevenn_data'))
    _same_graphs(by_label.graphs, want.graphs)
    split = [jds.load_sevenn_data(str(tmp_path / 'out' / f'{n}.sevenn_data'))
             for n in ('train', 'valid')]
    assert [len(d) for d in split] == [4, 1]
    _same_graphs(sorted(split[0].graphs + split[1].graphs,
                        key=lambda g: float(g['total_energy'][0])),
                 sorted(want.graphs,
                        key=lambda g: float(g['total_energy'][0])))
