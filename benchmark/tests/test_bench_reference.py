"""The plain reference against the program's plain CPU path at small sizes,
and the reference's own invariances."""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
FT900 = ROOT / 'experiments/ft_reewc_900/data/ft900.extxyz'


@pytest.fixture(scope='module')
def structures():
    from benchmark import inputs

    return inputs.read_extxyz(FT900)[:2]


def _configs():
    from benchmark import program

    out = {}
    for name in ('sevennet0', 'mace_mp0_medium_widths'):
        doc = json.loads((ROOT / f'benchmark/configs/{name}.json')
                         .read_text())
        out[name] = program.weights(doc, ROOT, 2 ** 35 + 1, 'cpu')
    return out


@pytest.mark.parametrize('name', ['sevennet0', 'mace_mp0_medium_widths'])
def test_reference_matches_the_programs_plain_path(name, structures):
    from benchmark import inputs, program
    from benchmark.reference import graph as ref_graph
    from benchmark.reference.model import Reference

    torch.set_num_threads(2)
    cfg, params = _configs()[name]
    ref = Reference(cfg, params, 'cpu')
    calc = program.calculator(cfg, params, 'cpu')
    s = inputs.rattle(structures[0], 0.02, np.random.default_rng(3))
    e, f, st = ref.evaluate(ref_graph.batch_graphs(
        [s], ref.spec.cutoff, cfg['_type_map'], 'cpu'))
    out = calc.calculate(inputs.to_program(s))
    assert abs(out['energy'] - float(e[0])) <= 2e-6 * abs(float(e[0]))
    assert np.abs(out['forces'] - f.numpy()).max() <= \
        1e-4 * np.abs(f.numpy()).max()
    assert np.abs(out['stress'] - st[0].numpy()).max() <= \
        1e-4 * np.abs(st[0].numpy()).max()


def test_edges_do_not_depend_on_the_atoms_image(structures):
    from benchmark.reference import graph as ref_graph
    from benchmark.reference.model import Reference

    cfg, params = _configs()['sevennet0']
    ref = Reference(cfg, params, 'cpu')
    s = structures[0]
    moved = dict(s)
    p = s['pos'].copy()
    p[::3] += 2 * s['cell'][0] - s['cell'][2]
    p[1::5] -= 3 * s['cell'][1]
    moved['pos'] = p
    tm = cfg['_type_map']
    a = ref.evaluate(ref_graph.batch_graphs([s], 5.0, tm, 'cpu'))
    b = ref.evaluate(ref_graph.batch_graphs([moved], 5.0, tm, 'cpu'))
    assert float(a[0][0]) == pytest.approx(float(b[0][0]), rel=1e-7)
    assert float((a[1] - b[1]).abs().max()) <= 1e-4


def test_the_packing_and_order_match_the_loader(structures):
    from sevennet_finetuning_tpu_torch.data.dataset import (GraphDataset,
                                                            Loader)

    from benchmark import inputs
    from benchmark.generators.train import first_order, packed_batches
    from benchmark.reference import graph as ref_graph

    all_s = inputs.read_extxyz(FT900)[:40]
    edges = ref_graph.edge_counts(all_s, 5.0, 'cpu')
    members = packed_batches(edges, 8)
    loader = Loader(GraphDataset.from_structures(
        [inputs.to_program(s) for s in all_s], 5.0, {72: 0, 8: 1}), 8,
        shuffle=True, seed=2 ** 40 + 9, cache=True)
    got = loader._balanced_order.reshape(-1, 8).tolist()
    assert [sorted(m) for m in members] == [sorted(m) for m in got]
    assert list(first_order(len(members), 2 ** 40 + 9)) == \
        list(loader.epoch_order())
