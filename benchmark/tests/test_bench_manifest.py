"""BENCHMARK.json against the contract the harness is built to, and every
cell's files found by name."""

import json
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
MANIFEST = json.loads((ROOT / 'BENCHMARK.json').read_text())
NAME = re.compile(r'^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$')
UNIT = re.compile(r'^[A-Za-z0-9_/%.\-]{1,16}$')
KEYS = {'command', 'paths', 'run_seconds', 'configs', 'workloads',
        'end_to_end', 'per_layer'}


def test_top_level_keys_and_limits():
    assert set(MANIFEST) == KEYS
    assert 1 <= len(MANIFEST['paths']) <= 16
    assert all(re.match(r'^[A-Za-z0-9_.\-/]{1,200}$', p)
               for p in MANIFEST['paths'])
    assert isinstance(MANIFEST['run_seconds'], int)
    assert 1 <= MANIFEST['run_seconds'] <= 51
    # a full check of 24 cells fits into its 43,200 s
    runs = 2 + 14 * 24
    assert (runs * (MANIFEST['run_seconds'] + 60) + 24 * 2 * 90 + 1200
            <= 43200)
    assert len(json.dumps(MANIFEST)) <= 64 * 1024
    cmd = MANIFEST['command']
    assert len(cmd) <= 32 and not any(w.startswith('/') or '..' in w
                                      for w in cmd)
    assert cmd[1].startswith(MANIFEST['paths'][0] + '/')


@pytest.mark.parametrize('section', ['configs', 'workloads', 'end_to_end',
                                     'per_layer'])
def test_names_are_unique_and_well_formed(section):
    names = [e['name'] for e in MANIFEST[section]]
    assert len(set(names)) == len(names)
    assert all(NAME.match(n) for n in names), names


def test_entries_have_just_the_contract_keys():
    for c in MANIFEST['configs']:
        assert set(c) == {'name', 'source', 'file', 'reduced', 'why'}
        assert 1 <= len(c['why']) <= 200 and '\n' not in c['why']
        assert c['file'].startswith(MANIFEST['paths'][0] + '/')
        assert len(c['reduced']) <= 16
    for w in MANIFEST['workloads']:
        assert set(w) == {'name', 'config', 'traffic', 'chips', 'why'}
        assert w['chips'] in (1, 4) and 1 <= len(w['why']) <= 200
        assert NAME.match(w['traffic']) and NAME.match(w['config'])
    for m in MANIFEST['end_to_end']:
        assert set(m) - {'workloads'} == {'name', 'unit', 'better', 'bound',
                                          'source'}
        assert m['source'] in ('host_clock', 'device_trace')
        assert 0.01 <= m['bound'] <= 0.25
    for m in MANIFEST['per_layer']:
        assert set(m) - {'workloads'} == {'name', 'unit', 'better', 'source',
                                          'layer', 'moves'}
        assert m['source'] in ('device_trace', 'program_span',
                               'program_counter', 'host_clock')
    for m in MANIFEST['end_to_end'] + MANIFEST['per_layer']:
        assert UNIT.match(m['unit']), m
        assert m['better'] in ('lower', 'higher')


def test_four_chip_cells_within_a_quarter():
    four = sum(w['chips'] == 4 for w in MANIFEST['workloads'])
    assert four <= max(1, len(MANIFEST['workloads']) // 4)


def _reports(cell):
    return {m['name'] for m in MANIFEST['end_to_end']
            if 'workloads' not in m or cell in m['workloads']}


def test_every_cell_reports_setup_another_metric_and_a_layer():
    for w in MANIFEST['workloads']:
        e2e = _reports(w['name'])
        assert 'setup_s' in e2e and len(e2e) >= 2
        assert any(w['name'] in m.get('workloads', ())
                   for m in MANIFEST['per_layer'])


def test_moves_names_an_end_to_end_metric_its_cells_report():
    e2e = {m['name'] for m in MANIFEST['end_to_end']}
    cells = {w['name'] for w in MANIFEST['workloads']}
    for m in MANIFEST['per_layer']:
        assert m['moves'] in e2e
        for cell in m['workloads']:
            assert cell in cells
            assert m['moves'] in _reports(cell), (m['name'], cell)


def test_one_layer_name_per_layer_stem():
    layers = {}
    for m in MANIFEST['per_layer']:
        layers.setdefault(m['name'].split('.')[0], set()).add(m['layer'])
    assert all(len(v) == 1 for v in layers.values()), layers


def test_every_configuration_is_used():
    used = {w['config'] for w in MANIFEST['workloads']}
    assert used == {c['name'] for c in MANIFEST['configs']}


@pytest.mark.parametrize('cell', [w['name'] for w in MANIFEST['workloads']])
def test_cell_resolves_its_files_by_name(cell):
    from benchmark import harness

    w = harness.find(MANIFEST['workloads'], cell, 'workload')
    cfg = harness.find(MANIFEST['configs'], w['config'], 'configuration')
    assert (ROOT / cfg['file']).exists()
    traffic = json.loads((harness.BENCH_DIR / 'traffic'
                          / f'{w["traffic"]}.json').read_text())
    assert (harness.BENCH_DIR / 'generators'
            / f'{traffic["kind"]}.py').exists()
    assert (harness.BENCH_DIR / 'limits' / f'{cell}.json').exists()
    _, per = harness.cell_metrics(MANIFEST, cell)
    for m in per:
        assert hasattr(harness.metric_reader(m['name']), 'read')


def test_configuration_files_hold_their_sizes():
    for c in MANIFEST['configs']:
        doc = json.loads((ROOT / c['file']).read_text())
        assert doc['name'] == c['name'] and doc['reduced'] == c['reduced']
        assert 'model' in doc and doc['model']['channel'] == 128
