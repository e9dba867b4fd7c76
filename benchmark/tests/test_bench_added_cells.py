"""The Gaunt serving cell and the waiting four-card halo MD cell at tiny CPU
sizes.

``conftest.TINY`` lists the cells it was written with; the Gaunt cell's
size joins it when this module is collected (a whole run of this
directory collects every module before the first test), so the tests
parametrized over every cell of ``BENCHMARK.json`` run it too.  Here also:
serving's planted faults on the Gaunt cell, and the halo cell, which waits
outside ``BENCHMARK.json`` until four-card runs at its size set its limits
(PERF.md, Open questions): run from a copy of the manifest that adds its
entries, as two gloo ranks on the CPU, each a process."""

import json
import sys
import time
from pathlib import Path

import pytest

from benchmark import faults as F
from benchmark.tests.conftest import MANIFEST, ROOT

GAUNT = 'gaunt_mp0_medium_widths.serve_1152'
HALO = 'sevennet0.md_halo4_24576'
ADDED = {
    GAUNT: {'source_atoms': 12, 'pool': {'1,1,1': 3, '2,1,1': 1},
            'check_requests': 16},
}
HALO_TINY = {'source_atoms': 12, 'replicate': [2, 1, 1], 'ranks': 2,
             'backend': 'gloo', 'warm_steps': 3, 'check_steps': 2,
             'timeout_s': 120}
# the halo cell's entries as BENCHMARK.json would hold them
HALO_WAITING = {
    'workloads': [
        {'name': HALO, 'config': 'sevennet0', 'traffic': 'md_halo4_24576',
         'chips': 4,
         'why': 'halo-parallel NVE over NCCL, 24,576 atoms (6,144 a card), '
                '500 K, dt 2 fs: a ghost exchange before every convolution '
                'and its reverse in the force backward'}],
    'per_layer': [
        {'name': 'halo.bytes_per_step', 'unit': 'B/step', 'better': 'lower',
         'source': 'program_counter', 'layer': 'Parallel',
         'moves': 'md_atom_steps_per_s', 'workloads': [HALO]}],
}
# every loaded copy of conftest (pytest's own, and the package module the
# tests import their names from)
_CONFTEST = Path(__file__).with_name('conftest.py')
for _mod in list(sys.modules.values()):
    if Path(getattr(_mod, '__file__', None) or '.') == _CONFTEST:
        for _cell, _sizes in ADDED.items():
            _mod.TINY.setdefault(_cell, _sizes)


def run(cell, overrides, **kw):
    import torch

    from benchmark.harness import run_cell

    torch.set_num_threads(2)
    return run_cell(cell, 2 ** 35 + 9, 1.0, kw.pop('trace', False),
                    time.perf_counter(), device='cpu', overrides=overrides,
                    log=lambda *a: None, **kw)


@pytest.fixture
def halo_root(tmp_path):
    """A checkout whose manifest adds the halo cell; the rest linked (the
    other ranks import the program from it)."""
    manifest = json.loads(json.dumps(MANIFEST))
    for section, entries in HALO_WAITING.items():
        manifest[section] += entries
    for m in manifest['end_to_end']:
        if m['name'] == 'md_atom_steps_per_s':
            m['workloads'].append(HALO)
    (tmp_path / 'BENCHMARK.json').write_text(json.dumps(manifest))
    for link in ('benchmark', 'experiments', 'sevennet_finetuning_tpu_torch'):
        (tmp_path / link).symlink_to(ROOT / link)
    return tmp_path


@pytest.mark.parametrize('fault', sorted(
    F.FAULTS['mace_mp0_medium_widths.serve_mix']))
def test_a_planted_serving_fault_on_the_gaunt_cell_comes_out_not_correct(
        fault, monkeypatch):
    F.FAULTS['mace_mp0_medium_widths.serve_mix'][fault](monkeypatch.setattr)
    out = run(GAUNT, ADDED[GAUNT])
    assert out['correct'] is False, out['checks']


def test_halo_tiny_cpu_pass_prints_the_contract_keys(halo_root):
    out = run(HALO, HALO_TINY, root=halo_root)
    assert out['correct'] is True, out['checks']
    assert out['attempted'] >= 4 and out['failed'] == 0
    assert set(out['metrics']) == {'setup_s', 'md_atom_steps_per_s',
                                   'peak_mem_gib'}
    assert out['metrics']['md_atom_steps_per_s']['value'] > 0


def test_halo_traced_pass_reads_the_swap_bytes(halo_root):
    out = run(HALO, HALO_TINY, root=halo_root, trace=True)
    assert out['correct'] is True, out['checks']
    assert out['metrics']['halo.bytes_per_step']['value'] > 0


@pytest.mark.parametrize('fault', ['wrong_time_step', 'positions_unchanged'])
def test_halo_integrator_faults_come_out_not_correct(fault, halo_root):
    out = run(HALO, dict(HALO_TINY, fault=fault), root=halo_root)
    assert out['correct'] is False, out['checks']


def test_halo_ranks_in_one_process_read_as_in_two(halo_root):
    one = run(HALO, dict(HALO_TINY, single_process=True), root=halo_root)
    two = run(HALO, HALO_TINY, root=halo_root)
    assert one['correct'] and two['correct']
    assert one['attempted'] >= 4 and two['attempted'] >= 4
