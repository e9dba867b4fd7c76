"""Settings of the benchmark's tests: the ``card`` marker (tests that need
an NVIDIA GPU; each decides inside a fixture whether one is present and
skips otherwise), the tiny CPU sizes of each cell's traffic, and the cells
that wait outside ``BENCHMARK.json``."""

import json
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
MANIFEST = json.loads((ROOT / 'BENCHMARK.json').read_text())

# A cell whose harness, traffic and limits are built and were proven on the
# card, but which is not in BENCHMARK.json: its rate is the host's, and
# the host's speed swings more than a bound can hold (PERF.md, Open
# questions).  Its entries as BENCHMARK.json would hold them; the tests run
# it from a copy of the manifest that adds them.
WAITING = {
    'workloads': [
        {'name': 'sevennet0.reewc_train', 'config': 'sevennet0',
         'traffic': 'reewc_train', 'chips': 1,
         'why': 'closed-loop reEWC rehearsal, batch 8 of 96-atom HfO2 then '
                'batch 8 of 12/60-atom replay: double backward kernels and '
                "the Trainer's host dispatch"}],
    'end_to_end': [
        {'name': 'train_structures_per_s', 'unit': 'structures/s',
         'better': 'higher', 'bound': 0.25, 'source': 'host_clock',
         'workloads': ['sevennet0.reewc_train']}],
    'per_layer': [
        {'name': name, 'unit': unit, 'better': better, 'source': source,
         'layer': layer, 'moves': 'train_structures_per_s',
         'workloads': ['sevennet0.reewc_train']}
        for name, unit, better, source, layer in (
            ('train.host_ms_per_step', 'ms/step', 'lower', 'program_span',
             'Trainer'),
            ('device_ops.train', 'ops/step', 'lower', 'device_trace',
             'Model'),
            ('kernels_roofline.train', '%', 'higher', 'device_trace',
             'Kernels'),
            ('mfu.train', '%', 'higher', 'host_clock', 'Device'),
            ('device_idle.train', '%', 'lower', 'device_trace', 'Device'))],
}
CELLS = [w['name'] for w in MANIFEST['workloads']]
WAITING_CELLS = [w['name'] for w in WAITING['workloads']]


def pytest_configure(config):
    config.addinivalue_line(
        'markers', 'card: needs a CUDA card; skipped where none is present')


# traffic overrides that make each cell's harness path run in seconds on
# the CPU: the same code, a few small structures
TINY = {
    'sevennet0.reewc_train': {'train_mix': {'12': 8},
                              'memory_mix': {'12': 8}, 'batch': 4},
    'mace_mp0_medium_widths.serve_mix': {
        'source_atoms': 12, 'pool': {'1,1,1': 3, '2,1,1': 1},
        # two of the pool's four answers are wrong when each size is
        # answered with its first: 16 checked requests miss both by chance
        # once in ~30,000
        'check_requests': 16},
    'sevennet0.md_nve_6144': {'source_atoms': 12, 'replicate': [1, 1, 1],
                              'warm_steps': 3, 'check_steps': 2},
}


@pytest.fixture
def tiny():
    return TINY


@pytest.fixture
def root_of(tmp_path):
    """The checkout a cell runs from: this one for the cells of
    BENCHMARK.json, a copy of its manifest with the waiting cells added
    (and the rest linked) for those."""
    manifest = json.loads(json.dumps(MANIFEST))
    for section, entries in WAITING.items():
        manifest[section] += entries
    (tmp_path / 'BENCHMARK.json').write_text(json.dumps(manifest))
    for link in ('benchmark', 'experiments'):
        (tmp_path / link).symlink_to(ROOT / link)
    return lambda cell: tmp_path if cell in WAITING_CELLS else ROOT


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card')
    return torch.device('cuda', 0)
