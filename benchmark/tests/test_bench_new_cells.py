"""The EquiformerV2 serving cell and the waiting 96-atom MD cell at tiny
CPU sizes.

``conftest.TINY`` lists the cells it was written with; the EquiformerV2
cell's size joins it when this module is collected (a whole run of this
directory collects every module before the first test), so the tests
parametrized over every cell of ``BENCHMARK.json`` run it too, as
``test_bench_added_cells.py`` does for the Gaunt cell.  Here also: the
serving faults on the EquiformerV2 cell, its FLOP and floor counts, and
the 96-atom MD cell, which waits outside ``BENCHMARK.json`` (its rate
spreads more than its bound allows; PERF.md, Open questions): run from a
copy of the manifest that adds its entries, sound and with MD's
faults."""

import json
import sys
import time
from pathlib import Path

import pytest

from benchmark import faults as F
from benchmark.tests.conftest import ROOT

EQV2 = 'equiformer_v2_31m.serve_eqv2_1152'
MD96 = 'sevennet0.md_nve_96'
ADDED = {
    EQV2: {'source_atoms': 12, 'pool': {'1,1,1': 3, '2,1,1': 1},
           'check_requests': 16},
}
MD96_TINY = {'source_atoms': 12, 'replicate': [1, 1, 1], 'warm_steps': 3,
             'check_steps': 2}
# the 96-atom cell's entries as BENCHMARK.json would hold them
MD96_WAITING = {
    'name': MD96, 'config': 'sevennet0', 'traffic': 'md_nve_96', 'chips': 1,
    'why': 'NVE run_device on 96 atoms at 500 K, dt 2 fs, skin 0.5: small '
           'launches, so dispatch and the per-step skin read set the rate'}
MD96_LISTS = ('md_atom_steps_per_s', 'md.steps_per_rebuild', 'device_ops.md',
              'device_idle.md', 'mfu.md', 'kernels_roofline.md')
_CONFTEST = Path(__file__).with_name('conftest.py')
for _mod in list(sys.modules.values()):
    if Path(getattr(_mod, '__file__', None) or '.') == _CONFTEST:
        for _cell, _sizes in ADDED.items():
            _mod.TINY.setdefault(_cell, _sizes)


def run(cell, overrides, seconds=1.0, **kw):
    import torch

    from benchmark.harness import run_cell

    torch.set_num_threads(2)
    return run_cell(cell, 2 ** 36 + 21, seconds, False, time.perf_counter(),
                    device='cpu', overrides=overrides, log=lambda *a: None,
                    **kw)


@pytest.fixture
def md96_root(tmp_path):
    """A checkout whose manifest adds the 96-atom cell; the rest linked."""
    manifest = json.loads((ROOT / 'BENCHMARK.json').read_text())
    manifest['workloads'].append(MD96_WAITING)
    for m in manifest['end_to_end'] + manifest['per_layer']:
        if m['name'] in MD96_LISTS:
            m['workloads'].append(MD96)
    (tmp_path / 'BENCHMARK.json').write_text(json.dumps(manifest))
    for link in ('benchmark', 'experiments', 'sevennet_finetuning_tpu_torch'):
        (tmp_path / link).symlink_to(ROOT / link)
    return tmp_path


@pytest.mark.parametrize('fault', sorted(
    F.FAULTS['mace_mp0_medium_widths.serve_mix']))
def test_a_planted_serving_fault_on_the_eqv2_cell_comes_out_not_correct(
        fault, monkeypatch):
    F.FAULTS['mace_mp0_medium_widths.serve_mix'][fault](monkeypatch.setattr)
    # a window of several requests: a stale answer shows once a size repeats
    out = run(EQV2, ADDED[EQV2], seconds=4.0)
    assert out['correct'] is False, out['checks']


def test_the_96_atom_cell_runs_from_its_waiting_entries(md96_root):
    out = run(MD96, MD96_TINY, root=md96_root)
    assert out['correct'] is True, out['checks']
    assert out['attempted'] >= 1 and out['failed'] == 0
    assert set(out['metrics']) == {'setup_s', 'md_atom_steps_per_s',
                                   'peak_mem_gib'}


@pytest.mark.parametrize('fault', sorted(F.FAULTS['sevennet0.md_nve_6144']))
def test_a_planted_md_fault_on_the_96_atom_cell_comes_out_not_correct(
        fault, monkeypatch, md96_root):
    F.FAULTS['sevennet0.md_nve_6144'][fault](monkeypatch.setattr)
    out = run(MD96, MD96_TINY, root=md96_root)
    assert out['correct'] is False, out['checks']


def test_eqv2_counts_a_force_evaluation_and_its_floor():
    """The FLOPs of the published widths' force evaluation at 1,152 atoms
    and 23,040 edges: the SO(2) maps lead, the floor's backward about the
    forward (no weight gradient) and the floor under those FLOPs at the
    peak; the evaluation ``FORCE_PASSES`` forwards, as every family's."""
    from benchmark import program
    from benchmark.count.bounds import FP32_FLOP_PER_S
    from benchmark.count.eqv2 import EqV2Work
    from benchmark.count.flops import FORCE_PASSES

    cfg = program.model_config(json.loads(
        (ROOT / 'benchmark' / 'configs' / 'equiformer_v2_31m.json')
        .read_text()))
    w = EqV2Work(cfg)
    fwd = w.parts(23040, 1152, 0)
    bwd = w.parts(23040, 1152, 1)
    assert max(fwd, key=lambda k: fwd[k][0]) == 'so2'
    # 8 blocks x 23,040 edges x 3.81 M multiply-adds of the two SO(2) maps
    assert abs(fwd['so2'][0] - 2 * 8 * 23040 * 3_809_280) < 1
    total = sum(f for f, _ in fwd.values())
    assert 1.0 < sum(f for f, _ in bwd.values()) / total < 1.05
    assert w.force_flops(23040, 1152) == pytest.approx(FORCE_PASSES * total)
    floor = w.floor_seconds(23040, 1152, 0) + w.floor_seconds(23040, 1152, 1)
    assert floor >= (total + sum(f for f, _ in bwd.values())) \
        / FP32_FLOP_PER_S
