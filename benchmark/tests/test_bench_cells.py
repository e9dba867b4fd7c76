"""Each cell's harness path at a tiny size on the CPU, a cell added from new
files only, and the reduction of a device trace."""

import hashlib
import json
import shutil
import time
from pathlib import Path

import pytest

from benchmark.tests.conftest import CELLS, ROOT, WAITING_CELLS

RESULT_KEYS = {'correct', 'attempted', 'failed', 'metrics', 'device'}


def run(cell, overrides, **kw):
    import torch

    from benchmark.harness import run_cell

    torch.set_num_threads(2)
    return run_cell(cell, 2 ** 40 + 3, 0.5, False, time.perf_counter(),
                    device='cpu', overrides=overrides, log=lambda *a: None,
                    **kw)


@pytest.mark.parametrize('cell', CELLS + WAITING_CELLS)
def test_tiny_cpu_pass_prints_the_contract_keys(cell, tiny, root_of):
    out = run(cell, tiny[cell], root=root_of(cell))
    line = json.loads(json.dumps(out))
    assert RESULT_KEYS <= set(line)
    assert list(line)[-1] == 'checks'
    assert line['correct'] is True, line['checks']
    assert line['attempted'] >= 1 and line['failed'] == 0
    assert 'setup_s' in line['metrics'] and len(line['metrics']) >= 3
    assert all(v['value'] > 0 for k, v in line['metrics'].items()
               if k != 'peak_mem_gib')


def _digest(root):
    return {p: hashlib.sha1(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob('*')) if p.is_file()
            and '__pycache__' not in p.parts}


def test_a_cell_from_new_files_runs_without_editing_any(tmp_path, tiny):
    """A second serving mix: a new traffic file and a new limits file, and
    a new entry in BENCHMARK.json; no file that was there changes."""
    bench = tmp_path / 'benchmark'
    shutil.copytree(ROOT / 'benchmark', bench,
                    ignore=shutil.ignore_patterns('__pycache__', 'tests'))
    manifest = json.loads((ROOT / 'BENCHMARK.json').read_text())
    before = _digest(bench)
    traffic = json.loads((bench / 'traffic' / 'serve_mix.json').read_text())
    traffic.update(tiny['mace_mp0_medium_widths.serve_mix'])
    traffic['pool'] = {'1,1,1': 3}
    (bench / 'traffic' / 'serve_small.json').write_text(json.dumps(traffic))
    name = 'mace_mp0_medium_widths.serve_small'
    shutil.copy(bench / 'limits' / 'mace_mp0_medium_widths.serve_mix.json',
                bench / 'limits' / f'{name}.json')
    manifest['workloads'].append({
        'name': name, 'config': 'mace_mp0_medium_widths',
        'traffic': 'serve_small', 'chips': 1, 'why': 'a test cell'})
    for m in manifest['end_to_end'] + manifest['per_layer']:
        if 'mace_mp0_medium_widths.serve_mix' in m.get('workloads', ()):
            m['workloads'].append(name)
    (tmp_path / 'BENCHMARK.json').write_text(json.dumps(manifest))
    (tmp_path / 'benchmark' / 'configs').exists()
    for link in ('experiments', 'sevennet_finetuning_tpu_torch'):
        (tmp_path / link).symlink_to(ROOT / link)
    out = run(name, {}, root=tmp_path, bench_dir=bench)
    assert out['correct'] is True and out['attempted'] >= 1
    assert 'serve_p95_ms' in out['metrics']
    after = _digest(bench)
    assert {p: h for p, h in after.items() if p in before} == before


def test_trace_reduction_counts_union_gaps_and_families():
    from benchmark.trace import WINDOW_SPAN, breakdown, reduce_trace

    def x(name, cat, ts, dur):
        return {'ph': 'X', 'name': name, 'cat': cat, 'ts': ts, 'dur': dur}

    events = [
        x(WINDOW_SPAN, 'user_annotation', 0, 100),
        x('bench.train_step', 'user_annotation', 0, 60),
        x('bench.graph_build', 'user_annotation', 60, 40),
        x('void seg_sum_sorted<4>(float)', 'kernel', 10, 10),
        x('void seg_sum_sorted<1>(float)', 'kernel', 15, 10),   # overlaps
        x('cg_agg_bulk_kernel', 'kernel', 40, 5),
        x('Memcpy HtoD', 'gpu_memcpy', 70, 10),
        x('late', 'kernel', 95, 20),                            # clipped
    ]
    tr = reduce_trace(events)
    assert tr['window_s'] == pytest.approx(100e-6)
    assert tr['busy_s'] == pytest.approx((15 + 5 + 10 + 5) * 1e-6)
    assert tr['n_device_ops'] == 4
    assert tr['csrc']['segment_sum'] == (2, pytest.approx(20e-6))
    # gaps 0-10, 25-40 and 45-70 start in train_step, 80-95 in
    # graph_build: a gap goes to the span around its start
    assert tr['idle_by_span']['train_step'] == pytest.approx(50e-6)
    assert tr['idle_by_span']['graph_build'] == pytest.approx(15e-6)
    b = breakdown(tr)
    assert b['device_ops'][0][0] == 'segment_sum'
    assert b['idle_gaps'][0][0] == 'train_step'

