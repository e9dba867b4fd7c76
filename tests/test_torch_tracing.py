"""The port's span and counter recorder (``tracing``): off by default and
inert, the span trees of one ``Calculator.calculate`` and of a short
``run_device``, bit-equal results with the recorder on and off, the
chrome events on a ``torch.profiler`` trace's clock, and the cap.

Runs on the CPU with a narrow model (2 species, 4 channels, lmax 1,
2 convolutions, cutoff 3 A) from ``init_params``; no JAX."""

import json

import numpy as np
import pytest
import torch

from sevennet_finetuning_tpu_torch import tracing

torch.set_num_threads(2)

MODEL_SPANS = {'model.forward', 'model.grad', 'model.forces_stress'}


@pytest.fixture(autouse=True)
def _recorder_off_after():
    tracing.disable()
    tracing.reset()
    yield
    tracing.disable()
    tracing.reset()


@pytest.fixture(scope='module')
def calc():
    from sevennet_finetuning_tpu_torch import keys as K
    from sevennet_finetuning_tpu_torch.calculator import Calculator
    from sevennet_finetuning_tpu_torch.model.build import build_model_spec
    from sevennet_finetuning_tpu_torch.model.nequip import init_params

    spec = build_model_spec({
        K.NUM_SPECIES: 2, K.TYPE_MAP: {8: 0, 72: 1},
        K.NODE_FEATURE_MULTIPLICITY: 4, K.LMAX: 1,
        K.NUM_CONVOLUTION: 2, K.CUTOFF: 3.0, K.IS_PARITY: False,
        K.SELF_CONNECTION_TYPE: 'linear', K.CONV_DENOMINATOR: 10.0,
        K.SHIFT: 0.0, K.SCALE: 1.0,
    })
    return Calculator(spec, init_params(spec, 0), device='cpu')


def _structure(seed=3, n=12, a=8.0):
    from sevennet_finetuning_tpu_torch.data.vasp import Structure

    rng = np.random.default_rng(seed)
    return Structure(species=['Hf' if i % 3 == 0 else 'O' for i in range(n)],
                     pos=rng.uniform(0, a, (n, 3)), cell=np.eye(3) * a)


def _by_id():
    return {r[3]: r for r in tracing.records()}


def _children(parent_id):
    return [r for r in tracing.records() if r[4] == parent_id]


def _inside(child, parent):
    return parent[1] <= child[1] <= child[2] <= parent[2]


def _vv(calc, T=3000.0):
    from sevennet_finetuning_tpu_torch.md import VelocityVerlet

    vv = VelocityVerlet(_structure(), calc, dt_fs=2.0)
    vv.set_temperature(T, seed=2)
    return vv


def test_off_span_is_one_shared_no_op():
    spans = [tracing.span('a'), tracing.span('b', unit=True, n=1)]
    assert spans[0] is spans[1] is tracing.OFF
    with tracing.span('a') as s:
        s.set(x=1)
        tracing.count('host_syncs')
    assert tracing.records() == [] and not tracing.counters()


def test_calculate_records_one_request_tree(calc):
    s = _structure()
    tracing.enable()
    calc.calculate(s)
    tracing.disable()
    recs = tracing.records()
    roots = [r for r in recs if r[4] == 0]
    assert [r[0] for r in roots] == ['calc.request']
    root = roots[0]
    assert root[3] == root[5]                      # it opens its unit
    assert root[6]['n_atoms'] == len(s) and root[6]['edge_capacity'] > 0
    kids = _children(root[3])
    assert [r[0] for r in kids] == ['graph.build', 'model.forward',
                                    'model.grad', 'model.forces_stress',
                                    'calc.fetch.wait']
    assert len(recs) == 6
    assert all(r[5] == root[3] for r in recs)
    assert all(_inside(r, root) for r in kids)
    assert all(a[2] <= b[1] for a, b in zip(kids, kids[1:]))
    assert tracing.counters() == {'host_syncs': 4}


def test_run_device_records_segments_steps_and_syncs(calc):
    n_steps, seg_steps = 12, 5
    vv = _vv(calc)
    tracing.enable()
    res = vv.run_device(n_steps, seg_steps=seg_steps)
    tracing.disable()
    recs = tracing.records()
    by_id = _by_id()
    # the skin reads: one a step, one more for each segment a trip ended
    trips, remaining = 0, n_steps
    for done in res.segments:
        trips += done < min(seg_steps, remaining)
        remaining -= done
    assert trips >= 1, 'the hot start should trip the skin check'
    fetches = len(res.segments) + 1               # one a segment, the end
    assert tracing.counters()['host_syncs'] == n_steps + trips + fetches
    names = [r[0] for r in recs]
    assert names.count('md.segment') == len(res.segments)
    assert names.count('md.rebuild') == len(res.segments)   # initial + each
    assert names.count('md.skin.wait') == n_steps + trips
    assert names.count('md.fetch.wait') == fetches
    steps = [r for r in recs if r[0] == 'md.step']
    assert len(steps) == n_steps + trips
    assert sum(1 for r in steps if (r[6] or {}).get('skin_trip')) == trips
    for st in steps:
        kids = [r[0] for r in _children(st[3])]
        assert st[3] == st[5] and by_id[st[4]][0] == 'md.segment'
        if (st[6] or {}).get('skin_trip'):
            assert kids == ['md.skin.wait']
        else:
            assert kids == ['md.skin.wait', 'md.integrate', 'model.forward',
                            'model.grad', 'model.forces_stress',
                            'md.integrate']
    for r in recs:
        if r[0] == 'graph.build':
            assert by_id[r[4]][0] == 'md.rebuild' and _inside(r, by_id[r[4]])
        if r[0] in MODEL_SPANS and r[5] == 0:
            # the first force evaluation, before any step
            assert by_id[r[4]][0] == 'md.segment'
    assert sum(1 for r in recs if r[0] == 'model.forward' and r[5] == 0) == 1


def test_results_bit_equal_with_the_recorder_on_and_off(calc):
    s = _structure()
    off = calc.calculate(s)
    tracing.enable()
    on = calc.calculate(s)
    tracing.disable()
    for k in off:
        assert np.array_equal(np.asarray(off[k]), np.asarray(on[k])), k
    runs = []
    for record in (False, True):
        vv = _vv(calc)
        if record:
            tracing.enable()
        res = vv.run_device(8, seg_steps=4)
        tracing.disable()
        runs.append((res.energies, res.kinetic, res.segments, vv.s.pos,
                     vv.vel))
    assert tracing.records()
    for a, b in zip(*runs):
        assert np.array_equal(np.asarray(a), np.asarray(b))


def test_chrome_events_lie_on_the_profiler_clock(tmp_path):
    from torch.profiler import ProfilerActivity, profile, record_function

    tracing.enable()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with tracing.span('outer'):
            with record_function('inner'):
                torch.ones(64).sum()
    tracing.disable()
    path = tmp_path / 'trace.json'
    prof.export_chrome_trace(str(path))
    doc = json.loads(path.read_text())
    base_us = int(doc['baseTimeNanoseconds']) / 1e3
    inner = next(e for e in doc['traceEvents'] if e.get('name') == 'inner'
                 and e.get('ph') == 'X')
    outer, = tracing.chrome_events()
    t0 = float(inner['ts']) + base_us
    t1 = t0 + float(inner['dur'])
    assert outer['ts'] - 500 <= t0 <= t1 <= outer['ts'] + outer['dur'] + 500
    out = tmp_path / 'program.json'
    tracing.export_chrome(str(out))
    assert json.loads(out.read_text())['traceEvents'] == [outer]


def test_recording_stops_at_the_cap(monkeypatch):
    monkeypatch.setattr(tracing, 'CAP', 3)
    tracing.enable()
    for k in range(5):
        with tracing.span(f's{k}'):
            tracing.count('n')
    assert [r[0] for r in tracing.records()] == ['s0', 's1', 's2']
    assert tracing.dropped() == 2
    assert tracing.counters() == {'n': 5}
    tracing.reset()
    assert tracing.records() == [] and tracing.dropped() == 0
