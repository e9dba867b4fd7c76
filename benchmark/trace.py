"""Spans, the device trace and its reduction.

``Spans`` times named calls into the program on the host clock, with no
synchronisation; while a trace is on it also lays each span on the
profiler's timeline (``record_function('bench.<name>')``), so an idle gap
of the device can be labelled by what the host was doing.

``DeviceTrace`` runs ``torch.profiler`` over one slice of the window,
exports its chrome trace to ``TMPDIR`` and reduces it: the device's own
events (kernels, copies, fills) with their start and length, the union of
their intervals (busy seconds), the slice's length, the device time by
kernel name with each csrc family summed into one row, and the longest
idle gaps labelled by the innermost benchmark span around their start.
"""

from __future__ import annotations

import contextlib
import json
import os
import tempfile
import time
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

# device kernel name fragment -> csrc entry point (the program's
# ``ops/_cuda`` sources)
KERNEL_FAMILIES = (
    ('seg_sum_', 'segment_sum'), ('cg_agg_bulk_kernel', 'cg_agg'),
    ('cg_gagg_kernel', 'cg_gagg'), ('cg_gmulti_kernel<1>', 'cg_multi'),
    ('cg_gmulti_kernel<2>', 'cg_gmulti'), ('cg_quad_kernel', 'cg_quad'))
DEVICE_CATS = ('kernel', 'gpu_memcpy', 'gpu_memset')
WINDOW_SPAN = 'bench.trace_window'


def kernel_family(name: str) -> Optional[str]:
    return next((fam for part, fam in KERNEL_FAMILIES if part in name), None)


class Spans:
    """Host-clock durations of named calls: ``with spans('graph_build'):``.
    ``durations[name]`` lists seconds a call outside the traced slice,
    ``traced[name]`` inside it (the profiler slows the host)."""

    def __init__(self):
        self.durations: Dict[str, List[float]] = defaultdict(list)
        self.traced: Dict[str, List[float]] = defaultdict(list)
        self.tracing = False

    def get(self, name: str) -> List[float]:
        """The untraced durations of ``name``, else the traced ones."""
        return self.durations.get(name) or self.traced.get(name) or []

    def clear(self):
        self.durations.clear()
        self.traced.clear()

    @contextlib.contextmanager
    def __call__(self, name: str):
        if self.tracing:
            from torch.profiler import record_function

            with record_function(f'bench.{name}'):
                t0 = time.perf_counter()
                try:
                    yield
                finally:
                    self.traced[name].append(time.perf_counter() - t0)
        else:
            t0 = time.perf_counter()
            try:
                yield
            finally:
                self.durations[name].append(time.perf_counter() - t0)

    def wrap(self, obj, attr: str, name: str):
        """Replace ``obj.attr`` (a bound method of an instance the
        benchmark built) by one that runs inside span ``name``."""
        fn = getattr(obj, attr)

        def spanned(*args, **kwargs):
            with self(name):
                return fn(*args, **kwargs)

        setattr(obj, attr, spanned)


class DeviceTrace:
    """torch.profiler over one slice: ``start()``, the work, ``stop()``
    (which synchronises), then, after the window, ``summary()``."""

    def __init__(self, spans: Spans):
        self.spans = spans
        self.prof = None
        self._window = None
        self.result: Optional[Dict] = None

    def prime(self):
        """Start and stop the profiler once on nothing: its first start
        initialises the tracing library (seconds), which the slice must
        not pay."""
        self.start()
        self.stop()
        self.prof = None

    def start(self):
        import torch
        from torch.profiler import ProfilerActivity, profile, record_function

        torch.cuda.synchronize()
        self.prof = profile(activities=[ProfilerActivity.CPU,
                                        ProfilerActivity.CUDA])
        self.prof.__enter__()
        self.spans.tracing = True
        self._window = record_function(WINDOW_SPAN)
        self._window.__enter__()

    def stop(self):
        import torch

        torch.cuda.synchronize()
        self._window.__exit__(None, None, None)
        self.spans.tracing = False
        self.prof.__exit__(None, None, None)
        self.t_stopped = time.perf_counter()

    def summary(self) -> Optional[Dict]:
        """The slice's reduction (read once the window has closed)."""
        if self.result is None and self.prof is not None:
            fd, path = tempfile.mkstemp(suffix='.json')
            os.close(fd)
            try:
                self.prof.export_chrome_trace(path)
                with open(path) as f:
                    events = json.load(f)
            finally:
                os.unlink(path)
            self.prof = None
            self.result = reduce_trace(events.get('traceEvents', events))
        return self.result


def _union_seconds(iv: List[Tuple[float, float]]) -> float:
    busy, end = 0.0, None
    for s, e in sorted(iv):
        if end is None or s > end:
            busy += e - s
            end = e
        elif e > end:
            busy += e - end
            end = e
    return busy * 1e-6


def reduce_trace(events) -> Optional[Dict]:
    """The slice's device events, busy and window seconds, ops by name
    and the idle gaps, from a chrome trace's events (times in us)."""
    window = [e for e in events if e.get('name') == WINDOW_SPAN
              and e.get('ph') == 'X' and e.get('cat') != 'gpu_user_annotation']
    if not window:
        return None
    w0 = float(window[0]['ts'])
    w1 = w0 + float(window[0]['dur'])
    dev = []
    for e in events:
        if e.get('ph') != 'X' or e.get('cat') not in DEVICE_CATS:
            continue
        s = max(float(e['ts']), w0)
        t = min(float(e['ts']) + float(e.get('dur', 0.0)), w1)
        if t > s:
            dev.append((s, t, e.get('name', '?'), e.get('cat')))
    if not dev:
        return None
    by_name: Dict[str, List[float]] = defaultdict(lambda: [0, 0.0])
    for s, t, name, _ in dev:
        key = kernel_family(name) or name
        by_name[key][0] += 1
        by_name[key][1] += (t - s) * 1e-6
    spans = sorted((float(e['ts']), float(e['ts']) + float(e['dur']),
                    e['name'][len('bench.'):])
                   for e in events
                   if e.get('ph') == 'X' and e.get('cat') == 'user_annotation'
                   and str(e.get('name', '')).startswith('bench.')
                   and e['name'] != WINDOW_SPAN)
    gaps = []
    end = w0
    for s, t, _, _ in sorted(dev):
        if s > end:
            gaps.append((end, s))
        end = max(end, t)
    if w1 > end:
        gaps.append((end, w1))
    labelled: Dict[str, float] = defaultdict(float)
    for g0, g1 in gaps:
        inner = [sp for sp in spans if sp[0] <= g0 < sp[1]]
        label = (min(inner, key=lambda sp: sp[1] - sp[0])[2] if inner
                 else 'outside any span')
        labelled[label] += (g1 - g0) * 1e-6
    csrc = {name: (c, s) for name, (c, s) in by_name.items()
            if name in dict((f, f) for _, f in KERNEL_FAMILIES)}
    return {
        'window_s': (w1 - w0) * 1e-6,
        'busy_s': _union_seconds([(s, t) for s, t, _, _ in dev]),
        'n_device_ops': sum(1 for d in dev if d[3] == 'kernel'),
        'ops_by_name': {k: (c, s) for k, (c, s) in by_name.items()},
        'csrc': csrc,
        'idle_by_span': dict(labelled),
    }


def breakdown(summary: Dict, top: int = 10, width: int = 96) -> Dict:
    """The device ops that took most time (names cut to ``width``
    letters) and the idle seconds by host span, ``top`` of each."""
    ops = sorted(summary['ops_by_name'].items(), key=lambda kv: -kv[1][1])
    gaps = sorted(summary['idle_by_span'].items(), key=lambda kv: -kv[1])
    return {'device_ops': [[k[:width], v[1]] for k, v in ops[:top]],
            'idle_gaps': [[k, v] for k, v in gaps[:top]]}
