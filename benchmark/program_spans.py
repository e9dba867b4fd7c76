"""The program's own spans (``sevennet_finetuning_tpu_torch.tracing``) laid
on a traced slice's device events: the device time of the kernels, copies
and fills launched inside the spans of a given name.

``SliceRecorder`` turns the program's recorder on when the slice's
profiler starts and off when it stops.  ``export`` writes the profiler's
chrome trace once and reduces it as ``DeviceTrace.summary`` does, keeping
the raw events.  ``launched_within`` attributes device events to spans:

- the forward: a device event whose launch (a ``cuda_runtime`` or
  ``cuda_driver`` call, joined to the event by its ``correlation``) lies
  inside a span, on the profiler's clock (``ts`` plus
  ``baseTimeNanoseconds / 1000`` is the recorder's Unix microseconds);
- the backward: autograd runs the backward of an op recorded inside a span
  as an ``autograd::engine::evaluate_function`` event with the op's
  ``Sequence number``; a device event launched inside one of those, on its
  thread, belongs to the span too.

Where the program has no recorder, or no span of the name, every reading
is None.
"""

from __future__ import annotations

import bisect
import json
import os
import tempfile
from typing import Dict, List, Optional, Sequence, Tuple

from .trace import DEVICE_CATS, WINDOW_SPAN, reduce_trace

LAUNCH_CATS = ('cuda_runtime', 'cuda_driver')
BACKWARD = 'autograd::engine::evaluate_function'


def recorder():
    """The program's tracing module, or None where the program has none."""
    try:
        from sevennet_finetuning_tpu_torch import tracing
    except ImportError:
        return None
    return tracing


class SliceRecorder:
    """The program's recorder on for a ``DeviceTrace``'s slice only:
    reset and enabled as the profiler starts, disabled as it stops."""

    def __init__(self, tracer):
        self.rec = recorder()
        self.events: List[Dict] = []
        self.counters: Dict[str, int] = {}
        if self.rec is None:
            return
        start, stop = tracer.start, tracer.stop

        def started():
            start()
            self.rec.reset()
            self.rec.enable()

        def stopped():
            stop()
            self.rec.disable()
            self.events = self.rec.chrome_events()
            self.counters = dict(self.rec.counters())
            self.rec.reset()

        tracer.start, tracer.stop = started, stopped


def export(tracer) -> Tuple[Optional[Dict], Optional[Dict]]:
    """(the chrome trace of the tracer's slice, its reduction); the
    tracer's ``summary()`` returns the same reduction afterwards."""
    if tracer.prof is None:
        return None, tracer.summary()
    fd, path = tempfile.mkstemp(suffix='.json')
    os.close(fd)
    try:
        tracer.prof.export_chrome_trace(path)
        with open(path) as f:
            doc = json.load(f)
    finally:
        os.unlink(path)
    tracer.prof = None
    events = doc.get('traceEvents', doc) if isinstance(doc, dict) else doc
    tracer.result = reduce_trace(events)
    return (doc if isinstance(doc, dict) else {'traceEvents': doc},
            tracer.result)


def _within(iv: List[Tuple[float, float]], starts: List[float],
            t: float) -> bool:
    k = bisect.bisect_right(starts, t) - 1
    return k >= 0 and t <= iv[k][1]


def _merged(iv) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for s, e in sorted(iv):
        if out and s <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], e))
        else:
            out.append((s, e))
    return out


def launched_within(doc: Optional[Dict], spans: Sequence[Dict],
                    prefix: str) -> Optional[Dict[str, float]]:
    """Device seconds in the slice of the events launched inside the
    program spans whose name starts with ``prefix`` (``fwd_s``), inside the
    backward of the ops recorded in them (``bwd_s``), and of every device
    event in the slice (``all_s``); ``calls`` the spans.  None where no
    span has the prefix."""
    if not doc:
        return None
    mine = [s for s in spans if str(s.get('name', '')).startswith(prefix)]
    if not mine:
        return None
    events = doc.get('traceEvents', [])
    base = float(doc.get('baseTimeNanoseconds', 0)) / 1e3
    window = [e for e in events if e.get('name') == WINDOW_SPAN
              and e.get('ph') == 'X' and e.get('cat') != 'gpu_user_annotation']
    if not window:
        return None
    w0 = float(window[0]['ts'])
    w1 = w0 + float(window[0]['dur'])
    # the spans on the profiler's own clock
    fwd = _merged((float(s['ts']) - base, float(s['ts']) + float(s['dur'])
                   - base) for s in mine)
    fwd_starts = [s for s, _ in fwd]
    seqs = set()
    for e in events:
        if e.get('ph') != 'X' or e.get('cat') != 'cpu_op':
            continue
        seq = (e.get('args') or {}).get('Sequence number')
        if seq is None or str(e.get('name', '')).startswith(BACKWARD):
            continue
        if _within(fwd, fwd_starts, float(e['ts'])):
            seqs.add(seq)
    back: Dict[object, List[Tuple[float, float]]] = {}
    for e in events:
        if e.get('ph') == 'X' and e.get('cat') == 'cpu_op' and \
                str(e.get('name', '')).startswith(BACKWARD) and \
                (e.get('args') or {}).get('Sequence number') in seqs:
            t = float(e['ts'])
            back.setdefault(e.get('tid'), []).append(
                (t, t + float(e.get('dur', 0.0))))
    back = {tid: _merged(iv) for tid, iv in back.items()}
    back_starts = {tid: [s for s, _ in iv] for tid, iv in back.items()}
    side: Dict[object, str] = {}
    for e in events:
        if e.get('ph') != 'X' or e.get('cat') not in LAUNCH_CATS:
            continue
        corr = (e.get('args') or {}).get('correlation')
        if corr is None:
            continue
        t = float(e['ts'])
        if _within(fwd, fwd_starts, t):
            side[corr] = 'fwd_s'
        elif e.get('tid') in back and _within(back[e.get('tid')],
                                               back_starts[e.get('tid')], t):
            side[corr] = 'bwd_s'
    out = {'fwd_s': 0.0, 'bwd_s': 0.0, 'all_s': 0.0,
           'calls': float(len(mine))}
    for e in events:
        if e.get('ph') != 'X' or e.get('cat') not in DEVICE_CATS:
            continue
        s = max(float(e['ts']), w0)
        t = min(float(e['ts']) + float(e.get('dur', 0.0)), w1)
        if t <= s:
            continue
        out['all_s'] += (t - s) * 1e-6
        key = side.get((e.get('args') or {}).get('correlation'))
        if key:
            out[key] += (t - s) * 1e-6
    return out
