"""In-memory spans and counters of the port, on the profiler's clock.

Off by default; ``enable()`` turns recording on for the process.  The
instrumented boundaries (one thread: the caller's):

- ``Calculator.calculate``: ``calc.request`` (a unit; ``n_atoms``,
  ``edge_capacity``) around ``graph.build`` (``Calculator.batch``; on a
  CUDA calculator the counter ``graph.build.device``, one a request built
  on the card, and ``host_syncs``, the read of its edge count), the
  ``model.*`` spans and ``calc.fetch.wait`` (the reads of the results);
- ``apply_model``: ``model.forward``, ``model.grad`` (the force
  backward), ``model.forces_stress`` (the scatters);
- ``VelocityVerlet.run_device``: ``md.segment`` around ``md.step`` (a
  unit; ``skin_trip`` on the attempt that stops a segment; ``vv_segment``,
  which ``run_device_halo``'s steps run too) with
  ``md.skin.wait``, ``md.integrate`` and the ``model.*`` spans inside,
  ``md.fetch.wait`` (the segment's packed read, and the velocities at the
  end) and ``md.rebuild`` (``_device_batch``: ``graph.build`` on the
  host; on a CUDA calculator ``md.rebuild.wait``, the read of the card
  build's edge count, and the counters ``md.rebuild.device``, one a
  rebuild on the card, and ``md.rebuild.grow``, one a growth of its edge
  capacity, the first included);
- ``ops/gaunt.py``: ``gaunt.conv`` around each Gaunt convolution
  (``convolve`` over ``gaunt_family``; ``edges``, the edges contracted
  through the coupling layout, ``mul``, ``M``) and around
  ``gaunt_conv_fft`` with the counter ``gaunt.grid_bytes``, the bytes of
  its per-edge sample grids (E x mul x M^2 elements); ``gaunt.pb`` around
  ``apply_gaunt_pb`` (``nodes``, ``correlation``);
- ``model/equiformer_v2.py``: ``eqv2.edge_embed`` (the edge frames, the
  Gaussians and the edge-degree embedding; ``edges``), ``eqv2.attn``
  around each block's graph attention (``edges``, ``block``), ``eqv2.ffn``
  around each block's grid FFN (``nodes``, ``block``) and ``eqv2.head``
  (``nodes``); a configuration with ``max_neighbors`` adds ``graph.cap``
  inside ``graph.build`` (the nearest-neighbour cap, host or card) with
  the counters ``graph.cap.candidates`` (pairs within the cutoff) and
  ``graph.cap.edges`` (kept);
- ``parallel/halo.py``: ``halo.swap`` around each ``DistTransport.swap``
  (``stage``, ``rows``; a backward's reverse swap too, from autograd's
  thread) with the counter ``halo.swap_bytes``, the bytes the rank sends.

Every explicit device-to-host read sits in a span whose name ends in
``.wait`` and adds one to the counter ``host_syncs``.

A record is ``(name, start_ns, end_ns, span_id, parent_id, unit_id,
attrs)`` on ``time.perf_counter_ns``; a unit's id is the id of the span
that opened it (0 outside any unit).  ``chrome_events()`` gives the
records as chrome-trace ``ph: 'X'`` events in Unix microseconds, through
the (``time.time_ns``, ``perf_counter_ns``) pair taken by ``enable()``:
a ``torch.profiler`` chrome trace's ``ts`` plus its
``baseTimeNanoseconds / 1000`` is on the same clock.  At most ``CAP``
records are kept; past it recording stops and ``dropped()`` counts the
spans lost.
"""

from __future__ import annotations

import json
import os
import time
from collections import Counter
from typing import Dict, List, Optional, Tuple

CAP = 1_000_000
Record = Tuple[str, int, int, int, int, int, Optional[Dict]]


class _Off:
    """The span of a recorder that is off: one shared object that does
    nothing."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **attrs):
        pass


OFF = _Off()


class _State:
    """What the recorder holds between two ``reset()`` calls."""

    def __init__(self):
        self.records: List[Record] = []
        self.counters: Counter = Counter()
        self.stack: List[int] = []
        self.unit = 0
        self.next_id = 1
        self.dropped = 0
        self.clock = (time.time_ns(), time.perf_counter_ns())


_on = False
_state = _State()


class _Span:
    __slots__ = ('state', 'name', 'attrs', 'opens_unit', 'id', 'parent',
                 'unit', 'outer_unit', 't0')

    def __init__(self, name: str, opens_unit: bool, attrs: Dict):
        self.state = _state
        self.name = name
        self.opens_unit = opens_unit
        self.attrs = attrs or None

    def set(self, **attrs):
        """Add attributes once the span is open (known only inside it)."""
        self.attrs = {**(self.attrs or {}), **attrs}

    def __enter__(self):
        st = self.state
        self.parent = st.stack[-1] if st.stack else 0
        self.id = st.next_id
        st.next_id += 1
        self.outer_unit = st.unit
        if self.opens_unit:
            st.unit = self.id
        self.unit = st.unit
        st.stack.append(self.id)
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter_ns()
        st = self.state
        st.stack.pop()
        st.unit = self.outer_unit
        if len(st.records) < CAP:
            st.records.append((self.name, self.t0, t1, self.id, self.parent,
                               self.unit, self.attrs))
        else:
            st.dropped += 1
        return False


def enable():
    """Record from now on (records and counters kept until ``reset``)."""
    global _on
    _state.clock = (time.time_ns(), time.perf_counter_ns())
    _on = True


def disable():
    global _on
    _on = False


def reset():
    """Drop every record, counter and open span."""
    global _state
    _state = _State()


def span(name: str, unit: bool = False, **attrs):
    """A context manager timing ``name``; ``unit=True`` opens a unit of
    work (a request, an MD step) that the spans inside it belong to.
    While the recorder is off, the one shared no-op ``OFF``."""
    if not _on:
        return OFF
    return _Span(name, unit, attrs)


def count(name: str, n: int = 1):
    if _on:
        _state.counters[name] += n


def records() -> List[Record]:
    return list(_state.records)


def counters() -> Counter:
    return Counter(_state.counters)


def dropped() -> int:
    return _state.dropped


def chrome_events() -> List[Dict]:
    """The records as chrome-trace complete events, ``ts`` and ``dur`` in
    microseconds, ``ts`` since the Unix epoch."""
    wall0, perf0 = _state.clock
    pid = os.getpid()
    return [{'ph': 'X', 'cat': 'program', 'name': name, 'pid': pid,
             'tid': 'program', 'ts': (wall0 + t0 - perf0) / 1e3,
             'dur': (t1 - t0) / 1e3,
             'args': {'id': sid, 'parent': parent, 'unit': unit,
                      **(attrs or {})}}
            for name, t0, t1, sid, parent, unit, attrs in _state.records]


def export_chrome(path: str):
    """Write ``chrome_events()``, the counters and the dropped count as a
    chrome trace.  To lay it on a ``torch.profiler`` trace, subtract that
    trace's ``baseTimeNanoseconds / 1000`` from each ``ts`` and append the
    events to its ``traceEvents``."""
    with open(path, 'w') as f:
        json.dump({'traceEvents': chrome_events(),
                   'counters': dict(_state.counters),
                   'dropped': _state.dropped}, f)
