"""Traffic kind ``serve_gaunt``: the ``serve`` traffic (one synchronous
client, closed; the same parameters) on a 'gaunt' configuration.

It is ``serve.Generator`` with three parts replaced, each for the length
of the call that uses it: the weights (``reference/gaunt.init_weights``,
the port's names, from the seed), the reference that ``check`` and
``control`` recompute requests with (``reference/gaunt.GauntReference``)
and the FLOP count (``count/gaunt.GauntWork``).

With ``--trace 1`` the program's recorder is on for the traced slice
(``program_spans.SliceRecorder``), and the slice's reduction gains
``gaunt``: the device seconds launched inside the program's ``gaunt.*``
spans and their backward (``fwd_s``, ``bwd_s``), of the whole slice
(``all_s``), the Gaunt stage's byte floor of the traced requests over
3.35 TB/s (``floor_s``), and the program's counters (``counters``).  The
parent of a program without those spans gives no ``gaunt`` entry.
"""

from __future__ import annotations

import contextlib

from benchmark import program, program_spans
from benchmark.count.bounds import HBM_BYTES_PER_S
from benchmark.count.gaunt import GauntWork
from benchmark.generators import serve
from benchmark.reference import gaunt as ref_gaunt
from benchmark.reference import graph as ref_graph


@contextlib.contextmanager
def swapped(obj, name, value):
    """``obj.name`` is ``value`` inside the block."""
    keep = getattr(obj, name)
    setattr(obj, name, value)
    try:
        yield
    finally:
        setattr(obj, name, keep)


def gaunt_weights(config_file, root, seed, device):
    cfg = program.model_config(config_file)
    return cfg, ref_gaunt.init_weights(cfg, seed, device)


class Generator(serve.Generator):
    slice = None

    def setup(self):
        with swapped(program, 'weights', gaunt_weights):
            super().setup()

    def window(self, seconds, tracer=None):
        if tracer is not None:
            self.slice = program_spans.SliceRecorder(tracer)
        return super().window(seconds, tracer)

    def check(self):
        with swapped(serve, 'Reference', ref_gaunt.GauntReference), \
                swapped(serve, 'FlopCounter', GauntWork):
            return super().check()

    def control(self):
        with swapped(serve, 'Reference', ref_gaunt.GauntReference):
            return super().control()

    def trace_summary(self, tracer):
        doc, summary = program_spans.export(tracer)
        if summary is None or self.slice is None:
            return summary
        got = program_spans.launched_within(doc, self.slice.events, 'gaunt.')
        if got is not None:
            traced = [self.pool[d[0]] for d in
                      self.done[:self.stats['trace_units']]]
            work = GauntWork(self.cfg)
            edges = ref_graph.edge_counts(traced, float(self.cfg['cutoff']),
                                          self.device)
            parts = (0, 1) if got['bwd_s'] > 0 else (0,)
            got['floor_s'] = sum(
                work.stage_bytes(e, len(s['numbers']), p)
                for e, s in zip(edges, traced) for p in parts
            ) / HBM_BYTES_PER_S
            got['counters'] = self.slice.counters
            summary['gaunt'] = got
        return summary
