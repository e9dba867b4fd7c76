"""Traffic kind ``serve_eqv2``: the ``serve`` traffic (one synchronous
client, closed; the same parameters) on an 'equiformer_v2' configuration.

It is ``serve.Generator`` with its parts replaced, each for the length of
the call that uses it: the weights (``reference/equiformer_v2.
init_weights``, the port's names, from the seed), the reference that
``check`` and ``control`` recompute requests with
(``reference/equiformer_v2.EqV2Reference`` on its own nearest-neighbour
graph, ``capped_graph``) and the FLOP count (``count/eqv2.EqV2Work``: a
force evaluation as ``flops.FORCE_PASSES`` forwards at the capped edges).
``correct`` compares what ``serve`` compares, the energy's gap taken over
the reference's sum of |per-atom energy| (``_gaps``).

The window's stats add ``by_size``: the requests, median and 95th
percentile (ms) of each structure size.  With ``--trace 1`` the
program's recorder is on for the traced slice
(``program_spans.SliceRecorder``), and the slice's reduction gains
``eqv2``: the device seconds launched inside the program's ``eqv2.*``
spans and their backward (``fwd_s``, ``bwd_s``), inside ``eqv2.attn``
alone (``attn_s``), of the whole slice (``all_s``), the stage's floor
for the traced requests (``floor_s``) and the program's counters.  A
program without those spans gives no ``eqv2`` entry.
"""

from __future__ import annotations

import contextlib
from typing import Dict

import numpy as np

from benchmark import program, program_spans
from benchmark.count.eqv2 import EqV2Work
from benchmark.generators import serve
from benchmark.reference import equiformer_v2 as ref_eqv2


@contextlib.contextmanager
def swapped(obj, name, value):
    """``obj.name`` is ``value`` inside the block."""
    keep = getattr(obj, name)
    setattr(obj, name, value)
    try:
        yield
    finally:
        setattr(obj, name, keep)


def eqv2_weights(config_file, root, seed, device):
    cfg = program.model_config(config_file)
    return cfg, ref_eqv2.init_weights(cfg, seed, device)


class Generator(serve.Generator):
    slice = None
    edges = None

    def setup(self):
        with swapped(program, 'weights', eqv2_weights):
            super().setup()

    def window(self, seconds, tracer=None):
        if tracer is not None:
            self.slice = program_spans.SliceRecorder(tracer)
        stats = super().window(seconds, tracer)
        # the tail of each request size, logged with the window's stats
        by_size = {}
        for i, secs, _ in self.done:
            by_size.setdefault(len(self.pool[i]['numbers']), []).append(secs)
        stats['by_size'] = {
            n: [len(v), round(float(np.percentile(v, 50)) * 1e3, 3),
                round(float(np.percentile(v, 95)) * 1e3, 3)]
            for n, v in sorted(by_size.items())}
        return stats

    def _graph(self, s):
        return ref_eqv2.capped_graph(s, float(self.cfg['cutoff']),
                                     self.cfg.get('max_neighbors'),
                                     self.device)

    def _edges(self):
        """The capped edges of each pool structure (once)."""
        if self.edges is None:
            self.edges = [int(self._graph(s)['src'].shape[0])
                          for s in self.pool]
        return self.edges

    def _reference(self, ref, k):
        """(energy, forces, stress, the sum of |per-atom energy|)."""
        e, f, st = ref.evaluate(self._graph(self.pool[self.done[k][0]]))
        return float(e[0]), f.double().cpu().numpy(), \
            st[0].double().cpu().numpy(), float(ref.energy_scale[0])

    @staticmethod
    def _gaps(got, want) -> Dict[str, float]:
        """``serve``'s gaps, the energy's over the reference's sum of
        |per-atom energy| and not over |E|: with random weights a total
        energy is a sum of signs that can lie near zero, where |E| would
        make a sound answer's round-off look large."""
        (e, f, s), (re, rf, rs, scale) = got[:3], want
        return {'energy': abs(e - re) / scale,
                'forces': float(np.abs(f - rf).max() / np.abs(rf).max()),
                'stress': float(np.abs(s - rs).max() / np.abs(rs).max())}

    def _flops(self) -> float:
        """The window's work: one force evaluation a request."""
        work = EqV2Work(self.cfg)
        per = [work.force_flops(e, len(s['numbers']))
               for e, s in zip(self._edges(), self.pool)]
        if self.untraced is not None:
            first, secs = self.untraced
            self.stats['flops_untraced'] = float(sum(
                per[d[0]] for d in self.done[first:]))
            self.stats['seconds_untraced'] = secs
        return float(sum(per[d[0]] for d in self.done))

    def check(self):
        with swapped(serve, 'Reference', ref_eqv2.EqV2Reference):
            return super().check()

    def control(self):
        with swapped(serve, 'Reference', ref_eqv2.EqV2Reference):
            return super().control()

    def trace_summary(self, tracer):
        doc, summary = program_spans.export(tracer)
        if summary is None or self.slice is None:
            return summary
        got = program_spans.launched_within(doc, self.slice.events, 'eqv2.')
        if got is not None:
            attn = program_spans.launched_within(doc, self.slice.events,
                                                 'eqv2.attn')
            got['attn_s'] = (attn['fwd_s'] + attn['bwd_s']) if attn else 0.0
            work = EqV2Work(self.cfg)
            parts = (0, 1) if got['bwd_s'] > 0 else (0,)
            edges = self._edges()
            got['floor_s'] = float(np.sum([
                work.floor_seconds(edges[d[0]],
                                   len(self.pool[d[0]]['numbers']), p)
                for d in self.done[:self.stats['trace_units']]
                for p in parts]))
            got['counters'] = self.slice.counters
            summary['eqv2'] = got
        return summary
