"""Traffic kind ``serve``: single-point requests from one synchronous
client (an ASE relaxation or a screening loop), closed.

Parameters: ``source_file`` (extxyz), ``source_atoms`` (the size of the
structures drawn), ``pool`` ({replication 'nx,ny,nz': count}: the same
sizes for every seed), ``rattle`` (A), ``check_requests`` (how many
finished requests the reference recomputes).

Set-up makes the pool (the first structures of the size, replicated as
``pool`` says, the same for every seed; rattled by a Gaussian from the
seed), builds the program's ``Calculator`` and serves
each pool structure once, which warms every shape.  The window serves the
pool in orders drawn from the seed until ``--seconds`` have passed; a
request is timed from the call of ``Calculator.calculate`` until its numpy
results are back.

``correct``: after the window, a sample of finished requests drawn from
the seed, with the largest structures in it, is recomputed by the
reference; the numbers are the worst relative gaps of the energy, the
forces (max |dF| / max |F|) and the stress.
"""

from __future__ import annotations

import gc
import time
from typing import Dict

import numpy as np
import torch

from benchmark import inputs, program
from benchmark.count.bounds import Census
from benchmark.count.flops import FORCE_PASSES, FlopCounter
from benchmark.judge import judge
from benchmark.reference import graph as ref_graph
from benchmark.reference.model import Reference


class Generator:
    def __init__(self, ctx):
        self.ctx = ctx
        self.t = ctx.traffic
        self.device = ctx.device
        self.census = None

    def setup(self):
        ctx, t = self.ctx, self.t
        if self.device.type == 'cuda':
            program.build_kernels(program.MODEL_SOURCES)
        rng = np.random.default_rng(ctx.seed)
        src = [s for s in inputs.read_extxyz(ctx.root / t['source_file'])
               if len(s['numbers']) == int(t['source_atoms'])]
        # the same structures and replications for every seed: the seed
        # rattles them and orders the requests
        reps = [tuple(int(v) for v in k.split(','))
                for k, n in t['pool'].items() for _ in range(int(n))]
        self.pool = [inputs.rattle(inputs.replicate(s, r), t['rattle'], rng)
                     for s, r in zip(src, reps)]
        self.order_rng = np.random.default_rng(int(rng.integers(2 ** 62)))
        self.check_rng = np.random.default_rng(int(rng.integers(2 ** 62)))
        self.cfg, self.params = program.weights(ctx.config, ctx.root,
                                                ctx.seed, self.device)
        self.calc = program.calculator(self.cfg, self.params, self.device)
        ctx.spans.wrap(self.calc, 'batch', 'graph_build')
        self.structs = [inputs.to_program(s) for s in self.pool]
        for s in self.structs:
            self.calc.calculate(s)
        self.done = []            # (pool index, seconds, result)

    def window(self, seconds: float, tracer=None) -> Dict:
        trace_s = float(self.t.get('trace_seconds', 2.0))
        order = []
        traced = 0
        if tracer is not None:
            self.census = Census()
            self.census.install()
            tracer.start()
        t0 = time.perf_counter()
        t_end = t0 + seconds
        while True:
            if not order:
                order = list(self.order_rng.permutation(len(self.pool)))
            i = int(order.pop())
            ts = time.perf_counter()
            with self.ctx.spans('serve_request'):
                res = self.calc.calculate(self.structs[i])
            now = time.perf_counter()
            self.done.append((i, now - ts, res))
            if tracer is not None and self.census is not None and \
                    now - t0 >= trace_s:
                tracer.stop()
                self.census.remove()
                traced = len(self.done)
                tracer_stop = tracer.t_stopped
                tracer = None
            if now >= t_end:
                break
        if tracer is not None:
            tracer.stop()
            self.census.remove()
            traced = len(self.done)
        self.untraced = (traced, time.perf_counter() - tracer_stop) \
            if traced and traced < len(self.done) else None
        lat = np.array([d[1] for d in self.done])
        self.stats = {'attempted': len(self.done), 'failed': 0,
                      'units': len(self.done), 'trace_units': traced,
                      'p50_ms': float(np.percentile(lat, 50) * 1e3),
                      'p95_ms': float(np.percentile(lat, 95) * 1e3)}
        return self.stats

    def end_to_end(self, rec) -> Dict[str, float]:
        return {'serve_p95_ms': rec['stats']['p95_ms']}

    def memory_peak(self) -> int:
        return torch.cuda.max_memory_allocated(self.device)

    def kernel_bounds(self):
        return self.census.bound_seconds() if self.census else None

    def release(self):
        self.calc = None
        gc.collect()
        if self.device.type == 'cuda':
            torch.cuda.empty_cache()

    def _sample(self):
        """Finished requests to recompute: the largest structure's last
        request, then others drawn from the seed."""
        n = int(self.t['check_requests'])
        size = [len(self.pool[d[0]]['numbers']) for d in self.done]
        biggest = max(range(len(self.done)), key=lambda k: (size[k], k))
        rest = [k for k in range(len(self.done)) if k != biggest]
        pick = self.check_rng.choice(rest, min(n - 1, len(rest)),
                                     replace=False)
        return [biggest] + sorted(int(k) for k in pick)

    def _reference(self, ref, k):
        s = self.pool[self.done[k][0]]
        g = ref_graph.batch_graphs([s], ref.spec.cutoff,
                                   self.cfg['_type_map'], self.device)
        e, f, st = ref.evaluate(g)
        return float(e[0]), f.double().cpu().numpy(), \
            st[0].double().cpu().numpy()

    @staticmethod
    def _gaps(got, want) -> Dict[str, float]:
        (e, f, s), (re, rf, rs) = got, want
        return {'energy': abs(e - re) / abs(re),
                'forces': float(np.abs(f - rf).max() / np.abs(rf).max()),
                'stress': float(np.abs(s - rs).max() / np.abs(rs).max())}

    def _worst(self, pairs):
        out = {}
        for got, want in pairs:
            for k, v in self._gaps(got, want).items():
                out[k] = max(out.get(k, 0.0), v)
        return out

    def _flops(self) -> int:
        """The window's work: 3 forward passes a request at the pool
        structure's edges within the cutoff."""
        counter = FlopCounter(self.cfg)
        edges = ref_graph.edge_counts(self.pool, float(self.cfg['cutoff']),
                                      self.device)
        work = [FORCE_PASSES * counter.forward(e, len(s['numbers']))
                for e, s in zip(edges, self.pool)]
        if self.untraced is not None:
            # the work after the traced slice, which the profiler slows
            first, secs = self.untraced
            self.stats['flops_untraced'] = sum(work[d[0]]
                                               for d in self.done[first:])
            self.stats['seconds_untraced'] = secs
        return sum(work[d[0]] for d in self.done)

    def check(self):
        self.stats['flops'] = self._flops()
        ref = Reference(self.cfg, self.params, self.device,
                        chunk=self.t.get('reference_chunk'))
        pairs = []
        for k in self._sample():
            res = self.done[k][2]
            pairs.append(((res['energy'], np.asarray(res['forces'],
                                                     np.float64),
                           np.asarray(res['stress'], np.float64)),
                          self._reference(ref, k)))
        return judge(self.ctx, self._worst(pairs))

    def control(self):
        ref = Reference(self.cfg, self.params, self.device,
                        chunk=self.t.get('reference_chunk'))
        sample = self._sample()
        want = [self._reference(ref, k) for k in sample]
        prev = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.backends.cudnn.allow_tf32 = True
        try:
            got = [self._reference(ref, k) for k in sample]
        finally:
            torch.backends.cuda.matmul.allow_tf32 = prev
            torch.backends.cudnn.allow_tf32 = prev
        return self._worst(zip(got, want))
