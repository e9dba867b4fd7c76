"""Traffic kind ``md``: NVE molecular dynamics through
``VelocityVerlet.run_device``.

Parameters: ``source_file`` / ``source_atoms`` / ``source_index`` (the
structure: the same for every seed, so a seed changes the velocities and
not the work), ``replicate`` ([nx, ny, nz]), ``temperature_K``
(Maxwell-Boltzmann velocities from the seed), ``dt_fs``, ``skin``,
``seg_steps``, ``warm_steps`` (set-up's steps, which also give the rate
that sizes the window), ``check_steps`` (trajectory steps the reference recomputes),
``reference_chunk`` (edges a slice in the reference's convolutions),
``trace_seconds``.

Set-up builds the program's ``Calculator`` and ``VelocityVerlet`` and
runs ``warm_steps`` steps in two calls.  The window is one call of
``run_device`` with as many steps as the set-up's rate fits into
``--seconds`` (rebuilds and all, as a user's run).  Each force
evaluation's positions, forces and energy are kept by reference (no
copy, no synchronisation) through a wrapper of the instance's
``_device_forces``.

``correct``: at steps drawn from the seed, the reference computes the
forces and energy at the program's positions x_k from its own neighbor
list within the cutoff, and compares them, the next position by the
velocity-Verlet relation x_{k+1} = 2 x_k - x_{k-1} + dt^2 a(x_k), and the
kinetic energy the program reported after step k.
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
from benchmark.reference.md import gaps, reference_step
from benchmark.reference.model import Reference


class Generator:
    def __init__(self, ctx):
        self.ctx = ctx
        self.t = ctx.traffic
        self.device = ctx.device
        self.census = None
        self.tracer = None
        self._picked = None
        self.untraced = None

    def setup(self):
        from sevennet_finetuning_tpu_torch.md import VelocityVerlet

        ctx, t = self.ctx, self.t
        if self.device.type == 'cuda':
            program.build_kernels(program.MODEL_SOURCES)
        rng = np.random.default_rng(ctx.seed)
        src = [s for s in inputs.read_extxyz(ctx.root / t['source_file'])
               if len(s['numbers']) == int(t['source_atoms'])]
        self.structure = inputs.replicate(src[int(t['source_index'])],
                                          t['replicate'])
        self.cfg, self.params = program.weights(ctx.config, ctx.root,
                                                ctx.seed, self.device)
        self.calc = program.calculator(self.cfg, self.params, self.device)
        self.vv = VelocityVerlet(inputs.to_program(self.structure),
                                 self.calc, dt_fs=float(t['dt_fs']),
                                 skin=float(t['skin']))
        self.vv.set_temperature(float(t['temperature_K']),
                                seed=int(rng.integers(2 ** 62)))
        self.check_rng = np.random.default_rng(int(rng.integers(2 ** 62)))
        self.evals = []
        self._stop_trace_at = None
        self._wrap_forces()
        ctx.spans.wrap(self.vv, '_device_batch', 'md_rebuild')
        ctx.spans.wrap(self.vv, 'run_device', 'md_run')
        warm = int(t['warm_steps'])
        self.vv.run_device(max(1, warm // 3), seg_steps=int(t['seg_steps']))
        if self.device.type == 'cuda':
            torch.cuda.synchronize(self.device)
        t0 = time.perf_counter()
        self.vv.run_device(warm - max(1, warm // 3),
                           seg_steps=int(t['seg_steps']))
        self.vv.result.segments.clear()
        self.rate = (warm - max(1, warm // 3)) / (time.perf_counter() - t0)
        self.evals = []

    def _wrap_forces(self):
        inner = self.vv._device_forces

        spans = self.ctx.spans

        def device_forces(batch, pos):
            with spans('md_forces'):
                f, e = inner(batch, pos)
            self.evals.append((pos, f, e))
            if self._stop_trace_at is not None and \
                    len(self.evals) >= self._stop_trace_at:
                self._stop_trace_at = None
                self.tracer.stop()
                self.census.remove()
            return f, e

        self.vv._device_forces = device_forces

    def window(self, seconds: float, tracer=None) -> Dict:
        n = len(self.structure['numbers'])
        steps = max(4, int(round(self.rate * seconds)))
        k0 = len(self.vv.result.kinetic)
        if tracer is not None:
            self.tracer = tracer
            self.census = Census()
            self.census.install()
            # the initial force evaluation, then the slice's steps
            self._stop_trace_at = 1 + max(2, int(self.rate * float(
                self.t.get('trace_seconds', 2.0))))
            tracer.start()
        self.vv.run_device(steps, seg_steps=int(self.t['seg_steps']))
        t_end = time.perf_counter()
        traced = 0
        if tracer is not None:
            if self._stop_trace_at is not None:
                self._stop_trace_at = None
                tracer.stop()
                self.census.remove()
                traced = steps
            else:
                traced = max(2, int(self.rate * float(
                    self.t.get('trace_seconds', 2.0))))
        self.kinetic = list(self.vv.result.kinetic[k0:])
        self.segments = list(self.vv.result.segments)
        self.stats = {'attempted': steps, 'failed': 0, 'units': steps,
                      'trace_units': traced, 'atom_steps': n * steps,
                      'segments': list(self.segments)}
        if tracer is not None and traced < steps:
            # the steps after the traced slice, which the profiler slows
            self.untraced = (steps - traced, t_end - tracer.t_stopped)
        return self.stats

    def end_to_end(self, rec) -> Dict[str, float]:
        return {'md_atom_steps_per_s':
                rec['stats']['atom_steps'] / rec['window_s']}

    def memory_peak(self) -> int:
        return torch.cuda.max_memory_allocated(self.device)

    def kernel_bounds(self):
        return self.census.bound_seconds() if self.census else None

    def release(self):
        # the window's evaluations: the initial one, then one a step
        n = len(self.structure['numbers'])
        self.traj = [(p[:n].cpu().numpy(), f[:n].cpu().numpy(), float(e))
                     for p, f, e in self.evals]
        self.evals = []
        self.vv = self.calc = None
        gc.collect()
        if self.device.type == 'cuda':
            torch.cuda.empty_cache()

    def flops(self, ref_device) -> int:
        """The window's work: 3 forward passes a step over the edges
        within the cutoff, counted at a few positions of the trajectory
        and taken as their mean."""
        counter = FlopCounter(self.cfg)
        cut = float(self.cfg['cutoff'])
        picks = np.linspace(1, len(self.traj) - 1, 4).astype(int)
        edges = [ref_graph.edge_counts(
            [dict(self.structure, pos=self.traj[i][0])], cut, ref_device)[0]
            for i in picks]
        n = len(self.structure['numbers'])
        return FORCE_PASSES * counter.forward(float(np.mean(edges)), n) \
            * (len(self.traj) - 1)

    def _steps(self):
        """Trajectory indices k (x_{k-1}, x_k, x_{k+1} all in the window;
        k = 1 is the first step's position) drawn from the seed, with the
        last in it."""
        if self._picked is None:
            last = len(self.traj) - 2
            n = min(int(self.t['check_steps']), last)
            pick = self.check_rng.choice(np.arange(1, last), max(0, n - 1),
                                         replace=False) if last > 1 else []
            self._picked = sorted({last, *(int(k) for k in pick)})
        return self._picked

    def _masses(self):
        return np.array([inputs.MASSES[s] for s in self.structure['symbols']])

    def _reference_steps(self, ref):
        dt = float(self.t['dt_fs'])
        return {k: reference_step(ref, self.structure, self.cfg['_type_map'],
                                  self._masses(), dt, self.traj[k - 1][0],
                                  self.traj[k][0])
                for k in self._steps()}

    @staticmethod
    def _worst(pairs):
        out = {}
        for got, want in pairs:
            for name, v in gaps(got, want).items():
                out[name] = max(out.get(name, 0.0), v)
        return out

    def _reference(self):
        return Reference(self.cfg, self.params, self.device,
                         chunk=self.t.get('reference_chunk'))

    def check(self):
        self.stats['flops'] = self.flops(self.device)
        if self.untraced is not None:
            steps, secs = self.untraced
            self.stats['flops_untraced'] = \
                self.stats['flops'] * steps / self.stats['units']
            self.stats['seconds_untraced'] = secs
        want = self._reference_steps(self._reference())
        # the program's energy and forces at x_k, its next position and
        # the kinetic energy it reported after step k
        got = {k: (self.traj[k][2], self.traj[k][1], self.traj[k + 1][0],
                   self.kinetic[k - 1]) for k in want}
        return judge(self.ctx, self._worst((got[k], want[k]) for k in want))

    def control(self):
        """The reference at TF32 in the program's place, at the same
        positions: its energy, forces, next position and kinetic energy
        against the float32 reference's."""
        ref = self._reference()
        want = self._reference_steps(ref)
        prev = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.backends.cudnn.allow_tf32 = True
        try:
            low = self._reference_steps(ref)
        finally:
            torch.backends.cuda.matmul.allow_tf32 = prev
            torch.backends.cudnn.allow_tf32 = prev
        return self._worst((low[k][:4], want[k]) for k in want)
