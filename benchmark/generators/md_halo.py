"""Traffic kind ``md_halo``: spatially decomposed NVE molecular dynamics
through ``VelocityVerlet.run_device_halo``, one rank a card.

Parameters: those of ``md`` (``source_file`` / ``source_atoms`` /
``source_index``, ``replicate``, ``temperature_K``, ``dt_fs``, ``skin``,
``seg_steps``, ``warm_steps``, ``check_steps``, ``reference_chunk``,
``trace_seconds``), and ``ranks`` (the partitions: the port's own plan for
that many ranks), ``backend`` (``nccl``; ``gloo`` on the CPU),
``single_process`` (true: every rank's partition in the harness's
process on card 0, through ``LocalTransport``, the same arithmetic with
the rows moved by indexing),
``timeout_s`` (the bound on every wait: the process group's start and
collectives, the workers' join).

The harness's process is rank 0 on card 0.  Set-up starts the other
ranks as ``python -m benchmark.generators.md_halo <spec>`` (rank r on card
r), joins them in a process group (``tcp://127.0.0.1``, a free port), and
every rank builds the program's ``Calculator`` and ``VelocityVerlet`` from
the same seed and runs ``warm_steps`` steps in two calls; rank 0's rate
sizes the window and is broadcast.  The window is one call of
``run_device_halo`` on every rank.  Each force evaluation's positions,
forces and energy are kept by reference, with the plan they were made in,
through a wrapper of ``HaloForward.energy_forces``.  After the window the
ranks gather, to rank 0, the positions and forces of the steps the
reference checks (drawn from the seed on rank 0), their peak memory and
their ``halo.swap_bytes`` counters, then exit; a rank that does not end
within ``timeout_s`` is killed and the run fails.

``correct``: as ``md``, over the whole system: at the drawn steps the
reference computes the forces at the program's positions x_k from its own
neighbor list within the cutoff, in chunks, and compares them, the next
position by x_{k+1} = 2 x_k - x_{k-1} + dt^2 a(x_k), and the kinetic
energy the program reported after step k.

With ``--trace 1`` the program's recorder is on for the window on every
rank, and the stats gain the summed ``halo.swap_bytes``.
"""

from __future__ import annotations

import datetime
import gc
import json
import os
import socket
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from typing import Dict

import numpy as np
import torch

from benchmark import inputs, program, program_spans
from benchmark.judge import judge
from benchmark.reference.md import gaps, reference_step
from benchmark.reference.model import Reference


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(('127.0.0.1', 0))
        return s.getsockname()[1]


def _md_time_step(factor):
    """Every halo step with the time step times ``factor`` (a planted
    fault: ``fault`` in the traffic's overrides, on every rank, until the
    run's ``release``); returns the undo."""
    from sevennet_finetuning_tpu_torch.md import VelocityVerlet

    run = VelocityVerlet.run_device_halo

    def scaled(self, *a, **k):
        dt = self.dt
        self.dt = dt * factor
        try:
            return run(self, *a, **k)
        finally:
            self.dt = dt

    VelocityVerlet.run_device_halo = scaled
    return lambda: setattr(VelocityVerlet, 'run_device_halo', run)


FAULTS = {'wrong_time_step': lambda: _md_time_step(1.1),
          'positions_unchanged': lambda: _md_time_step(0.0)}


class Generator:
    def __init__(self, ctx, rank: int = 0, port: int = 0):
        self.ctx = ctx
        self.t = ctx.traffic
        self.rank = rank
        self.port = port
        self.ranks = int(self.t['ranks'])
        self.world = 1 if self.t.get('single_process') else self.ranks
        self.timeout = float(self.t.get('timeout_s', 300))
        self.device = ctx.device
        # gloo's collectives take host tensors
        self.comm = (torch.device('cpu') if self.t.get('backend') == 'gloo'
                     else self.device)
        self.procs = []
        self.tracer = None
        self._picked = None
        self._undo = [FAULTS[self.t['fault']]()] if self.t.get('fault') \
            else []

    # -- the process group ------------------------------------------------
    def _spawn(self, port: int):
        spec = {'root': str(self.ctx.root), 'bench_dir': str(
            self.ctx.bench_dir), 'cell': self.ctx.cell,
            'config': self.ctx.config, 'traffic': self.t,
            'seed': self.ctx.seed, 'device': self.device.type,
            'trace': bool(self.ctx.trace), 'port': port,
            'world': self.world}
        fd, path = tempfile.mkstemp(suffix='.json')
        with os.fdopen(fd, 'w') as f:
            json.dump(spec, f)
        env = dict(os.environ, PYTHONPATH=str(self.ctx.root))
        for r in range(1, self.world):
            self.procs.append(subprocess.Popen(
                [sys.executable, '-m', 'benchmark.generators.md_halo', path,
                 str(r)], cwd=str(self.ctx.root), env=env,
                stdout=subprocess.DEVNULL))
        self._spec_path = path

    def _join_group(self, port: int):
        import torch.distributed as dist

        if self.device.type == 'cuda':
            torch.cuda.set_device(self.device)
        dist.init_process_group(
            self.t.get('backend', 'nccl'),
            init_method=f'tcp://127.0.0.1:{port}',
            world_size=self.world, rank=self.rank,
            timeout=datetime.timedelta(seconds=self.timeout))

    def _abort(self):
        self._unpatch()
        for p in self.procs:
            if p.poll() is None:
                p.kill()
        self.procs = []

    def _join_workers(self):
        """Wait for the other ranks' processes to end (after the group's
        teardown, which every rank enters at once)."""
        deadline = time.monotonic() + self.timeout
        try:
            for p in self.procs:
                rc = p.wait(timeout=max(1.0, deadline - time.monotonic()))
                if rc != 0:
                    raise RuntimeError(f'a halo rank exited with {rc}')
        except subprocess.TimeoutExpired:
            raise RuntimeError(f'a halo rank did not end within '
                               f'{self.timeout} s') from None
        finally:
            self._abort()
            if getattr(self, '_spec_path', None):
                os.unlink(self._spec_path)
                self._spec_path = None

    def _unpatch(self):
        """Put back what this run patched in the program's classes."""
        while self._undo:
            self._undo.pop()()

    def _bcast(self, values, n: int):
        """``values`` (rank 0's; ``n`` of them) as int64 on every rank."""
        import torch.distributed as dist

        buf = torch.zeros(n, dtype=torch.int64, device=self.comm)
        if self.rank == 0:
            buf[:len(values)] = torch.as_tensor(values, dtype=torch.int64)
        if self.world > 1:
            dist.broadcast(buf, 0)
        return [int(v) for v in buf.cpu()]

    # -- set-up -----------------------------------------------------------
    def setup(self):
        try:
            self._setup()
        except BaseException:
            self._abort()
            raise

    def _setup(self):
        from sevennet_finetuning_tpu_torch.md import VelocityVerlet

        ctx, t = self.ctx, self.t
        if self.rank == 0 and self.device.type == 'cuda':
            program.build_kernels(program.MODEL_SOURCES)
        if self.world > 1:
            if self.rank == 0:
                self.port = _free_port()
                self._spawn(self.port)
            self._join_group(self.port)
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
                                 skin=float(t['skin']),
                                 halo=dict(n_dev=self.ranks))
        self.vv.set_temperature(float(t['temperature_K']),
                                seed=int(rng.integers(2 ** 62)))
        self.check_rng = np.random.default_rng(int(rng.integers(2 ** 62)))
        self.evals = []
        self._stop_trace_at = None
        self._wrap_forces()
        ctx.spans.wrap(self.vv, 'run_device_halo', 'md_run')
        warm = int(t['warm_steps'])
        seg = int(t['seg_steps'])
        self.vv.run_device_halo(max(1, warm // 3), seg_steps=seg)
        if self.device.type == 'cuda':
            torch.cuda.synchronize(self.device)
        t0 = time.perf_counter()
        self.vv.run_device_halo(warm - max(1, warm // 3), seg_steps=seg)
        self.vv.result.segments.clear()
        rate = (warm - max(1, warm // 3)) / (time.perf_counter() - t0)
        self.rate = self._bcast([int(rate * 1e6)], 1)[0] / 1e6
        self.evals = []

    def _wrap_forces(self):
        from sevennet_finetuning_tpu_torch.parallel.halo import HaloForward

        inner = HaloForward.energy_forces
        gen = self
        self._undo.append(
            lambda: setattr(HaloForward, 'energy_forces', inner))

        def energy_forces(fwd, pos, with_stress=False):
            with gen.ctx.spans('md_forces'):
                out = inner(fwd, pos, with_stress)
            gen.evals.append((fwd.plan, fwd.ranks, pos, out[1]))
            if gen._stop_trace_at is not None and \
                    len(gen.evals) >= gen._stop_trace_at:
                gen._stop_trace_at = None
                gen.tracer.stop()
            return out

        HaloForward.energy_forces = energy_forces

    # -- the window -------------------------------------------------------
    def window(self, seconds: float, tracer=None) -> Dict:
        try:
            return self._window(seconds, tracer)
        except BaseException:
            self._abort()
            raise

    def _window(self, seconds, tracer):
        rec = program_spans.recorder() if self.ctx.trace else None
        if rec is not None:
            rec.reset()
            rec.enable()
        n = len(self.structure['numbers'])
        steps = self._bcast([max(4, int(round(self.rate * seconds)))], 1)[0]
        k0 = len(self.vv.result.kinetic)
        trace_steps = max(2, int(self.rate * float(
            self.t.get('trace_seconds', 2.0))))
        if tracer is not None:
            self.tracer = tracer
            # the initial force evaluation, then the slice's steps
            self._stop_trace_at = 1 + trace_steps
            tracer.start()
        self.vv.run_device_halo(steps, seg_steps=int(self.t['seg_steps']))
        traced = 0
        if tracer is not None:
            if self._stop_trace_at is not None:
                self._stop_trace_at = None
                tracer.stop()
                traced = steps
            else:
                traced = trace_steps
        if rec is not None:
            rec.disable()
            self.program_counters = dict(rec.counters())
            rec.reset()
        self.kinetic = list(self.vv.result.kinetic[k0:])
        self.energies = list(self.vv.result.energies[k0:])
        self.segments = list(self.vv.result.segments)
        self.stats = {'attempted': steps, 'failed': 0, 'units': steps,
                      'trace_units': traced, 'atom_steps': n * steps,
                      'segments': list(self.segments)}
        return self.stats

    def end_to_end(self, rec) -> Dict[str, float]:
        return {'md_atom_steps_per_s':
                rec['stats']['atom_steps'] / rec['window_s']}

    def memory_peak(self) -> int:
        return torch.cuda.max_memory_allocated(self.device)

    def kernel_bounds(self):
        return None

    # -- after the window -------------------------------------------------
    def _steps(self):
        """Trajectory indices k (x_{k-1}, x_k, x_{k+1} all in the window)
        drawn from the seed on rank 0, with the last in it."""
        if self._picked is None:
            last = len(self.evals) - 2
            n = min(int(self.t['check_steps']), last)
            pick = self.check_rng.choice(np.arange(1, last), max(0, n - 1),
                                         replace=False) if last > 1 else []
            self._picked = sorted({last, *(int(k) for k in pick)})
        return self._picked

    def _global(self, plan, ranks, t: torch.Tensor) -> np.ndarray:
        """A plan-layout tensor [R, n_local, 3] of the held ranks as every
        rank's rows in global atom order (a collective)."""
        import torch.distributed as dist

        if self.world > 1:
            t = t.to(self.comm).contiguous()
            parts = [torch.empty_like(t) for _ in range(self.world)]
            dist.all_gather(parts, t)
            rows, held = torch.cat(parts).cpu().numpy(), range(plan.n_dev)
        else:
            rows, held = t.cpu().numpy(), ranks
        out = np.zeros((plan.n_atoms, 3), np.float32)
        for k, d in enumerate(held):
            ids = plan.owner_perm[d]
            valid = ids >= 0
            out[ids[valid]] = rows[k][valid]
        return out

    def release(self):
        try:
            self._release()
        except BaseException:
            self._abort()
            raise

    def _release(self):
        import torch.distributed as dist

        n_picks = int(self.t['check_steps'])
        picks = self._bcast(self._steps() if self.rank == 0 else [],
                            n_picks)
        picks = [k for k in picks if k > 0] if self.rank else self._steps()
        need = sorted({i for k in picks for i in (k - 1, k, k + 1)})
        self.traj = {}
        for i in need:
            plan, ranks, pos, f = self.evals[i]
            self.traj[i] = (self._global(plan, ranks, pos),
                            self._global(plan, ranks, f) if i in picks
                            else None)
        own = torch.tensor(
            [self.memory_peak() if self.device.type == 'cuda' else 0,
             int(getattr(self, 'program_counters', {}).get(
                 'halo.swap_bytes', 0))],
            dtype=torch.int64, device=self.comm)
        if self.world > 1:
            every = [torch.empty_like(own) for _ in range(self.world)]
            dist.all_gather(every, own)
        else:
            every = [own]
        every = torch.stack(every).cpu().numpy()
        self.peak_all = int(every[:, 0].max())
        if self.ctx.trace:
            self.stats['halo_swap_bytes'] = int(every[:, 1].sum())
        self.evals = []
        self._unpatch()
        self.vv = self.calc = None
        gc.collect()
        if self.device.type == 'cuda':
            torch.cuda.empty_cache()
        if self.world > 1:
            # every rank tears the group down at once: NCCL's teardown
            # waits for the peers' own
            dist.destroy_process_group()
            if self.rank == 0:
                self._join_workers()

    def _reference(self):
        return Reference(self.cfg, self.params, self.device,
                         chunk=self.t.get('reference_chunk'))

    def _reference_steps(self, ref):
        dt = float(self.t['dt_fs'])
        masses = np.array([inputs.MASSES[s]
                           for s in self.structure['symbols']])
        return {k: reference_step(ref, self.structure, self.cfg['_type_map'],
                                  masses, dt, self.traj[k - 1][0],
                                  self.traj[k][0])
                for k in self._steps()}

    @staticmethod
    def _worst(pairs):
        out = {}
        for got, want in pairs:
            for name, v in gaps(got, want).items():
                out[name] = max(out.get(name, 0.0), v)
        return out

    def check(self):
        want = self._reference_steps(self._reference())
        got = {k: (self.energies[k - 1], self.traj[k][1], self.traj[k + 1][0],
                   self.kinetic[k - 1]) for k in want}
        return judge(self.ctx, self._worst((got[k], want[k]) for k in want))

    def control(self):
        """The reference at TF32 in the program's place, at the same
        positions."""
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


def worker(spec_path: str, rank: int) -> int:
    """Rank ``rank`` of a run: the same set-up, window and gathers as rank
    0, without the harness's timing, trace or check."""
    from benchmark.harness import Context
    from benchmark.trace import Spans

    with open(spec_path) as f:
        spec = json.load(f)
    n_dev = torch.cuda.device_count() if spec['device'] == 'cuda' else 1
    device = (torch.device('cuda', rank % n_dev) if spec['device'] == 'cuda'
              else torch.device('cpu'))
    ctx = Context(spec['cell'], spec['config'], spec['traffic'], spec['seed'],
                  device, spec['world'], Spans(), spec['trace'],
                  Path(spec['root']), Path(spec['bench_dir']),
                  log=lambda *a: print(*a, file=sys.stderr, flush=True))
    gen = Generator(ctx, rank, spec['port'])
    gen.setup()
    gen.window(0.0)
    gen.release()
    return 0


if __name__ == '__main__':
    sys.exit(worker(sys.argv[1], int(sys.argv[2])))
