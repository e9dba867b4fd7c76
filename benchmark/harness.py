"""The benchmark harness: one run of one cell.

Everything a cell needs is found by name from ``BENCHMARK.json``: the
workload names a configuration (``configs[].file``, a JSON file of sizes
beside its source) and a traffic mix (``benchmark/traffic/<traffic>.json``,
whose ``kind`` names the generator in ``benchmark/generators/<kind>.py``);
each per-layer metric is read by ``benchmark/metrics/<name>.py``, or by
``benchmark/metrics/<stem>.py`` for a name ``<stem>.<group>`` that splits
one quantity by the cells it serves.  A cell added from new files and
entries runs with no edit here.

A run: set-up (the generator builds the program's objects from the seed and
warms every shape its traffic uses; ``setup_s`` runs from process start
to here), the measured window (closed loop, ``--seconds`` long, ended at a
unit boundary), the peak memory, the program's state freed, then the
comparison with the plain reference that decides ``correct``.  With
``--trace 1`` a slice at the start of the window runs under the profiler
and the per-layer metrics are printed instead of the end-to-end ones.
"""

from __future__ import annotations

import importlib.util
import json
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
FORBIDDEN = ('jax', 'jaxlib', 'flax', 'sevennet_finetuning_tpu')


class RunError(RuntimeError):
    """A run that cannot give a result (exit non-zero, no result line)."""


def load_manifest(root: Path = ROOT) -> Dict:
    with open(root / 'BENCHMARK.json') as f:
        return json.load(f)


def find(entries: List[Dict], name: str, what: str) -> Dict:
    for e in entries:
        if e['name'] == name:
            return e
    raise RunError(f'no {what} named {name!r} in BENCHMARK.json')


def load_module(path: Path, name: str):
    if not path.exists():
        raise RunError(f'{path} not found')
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metric_reader(name: str, bench_dir: Path = BENCH_DIR):
    """The reader of per-layer metric ``name``: its own file, else the
    file of its stem (the part before the first dot)."""
    for stem in (name, name.split('.')[0]):
        path = bench_dir / 'metrics' / f'{stem}.py'
        if path.exists():
            return load_module(path, f'bench_metric_{stem}')
    raise RunError(f'no reader for metric {name!r}')


def cell_metrics(manifest: Dict, workload: str):
    """(end-to-end metrics, per-layer metrics) that ``workload`` reports."""
    def listed(m):
        return 'workloads' not in m or workload in m['workloads']

    e2e = [m for m in manifest['end_to_end'] if listed(m)]
    e2e_names = {m['name'] for m in e2e}
    per = [m for m in manifest['per_layer']
           if (workload in m['workloads'] if 'workloads' in m
               else m['moves'] in e2e_names)]
    return e2e, per


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is jax, jaxlib, flax or the JAX
    package (the port's name only begins with the latter's)."""
    return sorted({n.split('.')[0] for n in sys.modules
                   if n.split('.')[0] in FORBIDDEN})


class Context:
    """What a generator gets: the configuration (its file's dict), the
    traffic's parameters, the seed, the device, the chips, the spans, the
    log and the traffic overrides."""

    def __init__(self, cell, config, traffic, seed, device, chips, spans,
                 trace, root, bench_dir, log=print, overrides=None):
        self.cell, self.config, self.traffic = cell, config, traffic
        self.seed, self.device, self.chips = seed, device, chips
        self.spans, self.trace, self.root = spans, trace, root
        self.bench_dir, self.log = bench_dir, log
        self.overrides = dict(overrides or {})


def device_info(device, chips: int, peak: int) -> Dict:
    import torch

    if device.type == 'cuda':
        return {'platform': 'gpu', 'kind': torch.cuda.get_device_name(device),
                'count': chips, 'memory_peak_bytes': int(peak)}
    return {'platform': 'cpu', 'kind': 'cpu', 'count': chips,
            'memory_peak_bytes': int(peak)}


def run_cell(workload: str, seed: int, seconds: float, trace: bool,
             t_start: float, device=None, root: Path = ROOT,
             bench_dir: Path = BENCH_DIR, overrides: Optional[Dict] = None,
             control: bool = False, log=print) -> Dict:
    """One run; returns the result line's object.  ``overrides`` replaces
    traffic parameters (the CPU tests' tiny sizes); ``control`` puts the
    reference at the next precision down in the program's place, and its
    readings, held to the same limits, decide ``correct``."""
    import torch

    from .trace import DeviceTrace, Spans, breakdown

    manifest = load_manifest(root)
    cell = find(manifest['workloads'], workload, 'workload')
    cfg_entry = find(manifest['configs'], cell['config'], 'configuration')
    with open(root / cfg_entry['file']) as f:
        config = json.load(f)
    with open(bench_dir / 'traffic' / f'{cell["traffic"]}.json') as f:
        traffic = json.load(f)
    traffic.update(overrides or {})
    chips = int(cell['chips'])
    if device is None:
        if not torch.cuda.is_available():
            raise RunError('no CUDA device: torch.cuda.is_available() is '
                           'false')
        if torch.cuda.device_count() < chips:
            raise RunError(f'{workload} needs {chips} cards, '
                           f'{torch.cuda.device_count()} visible')
        device = torch.device('cuda', 0)
    device = torch.device(device)
    e2e_list, per_list = cell_metrics(manifest, workload)

    gen_mod = load_module(bench_dir / 'generators' / f'{traffic["kind"]}.py',
                             f'bench_generator_{traffic["kind"]}')
    spans = Spans()
    ctx = Context(cell, config, traffic, seed, device, chips, spans, trace,
                  root, bench_dir, log, overrides)
    drv = gen_mod.Generator(ctx)
    drv.setup()
    if device.type == 'cuda':
        torch.cuda.synchronize(device)
    setup_s = time.perf_counter() - t_start
    log(f'[bench] {workload} seed {seed}: set-up {setup_s:.3f} s')

    tracer = DeviceTrace(spans) if (trace and device.type == 'cuda') \
        else None
    if tracer is not None:
        tracer.prime()
    spans.clear()
    t0 = time.perf_counter()
    stats = drv.window(seconds, tracer)
    if device.type == 'cuda':
        torch.cuda.synchronize(device)
    window_s = time.perf_counter() - t0
    peak = (drv.memory_peak() if device.type == 'cuda' else 0)
    log(f'[bench] window {window_s:.3f} s, {stats}')
    drv.release()
    peak = getattr(drv, 'peak_all', peak)

    t_check = time.perf_counter()
    if control:
        from .judge import judge

        correct, checks = judge(ctx, drv.control())
    else:
        correct, checks = drv.check()
    log(f'[bench] check {time.perf_counter() - t_check:.3f} s')
    found = forbidden_modules()
    if found:
        raise RunError(f'modules of JAX or the JAX package were loaded: '
                       f'{found}')

    rec = {'stats': stats, 'window_s': window_s, 'setup_s': setup_s,
           'spans': spans, 'chips': chips, 'peak_bytes': peak,
           'trace': ((drv.trace_summary(tracer)
                      if hasattr(drv, 'trace_summary') else tracer.summary())
                     if tracer else None),
           'bounds': drv.kernel_bounds() if tracer else None}
    metrics = {}
    if not trace:
        values = drv.end_to_end(rec)
        values['setup_s'] = setup_s
        values['peak_mem_gib'] = peak / 2 ** 30
        for m in e2e_list:
            metrics[m['name']] = {'value': float(values[m['name']]),
                                  'unit': m['unit']}
    else:
        for m in per_list:
            v = metric_reader(m['name'], bench_dir).read(m['name'], rec)
            if v is not None:
                metrics[m['name']] = {'value': float(v), 'unit': m['unit']}
    out = {'correct': bool(correct), 'attempted': int(stats['attempted']),
           'failed': int(stats.get('failed', 0)), 'metrics': metrics,
           'device': device_info(device, chips, peak)}
    if trace and rec['trace'] is not None:
        out['device']['busy_s'] = rec['trace']['busy_s']
        out['device']['window_s'] = rec['trace']['window_s']
        out['breakdown'] = breakdown(rec['trace'])
    out['checks'] = checks
    return out


def format_checks(checks: Dict) -> List[str]:
    return [f'{k}: {v["value"]:.6e} (limit {v["limit"]:.6e})'
            for k, v in checks.items()]
