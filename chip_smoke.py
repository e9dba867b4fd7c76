#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives ``sevennet_finetuning_tpu_torch`` (never JAX) through five phases
and exits non-zero if any fails:

1. build   -- compile every CUDA kernel of ``csrc/`` (one nvcc each, in
              parallel) and print the build time;
2. kernels -- call each kernel's wrapper at main-path shapes (a batch-8
              collate of ft900.extxyz; the conv layouts of blocks 0, 1
              and 4 of SevenNet-0; segment sums at D = 1, 6 and 480) and
              hold it against its plain PyTorch version:
              max|kernel - plain| <= 2e-6 * max|plain|.  Times come from
              CUDA events after warm-up; the bound is the larger of bytes
              over 3.35 TB/s and fp32 operations over 67 TFLOP/s (H100
              SXM data sheet);
3. serve   -- ``Calculator.from_checkpoint`` on the in-repo SevenNet-0
              checkpoint answers each structure of ft.extxyz; results are
              held against the committed JAX-CPU golden file (energy rel
              <= 2e-6, forces and stress max-abs rel <= 1e-4) and every
              request must launch agg 5, multi 5 and segment-sum >= 8
              times;
4. batch   -- ``apply_model`` on one batch-8 collate of ft900.extxyz:
              ms per batch and edges/s;
5. profile -- torch.profiler over one request and one batch-8 forward:
              device busy share and device time by kernel.

Before the last line it prints the card's name and power limit and a
JSON line with every kernel's numbers; the last line is
``{"ok": true, "device": {...}}``.
"""

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
PKG = ROOT / 'sevennet_finetuning_tpu_torch'
CKPT = ROOT / 'experiments/ft_reewc_900/conv_out/checkpoint_best.pth'
FT = ROOT / 'experiments/ft_reewc/data/ft.extxyz'
FT900 = ROOT / 'experiments/ft_reewc_900/data/ft900.extxyz'
GOLDEN = PKG / 'golden/ft_extxyz_jax_cpu.npz'

HBM_BYTES_PER_S = 3.35e12      # H100 SXM data sheet
FP32_FLOP_PER_S = 67e12        # H100 SXM data sheet, non-tensor fp32
KERNEL_TOL = 2e-6
BATCH = 8

SOURCES = {
    'segment_sum': dict(
        source='sevennet_finetuning_tpu_torch/csrc/segment_sum.cu',
        replaces='sevennet_finetuning_tpu/ops/pallas_scatter.py:512'),
    'cg_agg': dict(
        source='sevennet_finetuning_tpu_torch/csrc/cg_agg.cu',
        replaces='sevennet_finetuning_tpu/ops/fused_conv_agg_kernel.py:194'),
    'cg_multi': dict(
        source='sevennet_finetuning_tpu_torch/csrc/cg_multi.cu',
        replaces='sevennet_finetuning_tpu/ops/fused_conv_bwd_kernel.py:478'),
}


def log(*args):
    print(*args, flush=True)


def cuda_ms(fn, iters=20, warmup=3):
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(n_bytes, n_flop):
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_flop / FP32_FLOP_PER_S * 1e3
    return max(t_bytes, t_ops), ('bytes' if t_bytes >= t_ops else
                                 'operations')


def compare(name, got, want):
    got = got if isinstance(got, (tuple, list)) else (got,)
    want = want if isinstance(want, (tuple, list)) else (want,)
    err = max(float((g - w).abs().max()) for g, w in zip(got, want))
    scale = max(float(w.abs().max()) for w in want)
    ok = err <= KERNEL_TOL * scale
    log(f'  {name}: max_abs_err {err:.3e}, max|plain| {scale:.3e} '
        f'({"ok" if ok else "FAIL"} at {KERNEL_TOL:g} rel)')
    if not ok:
        raise AssertionError(f'{name}: kernel disagrees with its plain '
                             f'version ({err:.3e} > {KERNEL_TOL:g} * '
                             f'{scale:.3e})')
    return err


def phase_build():
    from sevennet_finetuning_tpu_torch.ops import _cuda

    t0 = time.perf_counter()
    _cuda.build_all()
    dt = time.perf_counter() - t0
    log(f'[build] {len(_cuda.SOURCES)} kernels built in {dt:.1f} s')
    for name in _cuda.SOURCES:
        for line in _cuda.build_log(name).splitlines():
            if 'registers' in line or 'spill' in line:
                log(f'  {name}: {line.strip()}')


def batch8(calc):
    """Batch-8 collate of the first eight 96-atom structures of ft900."""
    from sevennet_finetuning_tpu_torch import keys as K
    from sevennet_finetuning_tpu_torch.data.readers import read_extxyz
    from sevennet_finetuning_tpu_torch.model.graph import (
        bucket_capacity, collate, structure_to_graph)
    from sevennet_finetuning_tpu_torch.model.nequip import batch_to_torch

    structs = [s for s in read_extxyz(str(FT900)) if len(s) == 96][:BATCH]
    graphs = [structure_to_graph(s, calc.spec.cutoff, calc.type_map)
              for s in structs]
    n_edge = sum(g[K.EDGE_IDX].shape[1] for g in graphs)
    b = collate(graphs, n_node=96 * BATCH, n_edge=bucket_capacity(n_edge),
                n_graph=BATCH)
    return batch_to_torch(b, calc.device), n_edge


def phase_kernels(calc, batch, n_real_edge):
    import torch

    from sevennet_finetuning_tpu_torch import keys as K
    from sevennet_finetuning_tpu_torch.ops import scatter
    from sevennet_finetuning_tpu_torch.ops.cg_tables import (
        agg_table, multi_table)
    from sevennet_finetuning_tpu_torch.ops.fused_conv import layout_from_spec
    from sevennet_finetuning_tpu_torch.ops.fused_conv_agg import (
        agg_cuda, agg_plain)
    from sevennet_finetuning_tpu_torch.ops.fused_conv_multi import (
        multi_cuda, multi_plain)

    dev = calc.device
    dst = batch[K.EDGE_IDX][0].contiguous()
    E = dst.shape[0]
    N = batch[K.POS].shape[0]
    live = int((dst < N).sum())
    gen = torch.Generator(device='cpu').manual_seed(0)

    def randn(*shape):
        return torch.randn(*shape, generator=gen).to(dev)

    log(f'[kernels] batch-8 collate: N={N}, E={E} slots, {n_real_edge} '
        'real edges')
    rows = {}

    # --- sorted segment sum at D = 1, 6, 480 ---
    cases = []
    for D in (1, 6, 480):
        msg = randn(E, D)
        got = scatter.segment_sum_cuda(msg, dst, N)
        want = scatter.segment_sum_plain(msg, dst, N)
        err = compare(f'segment_sum D={D}', got, want)
        idx_long = dst.long()

        def library():
            return torch.zeros(N + 1, D, device=dev).index_add_(
                0, idx_long, msg)

        # only the live edges' rows are read: the kernel stops at
        # offs[N], the first sentinel edge
        b_ms, b_by = bound_ms(4 * (live * D + E + N * D), live * D)
        cases.append(dict(
            shape=f'E={E} D={D} N={N}', max_abs_err=err,
            ms=cuda_ms(lambda: scatter.segment_sum_cuda(msg, dst, N)),
            plain_ms=cuda_ms(lambda: scatter.segment_sum_plain(msg, dst, N)),
            library_ms=cuda_ms(library), bound_ms=b_ms, bound_by=b_by))
    rows['segment_sum'] = cases

    # --- agg / multi at the layouts of blocks 0, 1 and 4 ---
    agg_cases, multi_cases = [], []
    for t in (0, 1, 4):
        layout = layout_from_spec(calc.spec.blocks[t].conv_tp)
        x = randn(E, layout.dim_x)
        sh = randn(E, layout.dim_sh)
        w = randn(E, layout.dim_w)
        # x/sh/w rows of padded edges are never needed: the agg sum ends
        # at the last live edge and multi's outputs there are zero
        leg_bytes = 4 * live * (layout.dim_x + layout.dim_sh + layout.dim_w)

        got = agg_cuda(x, sh, w, dst, layout, N)
        want = agg_plain(x, sh, w, dst, layout, N)
        err = compare(f'cg_agg block {t}', got, want)
        n_terms = agg_table(layout)[1].shape[0]
        b_ms, b_by = bound_ms(
            leg_bytes + 4 * E + 4 * N * layout.dim_msg + 16 * n_terms,
            live * (4 * n_terms + layout.dim_msg))
        agg_cases.append(dict(
            shape=f'block {t}: E={E} N={N} dims x/sh/w/msg '
                  f'{layout.dim_x}/{layout.dim_sh}/{layout.dim_w}/'
                  f'{layout.dim_msg}',
            max_abs_err=err,
            ms=cuda_ms(lambda: agg_cuda(x, sh, w, dst, layout, N)),
            plain_ms=cuda_ms(lambda: agg_plain(x, sh, w, dst, layout, N),
                             iters=5),
            library_ms=None, bound_ms=b_ms, bound_by=b_by))

        jobs = ('shn', 'wn') if t == 0 else ('xn', 'shn', 'wn')
        ybar = randn(N, layout.dim_msg)
        got = multi_cuda(ybar, x, sh, w, dst, jobs, layout, N)
        want = multi_plain(ybar, x, sh, w, dst, jobs, layout, N)
        err = compare(f'cg_multi block {t} {jobs}', got, want)
        tab = multi_table(layout, jobs)
        b_ms, b_by = bound_ms(
            leg_bytes + 4 * E + 4 * N * layout.dim_msg
            + 4 * E * sum(tab.out_dims) + 16 * tab.terms.shape[0],
            live * 4 * tab.terms.shape[0])
        multi_cases.append(dict(
            shape=f'block {t} jobs {"+".join(jobs)}: E={E} N={N}',
            max_abs_err=err,
            ms=cuda_ms(lambda: multi_cuda(ybar, x, sh, w, dst, jobs, layout,
                                          N)),
            plain_ms=cuda_ms(lambda: multi_plain(ybar, x, sh, w, dst, jobs,
                                                 layout, N), iters=5),
            library_ms=None, bound_ms=b_ms, bound_by=b_by))
    rows['cg_agg'] = agg_cases
    rows['cg_multi'] = multi_cases

    for name, cases in rows.items():
        for c in cases:
            lib = ('n/a' if c['library_ms'] is None
                   else f'{c["library_ms"]:.4f} ms')
            log(f'  {name} [{c["shape"]}]: kernel {c["ms"]:.4f} ms, '
                f'plain {c["plain_ms"]:.4f} ms, library {lib}, bound '
                f'{c["bound_ms"] * 1e3:.1f} us ({c["bound_by"]})')
    return rows


def phase_serve(calc):
    import numpy as np
    import torch

    from sevennet_finetuning_tpu_torch.data.readers import read_extxyz
    from sevennet_finetuning_tpu_torch.ops import _cuda

    structs = read_extxyz(str(FT))
    gold = np.load(GOLDEN)
    for s in structs:            # warm-up: tables and allocator
        calc.calculate(s)
    torch.cuda.synchronize()
    _cuda.LAUNCHES.clear()
    latencies = []
    for i, s in enumerate(structs):
        before = dict(_cuda.LAUNCHES)
        t0 = time.perf_counter()
        res = calc.calculate(s)
        latencies.append((time.perf_counter() - t0) * 1e3)
        got = {k: _cuda.LAUNCHES[k] - before.get(k, 0)
               for k in _cuda.SOURCES}
        if (got['cg_agg'] != 5 or got['cg_multi'] != 5
                or got['segment_sum'] < 8):
            raise AssertionError(f'request {i}: launches {got}, expected '
                                 'cg_agg 5, cg_multi 5, segment_sum >= 8')
        e_rel = abs(res['energy'] - gold['energy'][i]) / abs(
            gold['energy'][i])
        f_ref = gold[f'forces_{i}']
        f_rel = np.abs(res['forces'] - f_ref).max() / np.abs(f_ref).max()
        s_rel = (np.abs(res['stress'] - gold['stress'][i]).max()
                 / np.abs(gold['stress'][i]).max())
        log(f'  request {i} ({len(s)} atoms): {latencies[-1]:.2f} ms, '
            f'launches {got}, energy rel {e_rel:.2e}, forces rel '
            f'{f_rel:.2e}, stress rel {s_rel:.2e}')
        if not (e_rel <= 2e-6 and f_rel <= 1e-4 and s_rel <= 1e-4):
            raise AssertionError(f'request {i} disagrees with the golden '
                                 'file')
    counts = dict(_cuda.LAUNCHES)
    log(f'[serve] {len(structs)} requests, latency ms '
        f'{[round(x, 3) for x in latencies]}, median '
        f'{sorted(latencies)[len(latencies) // 2]:.3f} ms')
    return counts


def phase_batch(calc, batch, n_real_edge):
    import torch

    from sevennet_finetuning_tpu_torch import keys as K
    from sevennet_finetuning_tpu_torch.model.nequip import apply_model

    out = apply_model(calc.model, batch)
    torch.cuda.synchronize()
    times = []
    for _ in range(5):
        t0 = time.perf_counter()
        out = apply_model(calc.model, batch)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    for key, shape in ((K.PRED_TOTAL_ENERGY, (BATCH,)),
                       (K.PRED_FORCE, (96 * BATCH, 3)),
                       (K.PRED_STRESS, (BATCH, 6))):
        v = out[key]
        if tuple(v.shape) != shape or not bool(torch.isfinite(v).all()):
            raise AssertionError(f'batch output {key}: shape '
                                 f'{tuple(v.shape)} or non-finite values')
    ms = sorted(times)[len(times) // 2]
    log(f'[batch] batch-8: {ms:.3f} ms per batch (median of 5), '
        f'{n_real_edge / (ms / 1e3):.1f} edges/s ({n_real_edge} real edges)')


def _self_device_us(evt):
    for attr in ('self_device_time_total', 'self_cuda_time_total'):
        v = getattr(evt, attr, None)
        if v is not None:
            return float(v)
    return 0.0


def phase_profile(calc, batch):
    """Device time by kernel for one 96-atom request and one batch-8
    forward (torch.profiler); busy share = device time / wall time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from sevennet_finetuning_tpu_torch.data.readers import read_extxyz
    from sevennet_finetuning_tpu_torch.model.nequip import apply_model

    s = read_extxyz(str(FT))[0]
    runs = (('request', lambda: calc.calculate(s)),
            ('batch-8', lambda: apply_model(calc.model, batch)))
    for label, fn in runs:
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        # device-side events only (kernels, copies): CPU ops carry their
        # kernels' time too and would count it twice
        rows = [(e.key, e.count, _self_device_us(e) / 1e3)
                for e in prof.key_averages()
                if str(getattr(e, 'device_type', '')).endswith('CUDA')
                and _self_device_us(e) > 0]
        busy = sum(r[2] for r in rows)
        if not rows:
            log(f'[profile] {label}: device time not measured (the '
                'profiler recorded no device events)')
            continue
        log(f'[profile] {label}: wall {wall:.3f} ms under the profiler, '
            f'device busy {busy:.3f} ms ({100 * busy / wall:.1f}%), '
            f'{sum(r[1] for r in rows)} device ops')
        for key, count, ms in sorted(rows, key=lambda r: -r[2])[:12]:
            log(f'  {ms:9.4f} ms {count:5d}x  {key[:90]}')


def card_line():
    try:
        out = subprocess.run(
            ['nvidia-smi', '--query-gpu=name,power.limit',
             '--format=csv,noheader'], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError) as e:
        return f'nvidia-smi unavailable: {e}'


def main():
    import torch

    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA device', file=sys.stderr)
        return 2
    if not PKG.is_dir():
        print(f'chip_smoke: {PKG} is missing', file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from sevennet_finetuning_tpu_torch.calculator import Calculator

    card = card_line()
    log(f'[device] {torch.cuda.get_device_name(0)} | {card} | torch '
        f'{torch.__version__} cuda {torch.version.cuda}')
    phase_build()
    calc = Calculator.from_checkpoint(str(CKPT), device='cuda')
    batch, n_real_edge = batch8(calc)
    rows = phase_kernels(calc, batch, n_real_edge)
    counts = phase_serve(calc)
    phase_batch(calc, batch, n_real_edge)
    phase_profile(calc, batch)

    # one row per kernel at its interior-block / widest shape; every
    # measured shape is under "cases"
    main_case = {'segment_sum': 2, 'cg_agg': 1, 'cg_multi': 1}
    kernels = []
    for name, cases in rows.items():
        c = cases[main_case[name]]
        kernels.append(dict(
            name=name, route='cuda', **SOURCES[name],
            launches=counts.get(name, 0), max_abs_err=c['max_abs_err'],
            ms=c['ms'], plain_ms=c['plain_ms'], bound_ms=c['bound_ms'],
            bound_by=c['bound_by'], library_ms=c['library_ms'],
            shape=c['shape'], cases=cases))
        if counts.get(name, 0) == 0:
            raise AssertionError(f'{name} was never launched on the path')
    print(card, flush=True)
    print(json.dumps({'kernels': kernels}), flush=True)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
