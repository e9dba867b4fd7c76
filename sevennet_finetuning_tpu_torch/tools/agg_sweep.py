"""The launch of ``csrc/cg_agg.cu``, measured: the kernel's time at
SevenNet-0's convolution layouts for each tile size, ring depth, node
count and warp count a block, beside one-term ``cg_gagg`` (the same
function, the yardstick).

A block of ``cg_agg.cu`` takes ``nodes`` consecutive nodes and walks
their dst-sorted edges in tiles of ``tile`` edges through a ring of
``stages`` stages of bulk copies, with ``warps`` warps computing
(``cg_tables.agg_plan``, ``agg_smem``).  Any launch gives the same bits.

    python -m sevennet_finetuning_tpu_torch.tools.agg_sweep [--ckpt P]
        [--out FILE] [--phases]

At blocks 0, 1 and 4 of the checkpoint's model (blocks 1-3 share one
layout), on random legs over a graph of the batch-8 collate's size (768
nodes, 38,080 edge slots, 34,604 live, ascending destinations from numpy
seed 0), times ``agg_cuda`` with CUDA events (ms per launch over 20
launches after warm-up) for every config of ``TILES`` x ``STAGES`` x
``NODES`` x ``WARPS`` whose block fits the card's shared memory, then the
``FINALISTS`` fastest, the rule's config (``agg_config``) and one-term
``gagg_cuda`` again in ``ROUNDS`` rounds of turns, and each finalist's
kernel device time a call under torch.profiler.  Each config's output
must equal the rule's bit for bit and lie within 2e-6 x max|plain| of
``agg_plain``; whether one-term ``cg_gagg`` gives the same bits is
printed.  Prints one line per block (its finalists), then the card's
name and power limit and one JSON dict {"finalists": {block: {config:
[ms, ...] + [device us]}}, "best": {block: config (by device time)},
"rule": {block: config}, "gagg_1term": {block: [ms, ...] + [device
us]}}; ``--out`` also writes every
config's times there.  ``--phases`` also times, at the rule's config,
the kernel's two halves as measurement builds of the same source
(``CG_AGG_ONLY``: 1, the copies without the arithmetic; 2, the
arithmetic on the first ``stages`` tiles' rows, no later copy), device
us a call beside the whole kernel's, under "phases" in the JSON dict.
Exits 1 if an output disagrees.  The card is
required: there is no CPU path.
"""

from __future__ import annotations

import argparse
import itertools
import json
import sys
from pathlib import Path

import numpy as np
import torch

from ..ops import _cuda
from ..ops.cg_tables import (AGG_SMEM_MAX, AggConfig, agg_plan, agg_smem)
from ..ops.fused_conv import layout_from_spec
from ..ops.fused_conv_agg import agg_config, agg_cuda, agg_plain
from ..ops.fused_conv_multi import gagg_cuda
from .bench_dma import card_line, time_ms

CKPT = (Path(__file__).resolve().parents[2]
        / 'experiments/ft_reewc_900/conv_out/checkpoint_best.pth')
BLOCKS = (0, 1, 4)
TILES = (2, 4, 6, 8, 12, 16, 24, 32)
STAGES = (2, 3, 4)
NODES = (1, 2, 4)
WARPS = (4, 8, 16)
FINALISTS = 8
N_NODE, N_SLOT, N_LIVE = 768, 38080, 34604
KERNEL_TOL = 2e-6
ROUNDS = 3
# measurement builds of cg_agg.cu: the copies alone, the arithmetic alone
PHASES = {'copies only': ('CG_AGG_ONLY=1',),
          'arithmetic only': ('CG_AGG_ONLY=2',)}


def kernel_device_us(fn, part='cg_agg_bulk_kernel', n=20) -> float:
    """Device time of the kernels named ``*part*`` a call of fn,
    microseconds, from torch.profiler over n calls (0.0 where the
    profiler records none)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    return sum(float(getattr(e, 'self_device_time_total', None)
                     or getattr(e, 'self_cuda_time_total', 0.0))
               for e in prof.key_averages()
               if part in e.key) / n


def phase_times(call) -> dict:
    """Device us a call of ``call`` (an agg_cuda launch) with the kernel
    as built, then with each ``PHASES`` build swapped in for it."""
    kernel = _cuda.kernel('cg_agg')
    out = {'whole kernel': kernel_device_us(call)}
    try:
        for name, defines in PHASES.items():
            _cuda._FNS['cg_agg'] = _cuda.variant_kernel('cg_agg', defines)
            out[name] = kernel_device_us(call)
    finally:
        _cuda._FNS['cg_agg'] = kernel
    return out


def label(cfg: AggConfig) -> str:
    return (f'tile {cfg.tile} stages {cfg.stages} nodes {cfg.nodes} '
            f'warps {cfg.warps}')


def configs(layout):
    for t, s, n, w in itertools.product(TILES, STAGES, NODES, WARPS):
        cfg = AggConfig(t, s, n, w)
        if agg_smem(layout, cfg,
                    agg_plan(layout, n, w).b_row).nbytes <= AGG_SMEM_MAX:
            yield cfg


def layouts(ckpt: Path):
    from ..model.build import build_model_spec
    from ..train.checkpoint import load_checkpoint

    spec = build_model_spec(load_checkpoint(str(ckpt))['config'])
    return {t: layout_from_spec(spec.blocks[t].conv_tp) for t in BLOCKS}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--ckpt', type=Path, default=CKPT)
    ap.add_argument('--out', type=Path, default=None,
                    help='JSON file for every config\'s times')
    ap.add_argument('--phases', action='store_true',
                    help='time the copies and the arithmetic apart')
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print('agg_sweep: no CUDA device', file=sys.stderr)
        return 2
    dev = torch.device('cuda')
    rng = np.random.default_rng(0)
    dst_np = np.full(N_SLOT, N_NODE, np.int32)
    dst_np[:N_LIVE] = np.sort(rng.integers(0, N_NODE, N_LIVE))
    dst = torch.from_numpy(dst_np).to(dev)
    gen = torch.Generator(device='cpu').manual_seed(0)

    def randn(*shape):
        return torch.randn(*shape, generator=gen).to(dev)

    result, fin, best, rules, gagg_ms, bad = {}, {}, {}, {}, {}, []
    phases = {}
    for t, layout in layouts(args.ckpt).items():
        x = randn(N_SLOT, layout.dim_x)
        sh = randn(N_SLOT, layout.dim_sh)
        w = randn(N_SLOT, layout.dim_w)
        rule = agg_config(layout)
        want = agg_plain(x, sh, w, dst, layout, N_NODE)
        scale = float(want.abs().max())
        first = agg_cuda(x, sh, w, dst, layout, N_NODE, rule)
        gagg = gagg_cuda([x, sh, w], dst, ((0, 1, 2),), layout, N_NODE)
        print(f'block {t}: rule {label(rule)}, one-term cg_gagg same bits: '
              f'{torch.equal(gagg, first)}', flush=True)
        times = {}
        for cfg in configs(layout):
            got = agg_cuda(x, sh, w, dst, layout, N_NODE, cfg)
            err = float((got - want).abs().max())
            if err > KERNEL_TOL * scale or not torch.equal(got, first):
                bad.append(f'block {t} {label(cfg)}')
                print(f'block {t} {label(cfg)}: max_abs_err {err:.3e} of '
                      f'{scale:.3e}, same bits as the rule: '
                      f'{torch.equal(got, first)} -- FAIL', flush=True)
            times[cfg] = [time_ms(
                lambda i, c=cfg: agg_cuda(x, sh, w, dst, layout, N_NODE, c),
                n_it=20)]
        finalists = sorted(times, key=lambda c: times[c][0])[:FINALISTS]
        if rule not in finalists:
            finalists.append(rule)
        g_row = []
        for _ in range(ROUNDS):
            for cfg in finalists:
                times[cfg].append(time_ms(
                    lambda i, c=cfg: agg_cuda(x, sh, w, dst, layout, N_NODE,
                                              c), n_it=20))
            g_row.append(time_ms(lambda i: gagg_cuda(
                [x, sh, w], dst, ((0, 1, 2),), layout, N_NODE), n_it=20))
        dev_us = {c: kernel_device_us(
            lambda c=c: agg_cuda(x, sh, w, dst, layout, N_NODE, c))
            for c in finalists}
        g_row.append(kernel_device_us(lambda: gagg_cuda(
            [x, sh, w], dst, ((0, 1, 2),), layout, N_NODE), 'cg_gagg'))
        top = min(finalists, key=lambda c: dev_us[c])
        result[t] = {label(c): times[c] for c in times}
        fin[t] = {label(c): times[c][1:] + [dev_us[c]] for c in finalists}
        best[t], rules[t], gagg_ms[t] = label(top), label(rule), g_row
        if args.phases:
            phases[t] = phase_times(
                lambda: agg_cuda(x, sh, w, dst, layout, N_NODE, rule))
            print(f'block {t} phases at the rule: ' + ', '.join(
                f'{k} {v:.1f} us' for k, v in phases[t].items()), flush=True)
        print(f'block {t}: {len(times)} configs; finalists ' + '; '.join(
            f'{k} {" / ".join(f"{v:.4f}" for v in row[:-1])} ms, device '
            f'{row[-1]:.1f} us' for k, row in fin[t].items())
            + f'; one-term cg_gagg {" / ".join(f"{v:.4f}" for v in g_row[:-1])}'
            f' ms, device {g_row[-1]:.1f} us; best by device time '
            f'{label(top)}, the rule takes {label(rule)}',
            flush=True)
    print(card_line(), flush=True)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(result))
    print(json.dumps({'finalists': fin, 'best': best, 'rule': rules,
                      'gagg_1term': gagg_ms,
                      **({'phases': phases} if args.phases else {})}),
          flush=True)
    return 1 if bad else 0


if __name__ == '__main__':
    sys.exit(main())
