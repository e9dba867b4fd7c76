"""The launch of ``csrc/cg_quad.cu``, measured: each mode's time at
SevenNet-0's convolution layouts for each tile size, ring depth and warp
count a block.

A block of ``cg_quad.cu`` walks a contiguous run of tiles of ``tile``
edges through a ring of ``stages`` stages of bulk copies, with ``warps``
warps computing (``cg_tables.quad_plan``, ``quad_smem``); the grid holds
as many blocks as fit the card at once.  Any launch gives the same bits.

    python -m sevennet_finetuning_tpu_torch.tools.quad_sweep [--ckpt P]
        [--out FILE] [--modes msg,x,sh,w]

At blocks 0, 1 and 4 of the checkpoint's model (blocks 1-3 share one
layout), on random legs of the batch-8 collate's 38,080 edge slots (torch
seed 0), times ``quad_cuda`` with CUDA events (ms per launch over 20
launches after warm-up) for every config of ``TILES`` x ``STAGES`` x
``WARPS`` whose block fits the card's shared memory, then the
``FINALISTS`` fastest and the rule's config (``quad_config``) again in
``ROUNDS`` rounds of turns.  Each config's output must equal the rule's
bit for bit, and the rule's lie within 2e-6 x max|plain| of
``quad_plain``.  Prints one line per block and mode (its finalists), then
the card's name and power limit and one JSON dict {"finalists": {"block
mode": {config: [ms, ...]}}, "best": {"block mode": config}, "rule":
{"block mode": config}}; ``--out`` also writes every config's time
there.  Exits 1 if an output disagrees.  The card is required: there is
no CPU path.
"""

from __future__ import annotations

import argparse
import itertools
import json
import sys
from pathlib import Path

import torch

from ..ops.cg_tables import (QUAD_MODES, QUAD_SMEM_MAX, QuadConfig,
                             quad_plan, quad_smem)
from ..ops.fused_conv import _MODE_LEGS
from ..ops.fused_conv_kernel import quad_config, quad_cuda, quad_plain
from .agg_sweep import layouts
from .bench_dma import card_line, time_ms

CKPT = (Path(__file__).resolve().parents[2]
        / 'experiments/ft_reewc_900/conv_out/checkpoint_best.pth')
TILES = (1, 2, 3, 4, 6, 8, 12, 16, 24, 32)
STAGES = (2, 3, 4)
WARPS = (4, 8, 16)
FINALISTS = 4
N_SLOT = 38080
KERNEL_TOL = 2e-6
ROUNDS = 2


def label(cfg: QuadConfig) -> str:
    return f'tile {cfg.tile} stages {cfg.stages} warps {cfg.warps}'


def configs(layout, mode):
    for t, s, w in itertools.product(TILES, STAGES, WARPS):
        cfg = QuadConfig(t, s, w)
        if quad_smem(layout, mode, cfg, quad_plan(
                layout, mode, t, w)).nbytes <= QUAD_SMEM_MAX:
            yield cfg


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--ckpt', type=Path, default=CKPT)
    ap.add_argument('--out', type=Path, default=None,
                    help='JSON file for every config\'s times')
    ap.add_argument('--modes', default=','.join(QUAD_MODES))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print('quad_sweep: no CUDA device', file=sys.stderr)
        return 2
    dev = torch.device('cuda')
    gen = torch.Generator(device='cpu').manual_seed(0)

    def randn(*shape):
        return torch.randn(*shape, generator=gen).to(dev)

    result, fin, best, rules, bad = {}, {}, {}, {}, []
    for t, layout in layouts(args.ckpt).items():
        for mode in args.modes.split(','):
            key = f'block {t} {mode}'
            legs = [randn(N_SLOT, layout.mode_dims[leg])
                    for leg in _MODE_LEGS[mode]]
            rule = quad_config(layout, mode)
            first = quad_cuda(mode, *legs, layout, rule)
            want = quad_plain(mode, *legs, layout)
            err = float((first - want).abs().max())
            scale = float(want.abs().max())
            if err > KERNEL_TOL * scale:
                bad.append(f'{key} rule')
                print(f'{key} {label(rule)}: max_abs_err {err:.3e} of '
                      f'{scale:.3e} -- FAIL', flush=True)
            times = {}
            for cfg in configs(layout, mode):
                got = quad_cuda(mode, *legs, layout, cfg)
                if not torch.equal(got, first):
                    bad.append(f'{key} {label(cfg)}')
                    print(f'{key} {label(cfg)}: not the rule\'s bits -- '
                          'FAIL', flush=True)
                times[cfg] = [time_ms(
                    lambda i, c=cfg: quad_cuda(mode, *legs, layout, c),
                    n_it=20)]
            if rule not in times:
                times[rule] = [time_ms(
                    lambda i: quad_cuda(mode, *legs, layout, rule), n_it=20)]
            finalists = sorted(times, key=lambda c: times[c][0])[:FINALISTS]
            if rule not in finalists:
                finalists.append(rule)
            for _ in range(ROUNDS):
                for cfg in finalists:
                    times[cfg].append(time_ms(
                        lambda i, c=cfg: quad_cuda(mode, *legs, layout, c),
                        n_it=20))
            top = min(finalists, key=lambda c: min(times[c][1:]))
            result[key] = {label(c): times[c] for c in times}
            fin[key] = {label(c): times[c][1:] for c in finalists}
            best[key], rules[key] = label(top), label(rule)
            print(f'{key}: {len(times)} configs, max_abs_err {err:.3e} of '
                  f'{scale:.3e}; finalists ' + '; '.join(
                      f'{k} {" / ".join(f"{v:.4f}" for v in row)} ms'
                      for k, row in fin[key].items())
                  + f'; best {label(top)}, the rule takes {label(rule)}',
                  flush=True)
    print(card_line(), flush=True)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(result))
    print(json.dumps({'finalists': fin, 'best': best, 'rule': rules}),
          flush=True)
    return 1 if bad else 0


if __name__ == '__main__':
    sys.exit(main())
