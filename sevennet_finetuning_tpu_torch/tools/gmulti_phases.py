"""The phases of the ``cg_gmulti`` plan, measured: the kernel's time at
SevenNet-0's convolution layouts for each phase count, for the job sets
of ``cg_gmulti`` and of ``cg_multi`` (the same kernel built for one slot).

A block of ``csrc/cg_gmulti.cu`` splits its tile of edges into ``n_phase``
phases for every 32-channel slice, one work unit each, so the count sets
how many warps a block runs and how many edges each walks
(``cg_tables.gmulti_plan``).  Any count gives the same bits.

    python -m sevennet_finetuning_tpu_torch.tools.gmulti_phases [--ckpt P]

At blocks 0, 1 and 4 of the checkpoint's model (blocks 1-3 share one
layout) and for the job sets of a train step -- ``CGNodeMulti.backward``'s
six jobs, the four without the sh group, and ``CGNodeAgg.backward``'s
first-order jobs (xn, shn, wn at blocks 1-4, shn, wn at block 0) through
``multi_cuda`` (the one-slot build, ``cg_multi``) and, for comparison,
the same jobs through ``gmulti_cuda`` (the two-slot build) -- on random
legs over a graph
of the batch-8 collate's size (768 nodes, 38,080 edge slots, 34,604 live,
ascending destinations from numpy seed 0), times ``gmulti_cuda`` for each
of ``PHASES`` with CUDA events (ms per launch over 20 launches after
warm-up), in two rounds of turns.  Each count's output must equal the
first count's bit for bit and lie within 2e-6 x max|plain| of
``gmulti_plain``.  Prints one line per case, then the card's name and power
limit and one JSON dict {case: {phases: [ms, ms]}, "best": {case:
phases}}.  Exits 1 if an output disagrees.  The card is required: there
is no CPU path.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np
import torch

from ..ops.cg_tables import gmulti_plan
from ..ops.fused_conv import layout_from_spec
from ..ops.fused_conv_multi import (EDGES_PER_BLOCK, gmulti_cuda,
                                    gmulti_plain, multi_cuda, multi_jobs,
                                    multi_plain)
from .bench_dma import card_line, time_ms

CKPT = (Path(__file__).resolve().parents[2]
        / 'experiments/ft_reewc_900/conv_out/checkpoint_best.pth')
BLOCKS = (0, 1, 4)
PHASES = tuple(p for p in (1, 2, 4, 8, 16) if p <= EDGES_PER_BLOCK)
N_NODE, N_SLOT, N_LIVE = 768, 38080, 34604
KERNEL_TOL = 2e-6
ROUNDS = 2
# pool [x, sh, w, ct_x, ct_sh, ct_w]: CGNodeMulti.backward's jobs
SIX = ((('x', 1, 5, 'x'), ('x', 4, 2, 'x'), ('sh', 0, 5, 'sh'),
        ('sh', 3, 2, 'sh'), ('w', 0, 4, 'w'), ('w', 3, 1, 'w')),
       ('x', 'sh', 'w'))
FOUR = (tuple(j for j in SIX[0] if j[3] != 'sh'), ('x', 'w'))


def multi_job_set(block: int):
    """CGNodeAgg.backward's first-order jobs at a block: block 0's input
    is the embedding, which needs no cotangent."""
    return ('shn', 'wn') if block == 0 else ('xn', 'shn', 'wn')


def layouts(ckpt: Path):
    from ..model.build import build_model_spec
    from ..train.checkpoint import load_checkpoint

    spec = build_model_spec(load_checkpoint(str(ckpt))['config'])
    return {t: layout_from_spec(spec.blocks[t].conv_tp) for t in BLOCKS}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--ckpt', type=Path, default=CKPT)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print('gmulti_phases: no CUDA device', file=sys.stderr)
        return 2
    dev = torch.device('cuda')
    rng = np.random.default_rng(0)
    dst_np = np.full(N_SLOT, N_NODE, np.int32)
    dst_np[:N_LIVE] = np.sort(rng.integers(0, N_NODE, N_LIVE))
    dst = torch.from_numpy(dst_np).to(dev)
    gen = torch.Generator(device='cpu').manual_seed(0)

    def randn(*shape):
        return torch.randn(*shape, generator=gen).to(dev)

    times, best, bad = {}, {}, []
    for t, layout in layouts(args.ckpt).items():
        dims = (layout.dim_x, layout.dim_sh, layout.dim_w)
        pool = [randn(N_SLOT, d) for d in dims + dims]
        ybar = randn(N_NODE, layout.dim_msg)
        legs = pool[:3]
        mjobs = multi_job_set(t)
        label_m = '+'.join(mjobs)
        cases = [(label, lambda p, jg=jg: gmulti_cuda(
                      ybar, pool, dst, *jg, layout, N_NODE, n_phase=p),
                  lambda jg=jg: gmulti_plain(ybar, pool, dst, *jg, layout,
                                             N_NODE))
                 for label, jg in (('6 jobs', SIX), ('4 jobs', FOUR))]
        cases += [
            (f'multi {label_m}', lambda p: multi_cuda(
                ybar, *legs, dst, mjobs, layout, N_NODE, n_phase=p),
             lambda: multi_plain(ybar, *legs, dst, mjobs, layout, N_NODE)),
            (f'multi {label_m} (two-slot build)', lambda p: gmulti_cuda(
                ybar, legs, dst, multi_jobs(mjobs), mjobs, layout, N_NODE,
                n_phase=p),
             lambda: multi_plain(ybar, *legs, dst, mjobs, layout, N_NODE))]
        for label, run, plain in cases:
            case = f'block {t} {label}'
            want = plain()
            scale = max(float(w.abs().max()) for w in want)
            first = None
            for p in PHASES:
                got = run(p)
                err = max(float((g - w).abs().max())
                          for g, w in zip(got, want))
                if first is None:
                    first = got
                same = all(torch.equal(g, f) for g, f in zip(got, first))
                if err > KERNEL_TOL * scale or not same:
                    bad.append(f'{case} phases {p}')
                    print(f'{case} phases {p}: max_abs_err {err:.3e} of '
                          f'{scale:.3e}, same bits as phases {PHASES[0]}: '
                          f'{same} -- FAIL', flush=True)
            row = {p: [] for p in PHASES}
            for _ in range(ROUNDS):
                for p in PHASES:
                    row[p].append(time_ms(lambda i, p=p: run(p), n_it=20))
            rule = int(gmulti_plan(layout, EDGES_PER_BLOCK).descs[0, 3])
            times[case] = row
            best[case] = min(PHASES, key=lambda p: min(row[p]))
            print(f'{case}: ' + ', '.join(
                f'{p} phases {" / ".join(f"{v:.4f}" for v in row[p])} ms'
                for p in PHASES)
                + f' (best {best[case]}, the plan takes {rule})',
                flush=True)
    print(card_line(), flush=True)
    print(json.dumps({**times, 'best': best}), flush=True)
    return 1 if bad else 0


if __name__ == '__main__':
    sys.exit(main())
