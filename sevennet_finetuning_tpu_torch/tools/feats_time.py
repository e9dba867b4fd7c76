"""Profiler device time of the Hopper feature probes beside their library
calls, at the TPU probe's shapes (``hopper_feats.probe_inputs``).

    python -m sevennet_finetuning_tpu_torch.tools.feats_time [--rounds 3]

Each round measures, in this order: the floor, ``bench_dma``'s overhead
control (``copy_tiled_cuda`` on an [8, 128] tensor into a preallocated
output: one block, 4 KB each way, the card's time for a launch that
moves almost nothing) and ``zero_`` of the same output (PyTorch's fill
kernel: one block that reads nothing and writes 4 KB); 9a
``transpose_cuda`` into a preallocated output and ``copy_(x.t())``; 9b
``split_cuda``; 9c ``dot_cuda`` and ``torch.matmul(a.t(), b)``; 9d
``window_cuda`` and ``index_select``.
Each is device us a call by ``bench_dma.device_us_per_call``, the
measure ``chip_smoke.py`` reads.  Prints one line a measurement, then
the card line and, last, one JSON object of each measurement's mean
over the rounds (a profile that recorded no device event after its
retries is left out of the mean).  To compare two designs, run it from
each tree in turn in one call on the card (A B B A); the floor, a
kernel the trees share, is the noise control and must read the same in
both.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Callable, Dict, List

import torch

from . import hopper_feats as H
from .bench_dma import card_line, copy_tiled_cuda, device_us_per_call


def measurements() -> Dict[str, Callable[[], object]]:
    """{name: call} at the TPU probe's shapes on the card."""
    dev = torch.device('cuda')
    t = {k: torch.as_tensor(v, device=dev)
         for k, v in H.probe_inputs().items()}
    x, v, a, b, y, sel = (t[k] for k in ('x', 'v', 'a', 'b', 'y', 'sel'))
    xt = torch.empty(x.shape[::-1], device=dev)
    tiny = torch.ones(8, 128, device=dev)
    tiny_out = torch.empty_like(tiny)
    calls = {'floor': lambda: copy_tiled_cuda(tiny, 8, out=tiny_out),
             'floor zero_': tiny_out.zero_,
             '9a transpose': lambda: H.transpose_cuda(x, out=xt),
             '9a copy_': lambda: xt.copy_(x.t()),
             '9b split': lambda: H.split_cuda(v),
             '9c dot': lambda: H.dot_cuda(a, b),
             '9c torch.matmul': lambda: torch.matmul(a.t(), b),
             '9d window': lambda: H.window_cuda(y, sel),
             '9d index_select': lambda: torch.index_select(
                 y.view(H.N_WINDOWS, -1), 0, sel)}
    return calls


def main(argv=None) -> int:
    if not torch.cuda.is_available():
        raise RuntimeError('feats_time times the CUDA card: no CUDA device')
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--rounds', type=int, default=3)
    args = ap.parse_args(argv)
    calls = measurements()
    readings: Dict[str, List[float]] = {k: [] for k in calls}
    for r in range(args.rounds):
        for name, fn in calls.items():
            us = device_us_per_call(fn)
            print(f'round {r} {name}: ' + ('device time not measured'
                                           if us is None else
                                           f'{us:.3f} device us'),
                  flush=True)
            if us is not None:
                readings[name].append(us)
    print(card_line(), flush=True)
    print(json.dumps({k: sum(v) / len(v) if v else None
                      for k, v in readings.items()}), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
