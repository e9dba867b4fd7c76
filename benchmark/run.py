#!/usr/bin/env python3
"""Run one benchmark cell of the PyTorch/CUDA port.

    python3 benchmark/run.py --workload sevennet0.reewc_train --seed 7 \
        --seconds 20 --trace 0

from the root of a checkout.  The last line of standard output is the
result (``correct``, ``attempted``, ``failed``, ``metrics``, ``device``,
with ``--trace 1`` also ``breakdown``, and last ``checks``: each number
compared with its limit); the checks are also the last lines of standard
error.  Exits non-zero with no result where there is no card, too few
cards, a module of JAX or of the JAX package was loaded, or the program is
missing.  ``--control 1`` judges the plain reference at the
next precision down in the program's place instead of the program, and
``--fault NAME`` plants one of ``faults.FAULTS`` in the program: both must
come out not correct (they read the limits' upper ends; never part of a
timed run).
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import traceback  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
# every build and kernel cache inside the checkout, at fixed paths
CACHE = ROOT / 'build' / 'bench_cache'
os.environ['TRITON_CACHE_DIR'] = str(CACHE / 'triton')
os.environ['TORCH_EXTENSIONS_DIR'] = str(CACHE / 'torch_extensions')
os.environ['CUDA_CACHE_PATH'] = str(CACHE / 'cuda')
os.environ.setdefault('USE_FLAX', '0')
sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--workload', required=True)
    ap.add_argument('--seed', type=int, required=True)
    ap.add_argument('--seconds', type=float, required=True)
    ap.add_argument('--trace', type=int, choices=(0, 1), default=0)
    ap.add_argument('--control', type=int, choices=(0, 1), default=0)
    ap.add_argument('--fault', default='')
    args = ap.parse_args(argv)
    from benchmark.harness import RunError, format_checks, run_cell

    def log(*a):
        print(*a, file=sys.stderr, flush=True)

    if args.fault:
        from benchmark.faults import FAULTS

        FAULTS[args.workload][args.fault](setattr)
    try:
        out = run_cell(args.workload, args.seed, args.seconds,
                       bool(args.trace), T_START, control=bool(args.control),
                       log=log)
    except RunError as e:
        log(f'[bench] no result: {e}')
        return 2
    except Exception:  # noqa: BLE001 -- a run that fails prints no result
        log(traceback.format_exc())
        return 1
    for line in format_checks(out['checks']):
        log(line)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
