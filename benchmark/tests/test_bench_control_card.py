"""The control on the card: the plain reference in the program's place at
TF32 (the next precision below the configurations' float32), at each
cell's own size, must come out not correct: held by the harness's own
comparison, it fails at least one of the cell's limits.  Run on a
card with

    python -m pytest benchmark/tests -m card
"""

import json
import time
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
CELLS = [w['name'] for w in
         json.loads((ROOT / 'BENCHMARK.json').read_text())['workloads']]


@pytest.mark.card
@pytest.mark.parametrize('cell', CELLS)
def test_the_control_comes_out_not_correct(cell, card):
    from benchmark.harness import run_cell

    for seed in (2 ** 34 + 1, 2 ** 34 + 2, 2 ** 34 + 3):
        out = run_cell(cell, seed, 3.0, False, time.perf_counter(),
                       device=card, control=True, log=lambda *a: None)
        assert out['correct'] is False, (seed, out['checks'])
