"""The comparison that decides ``correct`` catches the timed path broken
underneath: each cell's run at its tiny CPU size, past the harness's look
for a card, with one fault planted in the program, must come out not
correct.  The faults: a step that returns its state unchanged, half of the
batch left out with the mean taken over the rest, and an answer altered
where it is produced (one cell has no exchange between chips)."""

import time

import pytest
import torch

from benchmark import faults as F


def run(cell, tiny, root):
    from benchmark.harness import run_cell

    torch.set_num_threads(2)
    # a window long enough for every structure of the tiny pool, on a busy
    # host too: a window of one request cannot show a stale answer
    return run_cell(cell, 2 ** 33 + 5, 1.0, False, time.perf_counter(),
                    device='cpu', overrides=tiny[cell], root=root,
                    log=lambda *a: None)


FAULTS = [(cell, name, plant) for cell, faults in F.FAULTS.items()
          for name, plant in faults.items()]


@pytest.mark.parametrize('cell,fault,plant', FAULTS,
                         ids=[f'{c}-{f}' for c, f, _ in FAULTS])
def test_a_planted_fault_comes_out_not_correct(cell, fault, plant, tiny,
                                               monkeypatch, root_of):
    plant(monkeypatch.setattr)
    out = run(cell, tiny, root_of(cell))
    assert out['correct'] is False, out['checks']
