"""No run loads JAX or the JAX package, and the reference loads nothing of
the program.  Module names are compared by their top-level name whole:
the port's name begins with the JAX package's."""

import json
import subprocess
import sys
from pathlib import Path

import pytest

from benchmark.tests.conftest import CELLS, ROOT, WAITING_CELLS

RUN = '''
import json, sys, time
from pathlib import Path
sys.path.insert(0, {root!r})
import torch
torch.set_num_threads(2)
from benchmark.harness import forbidden_modules, run_cell
out = run_cell({cell!r}, 11, 0.3, False, time.perf_counter(), device='cpu',
               overrides=json.loads({over!r}), root=Path({cell_root!r}),
               log=lambda *a: None)
print(json.dumps({{'correct': out['correct'],
                  'found': forbidden_modules(),
                  'port': 'sevennet_finetuning_tpu_torch' in sys.modules}}))
'''


@pytest.mark.parametrize('cell', CELLS + WAITING_CELLS)
def test_a_cpu_run_loads_no_jax(cell, tiny, root_of):
    code = RUN.format(root=str(ROOT), cell=cell, cell_root=str(root_of(cell)),
                      over=json.dumps(tiny[cell]))
    res = subprocess.run([sys.executable, '-c', code], capture_output=True,
                         text=True, timeout=600, cwd=ROOT)
    assert res.returncode == 0, res.stderr[-2000:]
    got = json.loads(res.stdout.strip().splitlines()[-1])
    assert got['found'] == [] and got['port'] and got['correct']


def test_the_reference_imports_nothing_of_the_program():
    code = (f'import sys; sys.path.insert(0, {str(ROOT)!r})\n'
            'import benchmark.reference.model, benchmark.reference.train\n'
            'import benchmark.reference.md, benchmark.reference.graph\n'
            'import benchmark.reference.checkpoint as c\n'
            "c.load('experiments/ft_reewc_900/conv_out/checkpoint_best.pth')\n"
            'print(sorted({n.split(".")[0] for n in sys.modules}))')
    res = subprocess.run([sys.executable, '-c', code], capture_output=True,
                         text=True, timeout=300, cwd=ROOT)
    assert res.returncode == 0, res.stderr[-2000:]
    tops = set(eval(res.stdout.strip().splitlines()[-1]))
    assert not tops & {'jax', 'jaxlib', 'flax', 'optax',
                       'sevennet_finetuning_tpu',
                       'sevennet_finetuning_tpu_torch'}


def test_the_forbidden_check_compares_whole_top_level_names(monkeypatch):
    import types

    from benchmark.harness import forbidden_modules

    monkeypatch.setitem(sys.modules, 'sevennet_finetuning_tpu_torch_x',
                        types.ModuleType('x'))
    assert 'sevennet_finetuning_tpu' not in forbidden_modules()
    monkeypatch.setitem(sys.modules, 'jax.numpy', types.ModuleType('y'))
    assert forbidden_modules() == ['jax']
