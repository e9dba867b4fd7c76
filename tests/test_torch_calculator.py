"""Full-width parity: the port's CPU Calculator against the JAX Calculator
on the in-repo SevenNet-0 checkpoint, plus the golden file and the
jax-free import check.

Tolerances: energy rel 2e-6; forces and stress max-abs rel 1e-5 (float32
sums taken in another order over ~4,300 edges and five layers).

The golden file (energies, forces and stress for every structure of
ft.extxyz, computed by the JAX Calculator on the CPU) is what
``chip_smoke.py`` holds the GPU run against.  Regenerate it with

    python tests/test_torch_calculator.py
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
CKPT = ROOT / 'experiments/ft_reewc_900/conv_out/checkpoint_best.pth'
FT = ROOT / 'experiments/ft_reewc/data/ft.extxyz'
GOLDEN = ROOT / 'sevennet_finetuning_tpu_torch/golden/ft_extxyz_jax_cpu.npz'

torch.set_num_threads(2)


def _jax_results(n=None):
    from sevennet_finetuning_tpu.calculator import Calculator
    from sevennet_finetuning_tpu.data.readers import read_extxyz

    calc = Calculator.from_checkpoint(str(CKPT))
    return [calc.calculate(s) for s in read_extxyz(str(FT))[:n]]


def _rel(a, b):
    return float(np.abs(np.asarray(a) - np.asarray(b)).max()
                 / np.abs(np.asarray(b)).max())


@pytest.fixture(scope='module')
def jax_two():
    return _jax_results(2)


@pytest.fixture(scope='module')
def port_two():
    from sevennet_finetuning_tpu_torch.calculator import Calculator
    from sevennet_finetuning_tpu_torch.data.readers import read_extxyz

    calc = Calculator.from_checkpoint(str(CKPT), device='cpu')
    return [calc.calculate(s) for s in read_extxyz(str(FT))[:2]]


@pytest.mark.parametrize('i', [0, 1])
def test_full_width_matches_jax(jax_two, port_two, i):
    want, got = jax_two[i], port_two[i]
    assert abs(got['energy'] - want['energy']) <= 2e-6 * abs(want['energy'])
    assert _rel(got['forces'], want['forces']) <= 1e-5
    assert _rel(got['stress'], want['stress']) <= 1e-5
    assert _rel(got['energies'], want['energies']) <= 1e-5


def test_golden_file_matches_jax(jax_two):
    gold = np.load(GOLDEN)
    assert gold['energy'].shape == (5,) and gold['stress'].shape == (5, 6)
    for i, want in enumerate(jax_two):
        assert abs(gold['energy'][i] - want['energy']) <= 2e-6 * abs(
            want['energy'])
        assert _rel(gold[f'forces_{i}'], want['forces']) <= 1e-5
        assert _rel(gold['stress'][i], want['stress']) <= 1e-5


def test_port_imports_no_jax():
    code = (
        'import sys\n'
        'from sevennet_finetuning_tpu_torch.calculator import Calculator\n'
        'from sevennet_finetuning_tpu_torch.data.readers import read_extxyz\n'
        f'calc = Calculator.from_checkpoint({str(CKPT)!r}, device="cpu")\n'
        f's = read_extxyz({str(FT)!r})[4]\n'
        'r = calc.calculate(s)\n'
        'assert r["forces"].shape == (len(s), 3)\n'
        'bad = sorted(m for m in sys.modules if m.split(".")[0] in '
        '("jax", "jaxlib", "optax") or m.split(".")[0] == '
        '"sevennet_finetuning_tpu")\n'
        'print("BAD", bad)\n'
        'assert not bad, bad\n'
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    res = subprocess.run([sys.executable, '-c', code], cwd=str(ROOT),
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    assert 'BAD []' in res.stdout


def test_entry_points_need_cuda_unless_asked(monkeypatch):
    from sevennet_finetuning_tpu_torch import resolve_device
    from sevennet_finetuning_tpu_torch.calculator import Calculator

    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='CUDA'):
        resolve_device(None)
    with pytest.raises(RuntimeError, match='CUDA'):
        Calculator.from_checkpoint(str(CKPT))
    assert resolve_device('cpu') == torch.device('cpu')


def test_dispersion_is_refused():
    from sevennet_finetuning_tpu_torch.calculator import Calculator
    from sevennet_finetuning_tpu_torch.model.build import build_model_spec
    from sevennet_finetuning_tpu_torch.train.checkpoint import (
        load_checkpoint)

    blob = load_checkpoint(str(CKPT))
    assert blob['optimizer_state_dict'] is None
    spec = build_model_spec(blob['config'])
    with pytest.raises(NotImplementedError, match='D3'):
        Calculator(spec, blob['model_state_dict'], device='cpu',
                   dispersion={'functional': 'pbe', 'damping': 'bj'})


def _write_golden():
    res = _jax_results()
    arrays = {
        'energy': np.array([r['energy'] for r in res], np.float64),
        'stress': np.stack([np.asarray(r['stress'], np.float64)
                            for r in res]),
    }
    for i, r in enumerate(res):
        arrays[f'forces_{i}'] = np.asarray(r['forces'], np.float64)
    GOLDEN.parent.mkdir(parents=True, exist_ok=True)
    np.savez(GOLDEN, **arrays)
    print(f'wrote {GOLDEN}: energies {arrays["energy"]}')


if __name__ == '__main__':
    sys.path.insert(0, str(ROOT))
    import jax

    jax.config.update('jax_platforms', 'cpu')
    _write_golden()
