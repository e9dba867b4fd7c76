"""D3 dispersion: the port's ``ops/d3.py`` against the JAX package's.

The same structures, neighbor lists (the native core on both sides) and
parameters go through both packages' ``d3_energy_forces_stress``; the
JAX side runs under ``jax.enable_x64(False)``, where its tables are all
float32 as the port's are (the test session turns x64 on, which would
make JAX's ``rcov`` float64).  Tolerances: energy 1e-6 relative, forces
and stress 1e-5 of max|JAX| (float32 sums over up to ~100k pairs in
another order).  Cases: zero and BJ damping, at a reduced cutoff on a
96-atom structure and at the full cutoffs (50.2 / 21.2 Bohr) on the
12-atom one.  Also: the tables, the position form ``d3_energy`` (the MD
path: its gradient is minus the forces), and ``Calculator(d3=...)``
against JAX's on a narrow model.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
FT = ROOT / 'experiments/ft_reewc/data/ft.extxyz'
TYPE_MAP = {72: 0, 8: 1}


@pytest.fixture(autouse=True, scope='module')
def _native_neighbor_list():
    """Both packages build this file's graphs with the native neighbor
    list, whatever the worker's environment holds; restored after."""
    with pytest.MonkeyPatch.context() as mp:
        mp.delenv('SEVENN_NO_NATIVE', raising=False)
        yield


torch.set_num_threads(2)


def _case(which):
    """(structure, d3_spec kwargs) of a case."""
    from sevennet_finetuning_tpu_torch.data.readers import read_extxyz

    structs = read_extxyz(str(FT))
    if which == 'reduced':
        return structs[0], dict(cutoff=14.0, cn_cutoff=10.0)
    return structs[4], {}


def _inputs(s, cutoff_bohr):
    from sevennet_finetuning_tpu_torch.data.neighborlist import neighbor_list
    from sevennet_finetuning_tpu_torch.ops.d3 import AU_TO_ANG

    i, j, shift, _ = neighbor_list(s.pos, s.cell, s.pbc,
                                   cutoff_bohr * AU_TO_ANG)
    types = np.array([TYPE_MAP[int(z)] for z in s.atomic_numbers], np.int32)
    return (np.asarray(s.pos, np.float32), types,
            np.stack([i, j]).astype(np.int32),
            np.asarray(shift, np.float32), np.asarray(s.cell, np.float32))


def _zs():
    return [z for z, _ in sorted(TYPE_MAP.items(), key=lambda kv: kv[1])]


@pytest.mark.parametrize('damping', ['zero', 'bj'])
@pytest.mark.parametrize('which', ['reduced', 'full'])
def test_d3_energy_forces_stress_match_jax(damping, which):
    import jax
    import jax.numpy as jnp

    from sevennet_finetuning_tpu.ops import d3 as jd3
    from sevennet_finetuning_tpu_torch.ops import d3

    s, kw = _case(which)
    spec = d3.d3_spec(_zs(), 'pbe', damping, **kw)
    pos, types, idx, shift, cell = _inputs(s, spec.cutoff)
    mask = np.ones(idx.shape[1], np.float32)
    got = d3.d3_energy_forces_stress(
        spec, d3.d3_static_arrays(spec), torch.as_tensor(pos),
        torch.as_tensor(types), torch.as_tensor(idx),
        torch.as_tensor(shift), torch.as_tensor(cell),
        torch.as_tensor(mask), s.volume)
    with jax.enable_x64(False):
        jspec = jd3.d3_spec(_zs(), 'pbe', damping, **kw)
        assert vars(jspec) == vars(spec)
        want = jd3.d3_energy_forces_stress(
            jspec, jd3.d3_static_arrays(jspec), jnp.asarray(pos),
            jnp.asarray(types), jnp.asarray(idx), jnp.asarray(shift),
            jnp.asarray(cell), jnp.asarray(mask), s.volume)
    e, f, st = (np.asarray(x) for x in want)
    assert e < 0
    assert abs(float(got[0]) - float(e)) <= 1e-6 * abs(float(e))
    assert np.abs(got[1].numpy() - f).max() <= 1e-5 * np.abs(f).max()
    assert np.abs(got[2].numpy() - st).max() <= 1e-5 * np.abs(st).max()


def test_d3_tables_match_jax():
    import jax

    from sevennet_finetuning_tpu.ops import d3 as jd3
    from sevennet_finetuning_tpu_torch.ops import d3

    assert d3.ZERO_DAMPING_PARAMS == jd3.ZERO_DAMPING_PARAMS
    assert d3.BJ_DAMPING_PARAMS == jd3.BJ_DAMPING_PARAMS
    zs = [72, 8, 1]
    for damping in ('zero', 'bj'):
        spec = d3.d3_spec(zs, 'pbe', damping)
        assert vars(spec) == vars(jd3.d3_spec(zs, 'pbe', damping))
    spec = d3.d3_spec(zs, params=(0.4, 0.8, 4.4, 0.9))
    assert (spec.rs6, spec.s18, spec.rs18, spec.s6) == (0.4, 0.8, 4.4, 0.9)
    with pytest.raises(ValueError):
        d3.d3_spec(zs, damping='bjm')
    got = d3.d3_static_arrays(spec)
    with jax.enable_x64(False):
        want = jd3.d3_static_arrays(jd3.d3_spec(zs, params=(0.4, 0.8, 4.4,
                                                             0.9)))
    assert set(got) == set(want)
    for k in got:
        assert got[k].dtype == torch.float32
        assert np.array_equal(got[k].numpy(), np.asarray(want[k])), k


def test_d3_energy_positions_gradient_is_minus_forces():
    """``d3_energy`` of positions (the device MD loop's form, on a
    zero-padded edge list) gives the same energy, and its autograd
    gradient minus the forces, of ``d3_energy_forces_stress``."""
    from sevennet_finetuning_tpu_torch.ops import d3

    s, kw = _case('reduced')
    spec = d3.d3_spec(_zs(), 'pbe', 'bj', **kw)
    arrays = d3.d3_static_arrays(spec)
    pos, types, idx, shift, cell = _inputs(s, spec.cutoff)
    E = idx.shape[1]
    pad = 4096 - E % 4096
    idx_p = np.concatenate([idx, np.zeros((2, pad), np.int32)], 1)
    shift_p = np.concatenate([shift, np.zeros((pad, 3), np.float32)])
    mask_p = np.concatenate([np.ones(E, np.float32),
                             np.zeros(pad, np.float32)])
    e, f, _ = d3.d3_energy_forces_stress(
        spec, arrays, torch.as_tensor(pos), torch.as_tensor(types),
        torch.as_tensor(idx), torch.as_tensor(shift), torch.as_tensor(cell),
        torch.ones(E), s.volume)
    p = torch.as_tensor(pos).requires_grad_(True)
    e2 = d3.d3_energy(spec, arrays, p, torch.as_tensor(types),
                      torch.as_tensor(idx_p), torch.as_tensor(shift_p),
                      torch.as_tensor(cell), torch.as_tensor(mask_p),
                      torch.ones(len(pos)))
    g, = torch.autograd.grad(e2, p)
    assert abs(float(e2.detach()) - float(e)) <= 1e-6 * abs(float(e))
    assert torch.isfinite(g).all()
    assert float((g + f).abs().max()) <= 1e-5 * float(f.abs().max())


def test_calculator_d3_matches_jax():
    """A narrow model with D3 (zero damping, reduced cutoffs) through both
    packages' Calculator: the D3 terms and the GNN + D3 totals (energy
    1e-6 rel, forces and stress 1e-4 of max, the serving limits)."""
    import jax

    from sevennet_finetuning_tpu.calculator import Calculator as JCalc
    from sevennet_finetuning_tpu.data.readers import read_extxyz as jread
    from sevennet_finetuning_tpu.model.build import build_model_spec as jb
    from sevennet_finetuning_tpu.model.nequip import init_params as ji
    from sevennet_finetuning_tpu_torch import keys as K
    from sevennet_finetuning_tpu_torch.calculator import Calculator
    from sevennet_finetuning_tpu_torch.data.readers import read_extxyz
    from sevennet_finetuning_tpu_torch.model.build import build_model_spec

    cfg = {K.NUM_SPECIES: 2, K.TYPE_MAP: dict(TYPE_MAP),
           K.NODE_FEATURE_MULTIPLICITY: 4, K.LMAX: 1, K.NUM_CONVOLUTION: 2,
           K.CUTOFF: 4.0, K.SHIFT: -5.0, K.SCALE: 1.0}
    d3 = {'functional': 'pbe', 'damping': 'zero', 'cutoff': 20.0,
          'cn_cutoff': 15.0}
    with jax.enable_x64(False):
        params = jax.tree_util.tree_map(np.asarray, ji(jb(cfg), 1))
        jc = JCalc(jb(cfg), params, d3=d3)
        js = jread(str(FT))[4]
        want_terms = jc.d3_terms(js)
        want = jc.calculate(js)
    pc = Calculator(build_model_spec(cfg), params, device='cpu', d3=d3)
    s = read_extxyz(str(FT))[4]
    terms = pc.d3_terms(s)
    got = pc.calculate(s)
    assert abs(terms[0] - want_terms[0]) <= 1e-6 * abs(want_terms[0])
    for a, b in zip(terms[1:], want_terms[1:]):
        assert np.abs(a - np.asarray(b)).max() <= 1e-5 * np.abs(b).max()
    assert abs(got['energy'] - want['energy']) <= 1e-6 * abs(want['energy'])
    for k in ('forces', 'stress', 'stress_kbar'):
        w = np.asarray(want[k])
        assert np.abs(got[k] - w).max() <= 1e-4 * np.abs(w).max(), k


def test_dispersion_travels_with_the_checkpoint(tmp_path):
    """``from_checkpoint`` takes D3 from the config's 'dispersion' key."""
    from sevennet_finetuning_tpu_torch import keys as K
    from sevennet_finetuning_tpu_torch.calculator import Calculator
    from sevennet_finetuning_tpu_torch.model.build import build_model_spec
    from sevennet_finetuning_tpu_torch.model.nequip import init_params
    from sevennet_finetuning_tpu_torch.train.checkpoint import (
        save_checkpoint, save_deployed)

    cfg = {K.NUM_SPECIES: 2, K.TYPE_MAP: dict(TYPE_MAP),
           K.NODE_FEATURE_MULTIPLICITY: 4, K.LMAX: 1, K.NUM_CONVOLUTION: 2,
           K.CUTOFF: 4.0}
    params = init_params(build_model_spec(cfg), 0)
    save_checkpoint(str(tmp_path / 'plain.pth'), params, cfg)
    assert Calculator.from_checkpoint(str(tmp_path / 'plain.pth'),
                                      device='cpu').d3 is None
    cfg[K.DISPERSION] = {'functional': 'pbe', 'damping': 'zero'}
    save_checkpoint(str(tmp_path / 'd3.pth'), params, cfg)
    calc = Calculator.from_checkpoint(str(tmp_path / 'd3.pth'), device='cpu')
    assert calc.d3['spec'].damping == 'zero'
    assert calc.d3['spec'].zs == (72, 8)
    # the deploy artifact does not carry D3 into from_deployed (JAX's
    # behaviour); from_checkpoint of the artifact does
    save_deployed(str(tmp_path / 'd3.sevenn'), params, cfg)
    assert Calculator.from_deployed(str(tmp_path / 'd3.sevenn'),
                                    device='cpu').d3 is None
    assert Calculator.from_checkpoint(str(tmp_path / 'd3.sevenn'),
                                      device='cpu').d3 is not None
