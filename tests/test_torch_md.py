"""Molecular dynamics: the port's ``VelocityVerlet`` against the JAX
package's, on the narrow model of ``tests/test_md_device.py`` (2 species,
4 channels, lmax 1, 2 convolutions, cutoff 3 A) and on the FCTP
(``self_connection_type: nequip``) model of ``EXAMPLE_MD_MODEL``.

Both packages build their neighbor lists with the native core here
(the same edge order); the JAX side runs under ``jax.enable_x64(False)``
(the test session turns x64 on, which moves JAX's D3 ``rcov`` to
float64).  Tolerances:

- ``run_device``: the same steps per segment (``done``), positions
  within 1e-5 A + 1e-4 rel, velocities 1e-6 + 1e-3 rel, E_pot 1e-5 rel,
  E_kin 1e-4 rel (float32 sums in another order);
- ``run`` (NVE and seeded Langevin): the same limits;
- NVE drift of the port's device loop under 5e-4 eV/atom over 40 steps,
  the JAX package's own bound.

The golden file ``golden/md_hfo2_jax_cpu.npz`` is what ``chip_smoke.py``
holds the card against: JAX ``VelocityVerlet.run_device`` with SevenNet-0
(the in-repo checkpoint) on structure 0 of ft900.extxyz (96-atom HfO2;
500 K, seed 0, dt 2 fs, skin 0.5 A, seg_steps 10), 20 steps without D3
and 10 with D3 (pbe, bj): E_pot and E_kin per step, steps per segment,
final positions and velocities; and the JAX Calculator's D3 terms
(pbe, bj) and GNN + D3 totals for the five structures of ft.extxyz.
Regenerate it with (JAX on the CPU, about ten minutes):

    PYTHONPATH=. python tests/test_torch_md.py
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
CKPT = ROOT / 'experiments/ft_reewc_900/conv_out/checkpoint_best.pth'
FT = ROOT / 'experiments/ft_reewc/data/ft.extxyz'
FT900 = ROOT / 'experiments/ft_reewc_900/data/ft900.extxyz'
GOLDEN_MD = ROOT / 'sevennet_finetuning_tpu_torch/golden/md_hfo2_jax_cpu.npz'
# the golden run's settings; chip_smoke.py's md phase keeps its own copy
# (it imports nothing of the tests), which
# test_chip_smoke_reads_the_golden_settings holds equal to this one
MD = dict(T=500.0, seed=0, dt=2.0, skin=0.5, seg_steps=10, n_steps=20,
          n_steps_d3=10)
D3 = {'functional': 'pbe', 'damping': 'bj'}


@pytest.fixture(autouse=True, scope='module')
def _native_neighbor_list():
    """Both packages build this file's graphs with the native neighbor
    list, whatever the worker's environment holds; restored after."""
    with pytest.MonkeyPatch.context() as mp:
        mp.delenv('SEVENN_NO_NATIVE', raising=False)
        yield


torch.set_num_threads(2)


class _Lines:
    """A logger that keeps the lines written to it."""

    def __init__(self):
        self.lines = []

    def writeline(self, line):
        self.lines.append(line)


def _segments(lines):
    return [int(ln.split()[1]) for ln in lines if ln.startswith('segment:')]


def _narrow_cfg(**over):
    from sevennet_finetuning_tpu_torch import keys as K

    cfg = {
        K.NUM_SPECIES: 2, K.TYPE_MAP: {8: 0, 72: 1},
        K.NODE_FEATURE_MULTIPLICITY: 4, K.LMAX: 1,
        K.NUM_CONVOLUTION: 2, K.CUTOFF: 3.0, K.IS_PARITY: False,
        K.SELF_CONNECTION_TYPE: 'linear', K.CONV_DENOMINATOR: 10.0,
        K.SHIFT: 0.0, K.SCALE: 1.0,
    }
    cfg.update(over)
    return cfg


def _fctp_cfg():
    from sevennet_finetuning_tpu_torch import keys as K
    from sevennet_finetuning_tpu_torch.compat.known_models import (
        EXAMPLE_MD_MODEL)

    return {K.NUM_SPECIES: 2, K.TYPE_MAP: {8: 0, 72: 1}, K.CUTOFF: 3.0,
            K.CONV_DENOMINATOR: 10.0, **EXAMPLE_MD_MODEL}


def _calcs(cfg, d3=None):
    """(JAX Calculator, port CPU Calculator) on init_params(spec, 0)."""
    import jax

    from sevennet_finetuning_tpu.calculator import Calculator as JCalc
    from sevennet_finetuning_tpu.model.build import build_model_spec as jb
    from sevennet_finetuning_tpu.model.nequip import init_params as ji
    from sevennet_finetuning_tpu_torch.calculator import Calculator
    from sevennet_finetuning_tpu_torch.model.build import build_model_spec

    with jax.enable_x64(False):
        spec = jb(cfg)
        params = ji(spec, 0)
        jc = JCalc(spec, params, d3=d3)
    p_np = {g: {n: np.asarray(v) for n, v in d.items()}
            for g, d in params.items()}
    return jc, Calculator(build_model_spec(cfg), p_np, device='cpu', d3=d3)


def _structure(cls, seed=3, n=12, a=8.0):
    rng = np.random.default_rng(seed)
    return cls(
        species=['Hf' if i % 3 == 0 else 'O' for i in range(n)],
        pos=rng.uniform(0, a, (n, 3)),
        cell=np.eye(3) * a,
    )


def _pair(jc, pc, T=300.0, vseed=2, dt=0.5, **kw):
    """The same start in both packages: (JAX VelocityVerlet, port's)."""
    from sevennet_finetuning_tpu.data.vasp import Structure as JS
    from sevennet_finetuning_tpu.md import VelocityVerlet as JVV
    from sevennet_finetuning_tpu_torch.data.vasp import Structure
    from sevennet_finetuning_tpu_torch.md import VelocityVerlet

    skw = dict(kw)
    jv = JVV(_structure(JS, **skw), calculator=jc, dt_fs=dt)
    pv = VelocityVerlet(_structure(Structure, **skw), calculator=pc,
                        dt_fs=dt)
    jv.set_temperature(T, seed=vseed)
    pv.set_temperature(T, seed=vseed)
    return jv, pv


def _assert_close(jv, pv, n_steps, pos_atol=1e-5, e_rtol=1e-5):
    assert len(pv.result.energies) == len(jv.result.energies) == n_steps
    np.testing.assert_allclose(pv.s.pos, jv.s.pos, rtol=1e-4,
                               atol=pos_atol)
    np.testing.assert_allclose(pv.vel, jv.vel, rtol=1e-3, atol=1e-6)
    np.testing.assert_allclose(pv.result.energies, jv.result.energies,
                               rtol=e_rtol, atol=1e-6)
    np.testing.assert_allclose(pv.result.kinetic, jv.result.kinetic,
                               rtol=1e-4, atol=1e-7)


@pytest.fixture(scope='module')
def narrow():
    return _calcs(_narrow_cfg())


def test_masses_and_start_velocities_match_jax():
    from sevennet_finetuning_tpu import md as jmd
    from sevennet_finetuning_tpu.data.vasp import Structure as JS
    from sevennet_finetuning_tpu_torch import md
    from sevennet_finetuning_tpu_torch.data.vasp import Structure

    assert md.ATOMIC_MASSES == jmd.ATOMIC_MASSES
    assert (md.ACC_UNIT, md.KB_EV) == (jmd.ACC_UNIT, jmd.KB_EV)
    sp = ['Hf', 'O', 'Xx']
    assert np.array_equal(md.masses_of(sp), jmd.masses_of(sp))
    jv = jmd.VelocityVerlet(_structure(JS), dt_fs=1.0)
    pv = md.VelocityVerlet(_structure(Structure), dt_fs=1.0)
    jv.set_temperature(500.0, seed=7)
    pv.set_temperature(500.0, seed=7)
    assert np.array_equal(pv.vel, jv.vel)
    assert pv.kinetic_energy() == jv.kinetic_energy()
    assert pv.temperature() == jv.temperature()


@pytest.mark.parametrize('seg_steps', [4, 16])
def test_run_device_matches_jax(narrow, seg_steps):
    import jax

    jc, pc = narrow
    jv, pv = _pair(jc, pc)
    lines = _Lines()
    with jax.enable_x64(False):
        jv.run_device(10, seg_steps=seg_steps, logger=lines)
    pv.run_device(10, seg_steps=seg_steps)
    assert pv.result.segments == _segments(lines.lines)
    _assert_close(jv, pv, 10)


def test_run_device_skin_trips_match_jax(narrow):
    """A hot start: the skin check ends segments early (done < seg_steps),
    at the same steps in both packages."""
    import jax

    jc, pc = narrow
    jv, pv = _pair(jc, pc, T=3000.0, dt=2.0)
    lines = _Lines()
    with jax.enable_x64(False):
        jv.run_device(12, seg_steps=12, logger=lines)
    pv.run_device(12, seg_steps=12)
    assert pv.result.segments == _segments(lines.lines)
    assert len(pv.result.segments) > 1
    _assert_close(jv, pv, 12, pos_atol=1e-4)


def test_run_nve_matches_jax(narrow):
    import jax

    jc, pc = narrow
    jv, pv = _pair(jc, pc)
    with jax.enable_x64(False):
        jv.run(6)
    pv.run(6)
    _assert_close(jv, pv, 6)


def test_run_langevin_matches_jax(narrow):
    """A seeded BAOAB run: the same host generator, the same noise."""
    import jax

    jc, pc = narrow
    jv, pv = _pair(jc, pc)
    thermo = dict(kind='langevin', T=400.0, tau_fs=20.0)
    with jax.enable_x64(False):
        jv.run(6, thermostat=thermo, seed=5)
    pv.run(6, thermostat=thermo, seed=5)
    _assert_close(jv, pv, 6)
    with pytest.raises(ValueError, match='langevin'):
        pv.run(1, thermostat=dict(kind='berendsen', T=300.0))


def test_run_device_matches_run(narrow):
    """The port's device loop against its own host loop (the JAX
    package's test_run_device_matches_host_loop)."""
    from sevennet_finetuning_tpu_torch.data.vasp import Structure
    from sevennet_finetuning_tpu_torch.md import VelocityVerlet

    pc = narrow[1]
    host = VelocityVerlet(_structure(Structure), calculator=pc, dt_fs=0.5)
    dev = VelocityVerlet(_structure(Structure), calculator=pc, dt_fs=0.5)
    host.set_temperature(300.0, seed=2)
    dev.set_temperature(300.0, seed=2)
    host.run(10)
    dev.run_device(10, seg_steps=4)
    assert dev.result.segments == [4, 4, 2]
    np.testing.assert_allclose(dev.s.pos, host.s.pos, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(dev.vel, host.vel, rtol=1e-3, atol=1e-6)
    np.testing.assert_allclose(dev.result.energies, host.result.energies,
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(dev.result.kinetic, host.result.kinetic,
                               rtol=1e-4, atol=1e-7)


def test_run_device_energy_conservation(narrow):
    from sevennet_finetuning_tpu_torch.data.vasp import Structure
    from sevennet_finetuning_tpu_torch.md import VelocityVerlet

    md = VelocityVerlet(_structure(Structure, seed=5), calculator=narrow[1],
                        dt_fs=0.25)
    md.set_temperature(150.0, seed=1)
    md.run_device(40, seg_steps=16)
    tot = np.array(md.result.total)
    assert np.all(np.isfinite(tot))
    drift = abs(tot[-1] - tot[0]) / len(md.s.pos)
    assert drift < 5e-4, f'NVE drift {drift} eV/atom over 40 steps'


def test_run_device_d3_matches_jax():
    """D3 inside the device loop, on its own skin-padded edge list (at a
    reduced cutoff to keep the CPU run short)."""
    import jax

    jc, pc = _calcs(_narrow_cfg(), d3=dict(D3, cutoff=15.0, cn_cutoff=12.0))
    jv, pv = _pair(jc, pc)
    lines = _Lines()
    with jax.enable_x64(False):
        jv.run_device(6, seg_steps=4, logger=lines)
    pv.run_device(6, seg_steps=4)
    assert pv.result.segments == _segments(lines.lines)
    _assert_close(jv, pv, 6)


def test_fctp_model_run_device_matches_jax():
    """EXAMPLE_MD_MODEL's architecture (FCTP self-connection, parity,
    unnormalized spherical harmonics) through 5 device-loop steps."""
    import jax

    jc, pc = _calcs(_fctp_cfg())
    jv, pv = _pair(jc, pc)
    lines = _Lines()
    with jax.enable_x64(False):
        jv.run_device(5, seg_steps=5, logger=lines)
    pv.run_device(5, seg_steps=5)
    assert pv.result.segments == _segments(lines.lines)
    _assert_close(jv, pv, 5)


def test_golden_file_layout():
    """The golden file holds what chip_smoke.py reads, finite, with the
    steps per segment adding up to each run's length."""
    gold = np.load(GOLDEN_MD)
    for tag, n in (('md', MD['n_steps']), ('md_d3', MD['n_steps_d3'])):
        assert gold[f'{tag}_epot'].shape == (n,)
        assert gold[f'{tag}_ekin'].shape == (n,)
        assert int(gold[f'{tag}_done'].sum()) == n
        assert gold[f'{tag}_pos'].shape == (96, 3)
        assert gold[f'{tag}_vel'].shape == (96, 3)
        for k in ('epot', 'ekin', 'pos', 'vel'):
            assert np.isfinite(gold[f'{tag}_{k}']).all()
    assert gold['d3_energy'].shape == (5,)
    assert gold['total_energy'].shape == (5,)
    assert gold['d3_stress'].shape == (5, 6)
    assert (gold['d3_energy'] < 0).all()


# --- the golden file ------------------------------------------------------

def _jax_md(calc, s, n_steps):
    from sevennet_finetuning_tpu.md import VelocityVerlet as JVV

    vv = JVV(s, calculator=calc, dt_fs=MD['dt'], skin=MD['skin'])
    vv.set_temperature(MD['T'], seed=MD['seed'])
    lines = _Lines()
    vv.run_device(n_steps, seg_steps=MD['seg_steps'], logger=lines)
    return dict(epot=np.array(vv.result.energies, np.float64),
                ekin=np.array(vv.result.kinetic, np.float64),
                done=np.array(_segments(lines.lines), np.int64),
                pos=np.asarray(vv.s.pos, np.float64),
                vel=np.asarray(vv.vel, np.float64))


def _write_golden():
    from sevennet_finetuning_tpu.calculator import Calculator
    from sevennet_finetuning_tpu.data.readers import read_extxyz

    base = Calculator.from_checkpoint(str(CKPT))
    calc = Calculator(base.spec, base.params, d3=D3)
    arrays = {}
    structs = read_extxyz(str(FT))
    rows = [calc.d3_terms(s) for s in structs]
    arrays['d3_energy'] = np.array([r[0] for r in rows], np.float64)
    arrays['d3_stress'] = np.stack([np.asarray(r[2], np.float64)
                                    for r in rows])
    totals = [calc.calculate(s) for s in structs]
    arrays['total_energy'] = np.array([t['energy'] for t in totals],
                                      np.float64)
    arrays['total_stress'] = np.stack([np.asarray(t['stress'], np.float64)
                                       for t in totals])
    for i, (r, t) in enumerate(zip(rows, totals)):
        arrays[f'd3_forces_{i}'] = np.asarray(r[1], np.float64)
        arrays[f'total_forces_{i}'] = np.asarray(t['forces'], np.float64)
    print('d3 terms', arrays['d3_energy'], flush=True)
    s0 = read_extxyz(str(FT900))[0]
    for tag, c, n in (('md', base, MD['n_steps']),
                      ('md_d3', calc, MD['n_steps_d3'])):
        res = _jax_md(c, s0, n)
        for k, v in res.items():
            arrays[f'{tag}_{k}'] = v
        print(tag, 'done', res['done'], 'epot', res['epot'], flush=True)
    GOLDEN_MD.parent.mkdir(parents=True, exist_ok=True)
    np.savez(GOLDEN_MD, **arrays)
    print(f'wrote {GOLDEN_MD}')


if __name__ == '__main__':
    sys.path.insert(0, str(ROOT))
    import jax

    jax.config.update('jax_platforms', 'cpu')
    _write_golden()


def test_chip_smoke_reads_the_golden_settings():
    """chip_smoke.py's md phase runs the golden's settings."""
    sys.path.insert(0, str(ROOT))
    import chip_smoke

    assert chip_smoke.MD == MD and chip_smoke.MD_D3 == D3
    assert chip_smoke.GOLDEN_MD == GOLDEN_MD
