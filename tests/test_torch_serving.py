"""Serving leftovers of the port against the JAX package, on the CPU.

- ``fctp_spec``, ``apply_tp`` and ``init_tp_weights`` against JAX's on
  numpy-seeded inputs (1e-6 relative to max|JAX|; instructions and
  weights equal); ``apply_tp`` leaves per-edge 'uvu' TPs to the fused
  convolution;
- the deploy artifact: ``save_deployed`` / ``load_deployed`` both ways
  between the packages (arrays and config equal), ``load_checkpoint`` of
  it, ``Calculator.from_deployed`` against JAX's (energy 1e-6 rel,
  forces and stress 1e-4 of max, the serving limits: the narrow random
  model's forces are ~1e-2 eV/A, float32 residues of ~1 eV/A terms);
- ``replicate``, ``brace_expand``, ``_parse_index``, ``write_extxyz``
  (the same text as JAX's);
- the native neighbor list: the same edge set as the cKDTree path, and
  the same arrays as the JAX package's native core;
- ``inference_main`` and ``main get_model`` / ``main inference`` (with
  D3) against the JAX package's ``inference_main`` / ``cmd_get_model`` /
  ``cmd_inference`` on a narrow checkpoint (energies 1e-5 relative to
  the column's max, forces and stress 1e-4, the serving limits: the
  narrow model's forces are ~2e-3 eV/A and its stress ~2e-3 kbar,
  float32 residues of cancelling terms; errors.txt within its printed
  digits);
- a reference torch ``.pth`` through ``load_checkpoint``,
  ``Calculator.from_checkpoint``, ``main get_model -ts`` and the ASE
  adapter (``tests/test_torch_compat.py`` holds them against JAX).

The JAX side runs under ``jax.enable_x64(False)`` where it computes.
"""

import argparse
import csv
import os
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
FT = ROOT / 'experiments/ft_reewc/data/ft.extxyz'
FT900 = ROOT / 'experiments/ft_reewc_900/data/ft900.extxyz'
REPLAY = ROOT / 'experiments/ft_reewc/data/replay.extxyz'


@pytest.fixture(autouse=True, scope='module')
def _native_neighbor_list():
    """Both packages build this file's graphs with the native neighbor
    list, whatever the worker's environment holds; restored after."""
    with pytest.MonkeyPatch.context() as mp:
        mp.delenv('SEVENN_NO_NATIVE', raising=False)
        yield


torch.set_num_threads(2)


def _irreps_cases():
    return [('4x0e+4x1o', '2x0e', '4x0e+4x1o+4x1e'),
            ('8x0e+4x1e+2x2e', '3x0e', '8x0e+4x1e+2x2e+6x0o')]


@pytest.mark.parametrize('case', range(2))
def test_fctp_spec_and_apply_tp_uvw_match_jax(case):
    import jax
    import jax.numpy as jnp

    from sevennet_finetuning_tpu.irreps import Irreps as JI
    from sevennet_finetuning_tpu.ops import tensor_product as jtp
    from sevennet_finetuning_tpu_torch.irreps import Irreps
    from sevennet_finetuning_tpu_torch.ops import tensor_product as tp

    a, b, c = _irreps_cases()[case]
    js = jtp.fctp_spec(JI(a), JI(b), JI(c))
    ps = tp.fctp_spec(Irreps(a), Irreps(b), Irreps(c))
    assert [tuple(vars(i).values()) for i in ps.instructions] == \
        [tuple(vars(i).values()) for i in js.instructions]
    jw = jtp.init_tp_weights(js, np.random.default_rng(4))
    pw = tp.init_tp_weights(ps, np.random.default_rng(4))
    assert all(np.array_equal(x, y) for x, y in zip(jw, pw))
    rng = np.random.default_rng(5)
    x1 = rng.standard_normal((7, ps.irreps_in1.dim)).astype(np.float32)
    x2 = rng.standard_normal((7, ps.irreps_in2.dim)).astype(np.float32)
    with jax.enable_x64(False):
        want = np.asarray(jtp.apply_tp(js, jnp.asarray(x1), jnp.asarray(x2),
                                       [jnp.asarray(w) for w in jw]))
    got = tp.apply_tp(ps, torch.as_tensor(x1), torch.as_tensor(x2),
                      [torch.as_tensor(w) for w in pw]).numpy()
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max()


def test_apply_tp_refuses_per_edge_weights():
    from sevennet_finetuning_tpu_torch.irreps import Irreps
    from sevennet_finetuning_tpu_torch.ops import tensor_product as tp

    spec = tp.uvu_tp_spec(Irreps('4x0e+2x1e'), Irreps('1x0e+1x1e'),
                          Irreps('0e+1e'))
    with pytest.raises(NotImplementedError, match='fused_conv'):
        tp.apply_tp(spec, torch.zeros(1, 10), torch.zeros(1, 4),
                    torch.zeros(1, spec.weight_numel))


# --- a narrow checkpoint and its deploy artifact -----------------------------

def _narrow_config():
    from sevennet_finetuning_tpu_torch import keys as K

    return {K.NUM_SPECIES: 2, K.TYPE_MAP: {72: 0, 8: 1},
            K.NODE_FEATURE_MULTIPLICITY: 4, K.LMAX: 1, K.NUM_CONVOLUTION: 2,
            K.CUTOFF: 4.0, K.IS_PARITY: True,
            K.SELF_CONNECTION_TYPE: 'nequip', K.CONV_DENOMINATOR: 10.0,
            K.SHIFT: -5.0, K.SCALE: 1.5}


@pytest.fixture(scope='module')
def narrow_ckpt(tmp_path_factory):
    """A pickle checkpoint of a narrow FCTP model (JAX init_params)."""
    import jax

    from sevennet_finetuning_tpu.model.build import build_model_spec as jb
    from sevennet_finetuning_tpu.model.nequip import init_params as ji
    from sevennet_finetuning_tpu_torch.train.checkpoint import (
        save_checkpoint)

    cfg = _narrow_config()
    with jax.enable_x64(False):
        params = jax.tree_util.tree_map(np.asarray, ji(jb(cfg), 2))
    path = tmp_path_factory.mktemp('ckpt') / 'checkpoint_best.pth'
    save_checkpoint(str(path), params, cfg, epoch=3)
    return path, params


def _same_tree(a, b):
    assert set(a) == set(b)
    for g in a:
        assert set(a[g]) == set(b[g]), g
        for n in a[g]:
            assert np.array_equal(np.asarray(a[g][n]), np.asarray(b[g][n])), \
                (g, n)


def test_deployed_artifact_both_ways(narrow_ckpt, tmp_path):
    from sevennet_finetuning_tpu.train import checkpoint as jck
    from sevennet_finetuning_tpu_torch.train import checkpoint as ck

    path, params = narrow_ckpt
    cfg = _narrow_config()
    ck.save_deployed(str(tmp_path / 'port.sevenn'), params, cfg)
    jck.save_deployed(str(tmp_path / 'jax.sevenn'), params, cfg)
    for name in ('port.sevenn', 'jax.sevenn'):
        for load in (ck.load_deployed, jck.load_deployed):
            p, c = load(str(tmp_path / name))
            _same_tree(p, params)
            assert c == cfg
        blob = ck.load_checkpoint(str(tmp_path / name))
        _same_tree(blob['model_state_dict'], params)
        assert blob['config'] == cfg and blob['epoch'] == 0
        assert blob['optimizer_state_dict'] is None
    spec, p, c = ck.model_from_deployed(str(tmp_path / 'jax.sevenn'))
    assert spec.blocks[0].self_connection == 'nequip' and c == cfg
    with pytest.raises(ValueError, match='not a deployment artifact'):
        np.savez(tmp_path / 'other.npz', __format__=np.frombuffer(
            b'something-else', np.uint8))
        ck.load_deployed(str(tmp_path / 'other.npz'))


def test_from_deployed_matches_jax(narrow_ckpt, tmp_path):
    import jax

    from sevennet_finetuning_tpu.calculator import Calculator as JCalc
    from sevennet_finetuning_tpu.data.readers import read_extxyz as jread
    from sevennet_finetuning_tpu_torch.calculator import Calculator
    from sevennet_finetuning_tpu_torch.data.readers import read_extxyz
    from sevennet_finetuning_tpu_torch.train.checkpoint import save_deployed

    _, params = narrow_ckpt
    art = str(tmp_path / 'deployed_serial.sevenn')
    save_deployed(art, params, _narrow_config())
    calc = Calculator.from_deployed(art, device='cpu')
    with jax.enable_x64(False):
        jc = JCalc.from_deployed(art)
        for s, js in zip(read_extxyz(str(REPLAY))[1:3],
                         jread(str(REPLAY))[1:3]):
            want = jc.calculate(js)
            got = calc.calculate(s)
            assert abs(got['energy'] - want['energy']) <= 1e-6 * abs(
                want['energy'])
            for k in ('forces', 'stress'):
                w = np.asarray(want[k])
                assert np.abs(got[k] - w).max() <= 1e-4 * np.abs(w).max()


# --- data helpers ------------------------------------------------------------

def test_replicate_and_index_helpers_match_jax():
    from sevennet_finetuning_tpu.data import vasp as jv
    from sevennet_finetuning_tpu.data.readers import read_extxyz as jread
    from sevennet_finetuning_tpu_torch.data import vasp
    from sevennet_finetuning_tpu_torch.data.readers import read_extxyz

    s, js = read_extxyz(str(REPLAY))[1], jread(str(REPLAY))[1]
    got, want = vasp.replicate(s, 2, 1, 3), jv.replicate(js, 2, 1, 3)
    assert got.species == want.species and len(got) == 6 * len(s)
    for k in ('pos', 'cell', 'forces', 'stress'):
        assert np.array_equal(getattr(got, k), getattr(want, k)), k
    assert got.energy == want.energy == 6 * s.energy
    for expr in ('OUTCAR_{1..3}', 'run{a,b}/OUTCAR_{2..1}', 'plain'):
        assert vasp.brace_expand(expr) == jv.brace_expand(expr)
    for expr in (':', '2', '-1', '1:10', '::2', '3:'):
        assert vasp._parse_index(expr) == jv._parse_index(expr)


def test_write_extxyz_matches_jax(tmp_path):
    from sevennet_finetuning_tpu.data import readers as jr
    from sevennet_finetuning_tpu_torch.data import readers

    structs = readers.read_extxyz(str(REPLAY))[:3]
    readers.write_extxyz(str(tmp_path / 'port.extxyz'), structs)
    jr.write_extxyz(str(tmp_path / 'jax.extxyz'), jr.read_extxyz(
        str(REPLAY))[:3])
    text = (tmp_path / 'port.extxyz').read_text()
    assert text == (tmp_path / 'jax.extxyz').read_text()
    back = readers.read_extxyz(str(tmp_path / 'port.extxyz'))
    for a, b in zip(back, structs):
        assert a.species == b.species
        assert np.allclose(a.stress, b.stress, atol=1e-9)
        assert np.allclose(a.forces, b.forces, atol=1e-9)


def _edge_set(out):
    i, j, shift, _ = out
    return {(int(a), int(b), *map(int, np.rint(c)))
            for a, b, c in zip(i, j, shift)}


@pytest.mark.parametrize('case', ['gnn', 'd3', 'open', 'skewed'])
def test_native_neighbor_list(monkeypatch, case):
    """The native core finds the cKDTree path's edge set, and returns the
    JAX package's native arrays (the same source, the same order)."""
    from sevennet_finetuning_tpu.data import native as jnative
    from sevennet_finetuning_tpu_torch.data import native
    from sevennet_finetuning_tpu_torch.data.neighborlist import neighbor_list
    from sevennet_finetuning_tpu_torch.data.readers import read_extxyz

    if case in ('gnn', 'open'):
        s = read_extxyz(str(FT900))[0]
        cutoff = 5.0
    else:
        s = read_extxyz(str(REPLAY))[1]
        cutoff = 15.0 if case == 'd3' else 6.0
    pos, cell, pbc = s.pos, s.cell, s.pbc
    if case == 'open':
        pbc = (True, False, True)
    if case == 'skewed':
        cell = cell + np.array([[0.0, 0.0, 0.0], [2.5, 0.0, 0.0],
                                [1.0, -1.5, 0.0]])
        pos = pos + 7.5 * cell[0]       # outside the home cell
    assert native.native_available()
    monkeypatch.delenv('SEVENN_NO_NATIVE', raising=False)
    got = neighbor_list(pos, cell, pbc, cutoff)
    monkeypatch.setenv('SEVENN_NO_NATIVE', '1')
    ref = neighbor_list(pos, cell, pbc, cutoff)
    assert _edge_set(got) == _edge_set(ref)
    assert len(got[0]) == len(ref[0]) > 0
    assert np.all(np.diff(got[0]) >= 0)            # grouped by i
    d = np.linalg.norm(got[3], axis=1)
    assert d.max() < cutoff and d.min() > 0
    want = jnative.neighbor_list_native(pos, cell, pbc, cutoff)
    for a, b in zip(got, want):
        assert np.array_equal(a, b)


# --- inference and the CLI ---------------------------------------------------

def _data_file(tmp_path, n=4):
    """``n`` labeled 12-atom structures of replay.extxyz."""
    from sevennet_finetuning_tpu_torch.data.readers import (
        read_extxyz, write_extxyz)

    path = tmp_path / 'data.extxyz'
    write_extxyz(str(path), read_extxyz(str(REPLAY))[1:1 + n])
    return str(path)


def _read_csv(path):
    with open(path) as f:
        return list(csv.DictReader(f))


def _same_outputs(got_dir, want_dir):
    """errors.txt, info.csv, per_graph.csv and per_atom.csv of two
    inference runs agree (energies 1e-5 of the column's max, forces and
    stress 1e-4)."""
    assert sorted(os.listdir(got_dir)) == sorted(os.listdir(want_dir)) == [
        'errors.txt', 'info.csv', 'per_atom.csv', 'per_graph.csv']
    g = (Path(got_dir) / 'errors.txt').read_text().split('\n')
    w = (Path(want_dir) / 'errors.txt').read_text().split('\n')
    assert len(g) == len(w)
    for a, b in zip(g, w):
        if a:
            assert a.split(':')[0] == b.split(':')[0]
            assert abs(float(a.split()[-1]) - float(b.split()[-1])) <= \
                2e-6 + 1e-5 * abs(float(b.split()[-1]))
    assert _read_csv(Path(got_dir) / 'info.csv') == \
        _read_csv(Path(want_dir) / 'info.csv')
    for name, cols, tol in (('per_graph.csv', ('energy', 'ref_energy'), 1e-5),
                            ('per_atom.csv', ('fx', 'fy', 'fz'), 1e-4)):
        rg = _read_csv(Path(got_dir) / name)
        rw = _read_csv(Path(want_dir) / name)
        assert len(rg) == len(rw) > 0
        for col in cols:
            a = np.array([float(r[col]) for r in rg])
            b = np.array([float(r[col]) for r in rw])
            assert np.abs(a - b).max() <= tol * np.abs(b).max(), col
    sg = np.array([eval(r['stress_kbar']) for r in
                   _read_csv(Path(got_dir) / 'per_graph.csv')])
    sw = np.array([eval(r['stress_kbar']) for r in
                   _read_csv(Path(want_dir) / 'per_graph.csv')])
    assert np.abs(sg - sw).max() <= 1e-4 * np.abs(sw).max()


def test_inference_main_matches_jax(narrow_ckpt, tmp_path):
    import jax

    from sevennet_finetuning_tpu.scripts.inference import (
        inference_main as j_inference)
    from sevennet_finetuning_tpu_torch.scripts.inference import (
        inference_main)

    path, _ = narrow_ckpt
    data = _data_file(tmp_path)
    inference_main(str(path), [data], output_dir=str(tmp_path / 'port'),
                   batch_size=3, device='cpu')
    with jax.enable_x64(False):
        j_inference(str(path), [data], output_dir=str(tmp_path / 'jax'),
                    batch_size=3)
    _same_outputs(tmp_path / 'port', tmp_path / 'jax')


def test_cli_get_model_and_inference_match_jax(narrow_ckpt, tmp_path):
    import jax

    from sevennet_finetuning_tpu.main import (
        cmd_get_model as j_get_model, cmd_inference as j_cmd_inference)
    from sevennet_finetuning_tpu_torch.main import main as cli
    from sevennet_finetuning_tpu_torch.train.checkpoint import load_deployed

    path, params = narrow_ckpt
    cli(['get_model', str(path), '-o', str(tmp_path / 'port.sevenn')])
    j_get_model(argparse.Namespace(checkpoint=str(path), parallel=False,
                                   output=str(tmp_path / 'jax.sevenn'),
                                   torchscript=False))
    pp, pc = load_deployed(str(tmp_path / 'port.sevenn'))
    jp, jc = load_deployed(str(tmp_path / 'jax.sevenn'))
    _same_tree(pp, jp)
    _same_tree(pp, params)
    assert pc == jc
    data = _data_file(tmp_path, 2)
    cli(['inference', str(tmp_path / 'port.sevenn'), data, '-o',
         str(tmp_path / 'port'), '-b', '2', '--d3', 'pbe,bj',
         '--device', 'cpu'])
    with jax.enable_x64(False):
        j_cmd_inference(argparse.Namespace(
            checkpoint=str(tmp_path / 'jax.sevenn'), data=[data],
            output=str(tmp_path / 'jax'), batch=2, d3='pbe,bj'))
    _same_outputs(tmp_path / 'port', tmp_path / 'jax')


def test_inference_runs_on_cuda_unless_asked(narrow_ckpt, tmp_path,
                                             monkeypatch):
    from sevennet_finetuning_tpu_torch.main import main as cli

    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='CUDA'):
        cli(['inference', str(narrow_ckpt[0]), _data_file(tmp_path), '-o',
             str(tmp_path / 'out')])


# --- reference artifacts through the serving entry points ---------------------

def test_serving_entry_points_take_reference_artifacts(narrow_ckpt, tmp_path,
                                                       monkeypatch):
    """A reference training ``.pth`` of the narrow checkpoint's weights
    through ``load_checkpoint`` and ``Calculator.from_checkpoint`` (the
    pickle checkpoint's results, bit for bit), ``main get_model -ts``
    (a TorchScript giving the calculator's energy within 1e-6 and forces
    within 1e-5 of max) and ``SevenNetASECalculator`` from a path (a stub
    ``ase`` module)."""
    import sys
    import types

    from sevennet_finetuning_tpu_torch import keys as K
    from sevennet_finetuning_tpu_torch.calculator import (
        Calculator, SevenNetASECalculator)
    from sevennet_finetuning_tpu_torch.compat.state_dict_import import (
        state_dict_from_params)
    from sevennet_finetuning_tpu_torch.data.readers import read_extxyz
    from sevennet_finetuning_tpu_torch.main import main as cli
    from sevennet_finetuning_tpu_torch.model.build import build_model_spec
    from sevennet_finetuning_tpu_torch.model.graph import structure_to_graph
    from sevennet_finetuning_tpu_torch.train.checkpoint import (
        load_checkpoint)

    path, params = narrow_ckpt
    cfg = _narrow_config()
    sd = state_dict_from_params(build_model_spec(cfg), params)
    pth = tmp_path / 'reference.pth'
    torch.save({'model_state_dict': {k: torch.from_numpy(v)
                                     for k, v in sd.items()},
                'config': cfg, 'epoch': 3}, str(pth))
    blob = load_checkpoint(str(pth))
    _same_tree(blob['model_state_dict'], params)
    assert blob['epoch'] == 3
    s = read_extxyz(str(FT))[4]
    want = Calculator.from_checkpoint(str(path), device='cpu').calculate(s)
    got = Calculator.from_checkpoint(str(pth), device='cpu').calculate(s)
    for key in ('energy', 'forces', 'stress', 'energies'):
        assert np.array_equal(got[key], want[key]), key

    cli(['get_model', str(pth), '-ts', '-o', str(tmp_path / 'x.sevenn')])
    ts = torch.jit.load(str(tmp_path / 'x.pt'))
    g = structure_to_graph(s, cfg[K.CUTOFF], cfg[K.TYPE_MAP])
    pos = torch.tensor(s.pos, dtype=torch.float32, requires_grad=True)
    out = ts({'x': torch.tensor(g[K.ATOM_TYPE], dtype=torch.long),
              'pos': pos,
              'edge_index': torch.tensor(g[K.EDGE_IDX], dtype=torch.long),
              'pbc_shift': torch.tensor(g[K.CELL_SHIFT]),
              'cell_lattice_vectors': torch.tensor(s.cell,
                                                   dtype=torch.float32),
              'cell_volume': torch.tensor(float(s.volume)),
              'num_atoms': torch.tensor(len(s))})
    e = float(out['inferred_total_energy'])
    assert abs(e - want['energy']) <= 1e-6 * abs(want['energy'])
    f = out['inferred_force'].detach().numpy()
    assert np.abs(f - want['forces']).max() <= 1e-5 * np.abs(
        want['forces']).max()

    class AseBase:
        def __init__(self, **kwargs):
            self.results = {}

        def calculate(self, atoms=None, properties=('energy',),
                      system_changes=None):
            pass

    mod = types.ModuleType('ase.calculators.calculator')
    mod.Calculator = AseBase
    for name, m in (('ase', types.ModuleType('ase')),
                    ('ase.calculators', types.ModuleType('ase.calculators')),
                    ('ase.calculators.calculator', mod)):
        monkeypatch.setitem(sys.modules, name, m)
    atoms = types.SimpleNamespace(
        get_chemical_symbols=lambda: list(s.species),
        get_positions=lambda: s.pos, get_cell=lambda: s.cell,
        get_pbc=lambda: s.pbc)
    ase_calc = SevenNetASECalculator(str(pth), device='cpu')
    ase_calc.calculate(atoms)
    assert ase_calc.results['energy'] == want['energy']
    assert np.array_equal(ase_calc.results['forces'], want['forces'])
