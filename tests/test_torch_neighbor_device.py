"""The neighbor list on the card (``ops/neighbor.py``,
``csrc/neighbor_cells.cu``), as MD's rebuild and the serving
``Calculator`` build with it, and the packing they share with the host
path.

On the CPU (tier 1), laid over the host core's edge list, key by key and
bit for bit:

- ``pack_edges`` and ``VelocityVerlet._node_keys`` give the batch that
  ``collate`` + ``batch_to_torch`` give for the same list
  (``VelocityVerlet._host_edges``, the host rebuild);
- the Calculator's card assembly (``calculator.node_batch``, then
  ``with_edges`` over a fill pass) gives what ``Calculator.batch`` builds
  on the CPU, on ft900 structure 0 (96 atoms), its 3x2x2 replica (1,152)
  and a cluster with no periodic axis; and the CPU build counts no
  ``graph.build.device``.

On the card (marker ``card``; each test skips without CUDA):

- the kernel's edges against ``neighbor_list_native``'s as sets of
  (i, j, shift), on ft900 structure 0 (96 atoms), its 4x4x4 replica
  (6,144 atoms), a triclinic cell, a cell thinner than the cutoff
  (repeats 2), one non-periodic axis and positions drifted several cells
  out of the home cell; whether the order is the core's is printed per
  case (``-s``) and kept as the test's ``same_order`` property;
- two builds bit-identical;
- a capacity growth and a shrink keep the sentinel, the shift and the
  mask right, counted by ``md.rebuild.grow`` (the first allocation
  included);
- ``run_device`` with the card rebuild against the host rebuild on the
  golden MD settings (``tests/test_torch_md.py``'s MD; SevenNet-0):
  the same segments, E_pot, E_kin, positions and velocities within
  ``test_torch_md``'s ``run_device`` limits, and ``md.rebuild.device``
  one a segment; the card run also against the JAX package's run in
  ``golden/md_hfo2_jax_cpu.npz`` at ``chip_smoke.py``'s md-phase limits;
- ``Calculator.calculate`` with the card build against the same request
  built on the host (``structure_to_graph``, ``collate``,
  ``batch_to_torch``) and run by ``apply_model``: SevenNet-0 (the in-repo
  checkpoint) and the benchmark's MACE- and Gaunt-widths configurations
  (random weights from a seed) at 96 and 1,152 rattled atoms; the same
  edge set, energy, forces and stress within 1e-6 relative,
  ``graph.build.device`` one a request, and two requests bit-identical.

This file imports no JAX; ``tests/conftest.py`` does, so on a card
machine without JAX:

    python -m pytest --noconftest -m card -s \
        tests/test_torch_neighbor_device.py
"""

from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
CKPT = ROOT / 'experiments/ft_reewc_900/conv_out/checkpoint_best.pth'
FT900 = ROOT / 'experiments/ft_reewc_900/data/ft900.extxyz'
GOLDEN_MD = ROOT / 'sevennet_finetuning_tpu_torch/golden/md_hfo2_jax_cpu.npz'
# tests/test_torch_md.py's MD settings (the golden run's)
MD = dict(T=500.0, seed=0, dt=2.0, skin=0.5, seg_steps=10, n_steps=20)
CUTOFF = 5.0
SKIN = 0.5


@pytest.fixture(autouse=True, scope='module')
def _native_neighbor_list():
    """The host builds with the native core here, whatever the worker's
    environment holds; restored after."""
    with pytest.MonkeyPatch.context() as mp:
        mp.delenv('SEVENN_NO_NATIVE', raising=False)
        yield


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card')
    return torch.device('cuda', 0)


def _ft900_0():
    from sevennet_finetuning_tpu_torch.data.readers import read_extxyz

    return read_extxyz(str(FT900))[0]


def _random(n, cell, pbc=(True, True, True), seed=0, spread=1.0):
    """n atoms of HfO2 at random fractional coordinates in [0, spread) of
    ``cell``."""
    from sevennet_finetuning_tpu_torch.data.vasp import Structure

    rng = np.random.default_rng(seed)
    cell = np.asarray(cell, float)
    return Structure(species=['Hf' if i % 3 == 0 else 'O' for i in range(n)],
                     pos=rng.uniform(0, spread, (n, 3)) @ cell, cell=cell,
                     pbc=tuple(pbc))


def _drifted():
    """ft900 structure 0 with every atom moved by a random whole number
    (-4..4) of lattice vectors along each axis."""
    s = _ft900_0()
    rng = np.random.default_rng(7)
    s.pos = s.pos + rng.integers(-4, 5, (len(s), 3)) @ s.cell
    return s


def _replica():
    from sevennet_finetuning_tpu_torch.data.vasp import replicate

    return replicate(_ft900_0(), 4, 4, 4)


TRICLINIC = [[9.0, 0.0, 0.0], [2.5, 8.5, 0.0], [-1.5, 2.0, 9.5]]
CASES = {
    'ft900_0': (_ft900_0, CUTOFF + SKIN),
    'ft900_0_4x4x4': (_replica, CUTOFF + SKIN),
    'triclinic': (lambda: _random(60, TRICLINIC, seed=1), 4.5),
    # 2.2 A along c under a 4.0 A cutoff: two images each way
    'thin': (lambda: _random(12, np.diag([8.0, 8.0, 2.2]), seed=2), 4.0),
    'open_c': (lambda: _random(40, np.diag([9.0, 9.0, 9.0]),
                               pbc=(True, True, False), seed=3), 4.5),
    'drifted': (_drifted, CUTOFF + SKIN),
}


def _structure(case):
    """The case's structure at float32-rounded positions, as MD holds
    them (the card reads float32), and its cutoff."""
    make, rc = CASES[case]
    s = make()
    s.pos = s.pos.astype(np.float32).astype(np.float64)
    return s, rc


def _native(s, rc):
    from sevennet_finetuning_tpu_torch.data.native import neighbor_list_native

    out = neighbor_list_native(s.pos, s.cell, s.pbc, rc)
    assert out is not None, 'the native core is needed here'
    return out[:3]


def _padded_pos(s, n_node, device='cpu'):
    pos = np.zeros((n_node, 3), np.float32)
    pos[:len(s)] = s.pos
    return torch.as_tensor(pos, device=device)


def _vv(s, calc):
    from sevennet_finetuning_tpu_torch.md import VelocityVerlet

    return VelocityVerlet(s, calculator=calc, dt_fs=MD['dt'], skin=SKIN)


class _Calc:
    """What the rebuild reads of a Calculator (its edges at ``rc``)."""

    def __init__(self, device='cpu', rc=CUTOFF + SKIN):
        from sevennet_finetuning_tpu_torch.model.build import build_model_spec

        self.spec = build_model_spec({'_number_of_species': 2,
                                      '_type_map': {8: 0, 72: 1},
                                      'cutoff': rc - SKIN})
        self.type_map = {8: 0, 72: 1}
        self.device = torch.device(device)
        self.d3 = None


def _assert_same_batch(got, want):
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert got[k].shape == want[k].shape, k
        torch.testing.assert_close(got[k].cpu(), want[k].cpu(), rtol=0,
                                   atol=0, equal_nan=True, msg=k)


# --- CPU: the packing step against collate + batch_to_torch -------------

@pytest.mark.parametrize('case', ['ft900_0', 'triclinic', 'thin', 'open_c',
                                  'drifted'])
def test_packing_matches_collate(case):
    """The card path's layout, its fill pass done by indexing into
    buffers of garbage, against the host rebuild of the same structure
    over the same native edge list."""
    from sevennet_finetuning_tpu_torch import keys as K
    from sevennet_finetuning_tpu_torch.model.nequip import EDGE_SRC_INV_PERM
    from sevennet_finetuning_tpu_torch.ops.neighbor import pack_edges

    s, rc = _structure(case)
    vv = _vv(s, _Calc(rc=rc))
    want = vv._host_edges()
    cap = vv._cap_edge
    i, j, shift = _native(s, rc)
    m = len(i)
    nodes = vv._node_keys()
    n_node = nodes[K.NODE_MASK].shape[0]
    idx = torch.full((2, cap), -7, dtype=torch.int32)
    sh = torch.full((cap, 3), 9.5)
    mask = torch.full((cap,), 3.0)
    idx[0, :m] = torch.as_tensor(i, dtype=torch.int32)
    idx[1, :m] = torch.as_tensor(j, dtype=torch.int32)
    sh[:m] = torch.as_tensor(shift, dtype=torch.float32)
    perm, inv = pack_edges(idx, sh, mask, m, n_node)
    got = dict(nodes, **{K.POS: _padded_pos(s, n_node), K.EDGE_IDX: idx,
                         K.CELL_SHIFT: sh, K.EDGE_MASK: mask,
                         K.EDGE_SRC_PERM: perm, EDGE_SRC_INV_PERM: inv})
    _assert_same_batch(got, want)


# the Calculator's card build: the serving cells' sizes (96 atoms at
# SevenNet-0's cutoff; 1,152 at the MACE and Gaunt widths' 6 A) and a
# cluster with no periodic axis
CALC_CASES = {
    'ft900_0': (_ft900_0, CUTOFF),
    'ft900_0_3x2x2': (lambda: _replica_of(3, 2, 2), 6.0),
    'cluster': (lambda: _random(40, np.diag([9.0, 9.0, 9.0]),
                                pbc=(False, False, False), seed=4), 4.5),
}


def _replica_of(*reps):
    from sevennet_finetuning_tpu_torch.data.vasp import replicate

    return replicate(_ft900_0(), *reps)


def _calculator(cutoff, device='cpu'):
    """A SevenNet-0-shaped Calculator on HfO2 at ``cutoff``."""
    from sevennet_finetuning_tpu_torch.calculator import Calculator
    from sevennet_finetuning_tpu_torch.model.build import build_model_spec
    from sevennet_finetuning_tpu_torch.model.nequip import init_params

    spec = build_model_spec({'_number_of_species': 2,
                             '_type_map': {8: 0, 72: 1}, 'cutoff': cutoff})
    return Calculator(spec, init_params(spec, 0), device=device)


@pytest.mark.parametrize('case', list(CALC_CASES))
def test_calculator_card_assembly_matches_host_batch(case):
    """``Calculator._card_batch``'s assembly -- ``node_batch``, the rule
    ``bucket_capacity(total)``, a fill pass into buffers of garbage, then
    ``pack_edges`` -- over the host core's edge list, against what
    ``Calculator.batch`` builds on the CPU; which counts no card build."""
    from sevennet_finetuning_tpu_torch import tracing
    from sevennet_finetuning_tpu_torch.calculator import (node_batch,
                                                          with_edges)

    make, rc = CALC_CASES[case]
    s = make()
    calc = _calculator(rc)
    tracing.reset()
    tracing.enable()
    try:
        want = calc.batch(s)
        counts = tracing.counters()
    finally:
        tracing.disable()
        tracing.reset()
    assert counts['graph.build.device'] == 0
    i, j, shift = _native(s, rc)
    m = len(i)

    def fill(idx, sh):
        idx.fill_(-7)
        sh.fill_(9.5)
        idx[0, :m] = torch.as_tensor(i, dtype=torch.int32)
        idx[1, :m] = torch.as_tensor(j, dtype=torch.int32)
        sh[:m] = torch.as_tensor(shift, dtype=torch.float32)

    got = with_edges(node_batch(s, calc.type_map, calc.device), m, fill)
    _assert_same_batch(got, want)


# --- the card -----------------------------------------------------------

def _card_build(s, rc, device, cap=None):
    """One card build of ``s`` at ``rc``: (edge_idx, shift, edges) with
    ``cap`` slots (the edge count when None)."""
    from sevennet_finetuning_tpu_torch.ops.neighbor import CellList

    cells = CellList(s.cell, s.pbc, rc, s.pos, device)
    pos = _padded_pos(s, len(s) + 3, device)
    m, reads = cells.count(pos)
    assert reads == 1
    cap = m if cap is None else cap
    idx = torch.full((2, cap), -1, dtype=torch.int32, device=device)
    sh = torch.full((cap, 3), float('nan'), device=device)
    cells.fill(idx, sh)
    return idx, sh, m


@pytest.mark.card
@pytest.mark.parametrize('case', list(CASES))
def test_card_edges_equal_native(case, card, record_property):
    s, rc = _structure(case)
    i, j, shift = _native(s, rc)
    idx, sh, m = _card_build(s, rc, card)
    idx, sh = idx.cpu().numpy(), sh.cpu().numpy()
    got = np.concatenate([idx.T, sh], 1)
    want = np.concatenate([np.stack([i, j], 1),
                           shift.astype(np.float32)], 1)
    assert m == len(i), (m, len(i))
    assert {tuple(r) for r in got} == {tuple(r) for r in want}
    assert len({tuple(r) for r in got}) == m
    assert np.all(np.diff(idx[0]) >= 0)
    same = bool(np.array_equal(got, want))
    record_property('same_order', same)
    print(f'\n[neighbor] {case}: {len(s)} atoms, rc {rc}, {m} edges, '
          f"the native core's order: {'same' if same else 'differs'}")


@pytest.mark.card
def test_card_builds_are_bit_identical(card):
    s, _ = _structure('ft900_0_4x4x4')
    a = _card_build(s, CUTOFF + SKIN, card)
    b = _card_build(s, CUTOFF + SKIN, card)
    assert a[2] == b[2]
    assert torch.equal(a[0], b[0])
    assert torch.equal(a[1].view(torch.int32), b[1].view(torch.int32))


@pytest.mark.card
def test_card_capacity_growth_keeps_padding(card):
    """Squeeze the atoms of ft900 structure 0's 2x2x2 replica into 0.8 of
    the cell along each axis (46,464 -> 61,462 pairs: the edges outgrow
    the capacity), then let them go back (fewer: the capacity stays):
    each batch's live slots are the native list, its padding collate's."""
    from sevennet_finetuning_tpu_torch import keys as K
    from sevennet_finetuning_tpu_torch import tracing
    from sevennet_finetuning_tpu_torch.data.vasp import replicate

    s, rc = replicate(_ft900_0(), 2, 2, 2), CUTOFF + SKIN
    frac = s.pos @ np.linalg.inv(s.cell)
    frac -= np.floor(frac)
    vv = _vv(s, _Calc(card))
    tracing.reset()
    tracing.enable()
    try:
        caps = []
        for scale in (1.0, 0.8, 1.0):
            vv.s.pos = ((frac * scale) @ s.cell).astype(np.float32).astype(
                np.float64)
            b = vv._device_batch(vv._device_pos())
            i, j, shift = _native(vv.s, rc)
            m, cap = len(i), b[K.EDGE_IDX].shape[1]
            caps.append(cap)
            n_node = b[K.NODE_MASK].shape[0]
            idx = b[K.EDGE_IDX].cpu().numpy()
            live = b[K.CELL_SHIFT][:m].cpu().numpy()
            assert {(a, c, *t) for a, c, t in zip(
                idx[0, :m], idx[1, :m], map(tuple, live))} == {
                (a, c, *t) for a, c, t in zip(
                    i, j, map(tuple, shift.astype(np.float32)))}
            assert np.all(idx[:, m:] == n_node)
            assert not b[K.CELL_SHIFT][m:].any()
            assert torch.equal(b[K.EDGE_MASK].cpu(),
                               (torch.arange(cap) < m).float())
            perm = b[K.EDGE_SRC_PERM].long().cpu()
            assert torch.equal(b['_edge_src_inv_perm'].long().cpu()[perm],
                               torch.arange(cap))
            assert np.all(np.diff(idx[1][perm.numpy()]) >= 0)
        counts = tracing.counters()
    finally:
        tracing.disable()
        tracing.reset()
    assert caps[0] < caps[1] == caps[2]
    assert counts['md.rebuild.grow'] == 2
    assert counts['md.rebuild.device'] == 3


@pytest.mark.card
def test_card_run_device_matches_host_rebuild(card):
    from sevennet_finetuning_tpu_torch import tracing
    from sevennet_finetuning_tpu_torch.calculator import Calculator

    calc = Calculator.from_checkpoint(str(CKPT), device='cuda')
    runs = {}
    for kind in ('host', 'card'):
        vv = _vv(_ft900_0(), calc)
        vv.set_temperature(MD['T'], seed=MD['seed'])
        if kind == 'host':
            vv._card_edges = lambda pos, vv=vv: vv._host_edges()
        tracing.reset()
        tracing.enable()
        try:
            vv.run_device(MD['n_steps'], seg_steps=MD['seg_steps'])
            counts = tracing.counters()
        finally:
            tracing.disable()
            tracing.reset()
        runs[kind] = (vv, counts)
    host, card_vv = runs['host'][0], runs['card'][0]
    assert card_vv.result.segments == host.result.segments
    assert runs['card'][1]['md.rebuild.device'] == len(
        card_vv.result.segments)
    assert runs['host'][1]['md.rebuild.device'] == 0
    np.testing.assert_allclose(card_vv.s.pos, host.s.pos, rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(card_vv.vel, host.vel, rtol=1e-3, atol=1e-6)
    np.testing.assert_allclose(card_vv.result.energies, host.result.energies,
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(card_vv.result.kinetic, host.result.kinetic,
                               rtol=1e-4, atol=1e-7)
    # the JAX package's run_device on the CPU, at chip_smoke.py's limits
    # against it (MD_POS_TOL, MD_EPOT_TOL, MD_EKIN_TOL, MD_VEL_*)
    gold = np.load(GOLDEN_MD)
    assert card_vv.result.segments == [int(x) for x in gold['md_done']]
    np.testing.assert_allclose(card_vv.s.pos, gold['md_pos'], rtol=0,
                               atol=1e-4)
    np.testing.assert_allclose(card_vv.result.energies, gold['md_epot'],
                               rtol=1e-5, atol=0)
    np.testing.assert_allclose(card_vv.result.kinetic, gold['md_ekin'],
                               rtol=1e-4, atol=0)
    np.testing.assert_allclose(card_vv.vel, gold['md_vel'], rtol=1e-3,
                               atol=1e-6)


# the serving Calculator's card build: SevenNet-0 and the benchmark's two
# serving configurations, each request at 96 and 1,152 atoms rattled by
# 0.02 A (the serving traffic's), weights from a large seed
SERVED = ('sevennet0', 'mace_mp0_medium_widths', 'gaunt_mp0_medium_widths')
SERVED_SEED = 2 ** 33 + 17
_served = {}


def _served_calculator(name):
    """The card Calculator of ``name``, made once for the module."""
    import json

    if name in _served:
        return _served[name]
    from benchmark import program
    from sevennet_finetuning_tpu_torch.calculator import Calculator

    if name == 'sevennet0':
        calc = Calculator.from_checkpoint(str(CKPT), device='cuda')
    else:
        cfg_file = json.loads(
            (ROOT / 'benchmark' / 'configs' / f'{name}.json').read_text())
        if name.startswith('gaunt'):
            from benchmark.reference import gaunt as ref_gaunt

            cfg = program.model_config(cfg_file)
            params = ref_gaunt.init_weights(cfg, SERVED_SEED, 'cuda')
        else:
            cfg, params = program.weights(cfg_file, ROOT, SERVED_SEED,
                                          'cuda')
        calc = program.calculator(cfg, params, 'cuda')
    _served[name] = calc
    return calc


def _rattled(reps, seed):
    s = _replica_of(*reps)
    s.pos = s.pos + np.random.default_rng(seed).normal(0.0, 0.02,
                                                       s.pos.shape)
    return s


def _host_request(calc, s):
    """``s`` built on the host as the CPU Calculator builds it, then run
    by ``apply_model``: (batch, (energy, forces, stress))."""
    from sevennet_finetuning_tpu_torch import keys as K
    from sevennet_finetuning_tpu_torch.model.graph import (
        bucket_capacity, collate, structure_to_graph)
    from sevennet_finetuning_tpu_torch.model.nequip import (apply_model,
                                                            batch_to_torch)

    g = structure_to_graph(s, calc.spec.cutoff, calc.type_map)
    b = collate([g], n_node=bucket_capacity(len(s), margin=1.0),
                n_edge=bucket_capacity(g[K.EDGE_IDX].shape[1]), n_graph=1)
    batch = batch_to_torch(b, calc.device)
    out = apply_model(calc.model, batch)
    return batch, (float(out[K.PRED_TOTAL_ENERGY][0]),
                   out[K.PRED_FORCE][:len(s)].cpu().numpy(),
                   out[K.PRED_STRESS][0].cpu().numpy())


def _edge_rows(batch):
    """The live edges of a batch as a set of (i, j, shift) rows."""
    from sevennet_finetuning_tpu_torch import keys as K

    m = int(batch[K.EDGE_MASK].sum())
    idx = batch[K.EDGE_IDX][:, :m].cpu().numpy()
    sh = batch[K.CELL_SHIFT][:m].cpu().numpy()
    return {(a, c, *r) for a, c, r in zip(idx[0], idx[1], map(tuple, sh))}


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.mark.card
@pytest.mark.parametrize('reps', [(1, 1, 1), (3, 2, 2)],
                         ids=['96', '1152'])
@pytest.mark.parametrize('name', SERVED)
def test_card_calculator_matches_host_build(name, reps, card,
                                            record_property):
    from sevennet_finetuning_tpu_torch import keys as K
    from sevennet_finetuning_tpu_torch import tracing

    calc = _served_calculator(name)
    s = _rattled(reps, seed=sum(reps))
    tracing.reset()
    tracing.enable()
    try:
        first = calc.calculate(s)
        second = calc.calculate(s)
        counts = tracing.counters()
    finally:
        tracing.disable()
        tracing.reset()
    assert counts['graph.build.device'] == 2
    for k in ('energy', 'forces', 'stress'):
        assert np.array_equal(first[k], second[k]), k
    host_batch, (e, f, st) = _host_request(calc, s)
    card_batch = calc.batch(s)
    assert _edge_rows(card_batch) == _edge_rows(host_batch)
    assert card_batch[K.EDGE_IDX].shape == host_batch[K.EDGE_IDX].shape
    same = all(torch.equal(card_batch[k].cpu(), host_batch[k].cpu())
               for k in (K.EDGE_IDX, K.CELL_SHIFT, K.EDGE_SRC_PERM))
    gaps = {'energy': abs(first['energy'] - e) / abs(e),
            'forces': _rel(first['forces'], f),
            'stress': _rel(first['stress'], st)}
    record_property('same_order', same)
    print(f'\n[calculator] {name} {len(s)} atoms: '
          f"{int(card_batch[K.EDGE_MASK].sum())} edges, the host's order: "
          f"{'same' if same else 'differs'}; gaps {gaps}")
    assert max(gaps.values()) <= 1e-6, gaps


# --- the nearest-neighbour cap (``max_neighbors``) ----------------------

CAP_CUTOFF = 12.0
CAP_K = 20


def _capped_calculator(device='cpu', cap=CAP_K):
    """A SevenNet-0-shaped Calculator on HfO2 at 12 A keeping each atom's
    ``cap`` nearest sources."""
    from sevennet_finetuning_tpu_torch.calculator import Calculator
    from sevennet_finetuning_tpu_torch.model.build import build_model_spec
    from sevennet_finetuning_tpu_torch.model.nequip import init_params

    spec = build_model_spec({'_number_of_species': 2,
                             '_type_map': {8: 0, 72: 1},
                             'cutoff': CAP_CUTOFF, 'max_neighbors': cap})
    return Calculator(spec, init_params(spec, 0), device=device)


@pytest.mark.parametrize('reps', [(1, 1, 1), (2, 1, 1)], ids=['96', '192'])
def test_capped_card_assembly_matches_host_batch(reps):
    """``nearest_edges`` (the card build's cap: three stable sorts, the
    kept slots from the counts, no read) over the host core's candidates,
    on the CPU, against ``Calculator.batch``'s host build with
    ``max_neighbors``: the same batch, key for key and bit for bit."""
    from sevennet_finetuning_tpu_torch import keys as K
    from sevennet_finetuning_tpu_torch.calculator import (node_batch,
                                                          with_edges)
    from sevennet_finetuning_tpu_torch.ops.neighbor import nearest_edges

    s = _rattled(reps, seed=11)
    calc = _capped_calculator()
    want = calc.batch(s)
    i, j, shift = _native(s, CAP_CUTOFF)
    order = np.argsort(i, kind='stable')
    i, j, shift = i[order], j[order], shift[order]
    counts = np.bincount(i, minlength=len(s))
    offsets = np.concatenate([[0], np.cumsum(counts)])
    n_live = int(np.minimum(counts, CAP_K).sum())
    assert n_live == CAP_K * len(s)
    nodes = node_batch(s, calc.type_map, calc.device)

    def fill(idx, sh):
        idx.fill_(-7)
        sh.fill_(9.5)
        nearest_edges(torch.as_tensor(np.stack([i, j]), dtype=torch.int32),
                      torch.as_tensor(shift, dtype=torch.float32),
                      nodes[K.POS], torch.as_tensor(s.cell),
                      torch.as_tensor(counts, dtype=torch.int32),
                      torch.as_tensor(offsets, dtype=torch.int32), CAP_K,
                      idx, sh, n_live)

    got = with_edges(nodes, n_live, fill)
    _assert_same_batch(got, want)


@pytest.mark.card
@pytest.mark.parametrize('reps', [(2, 1, 1), (3, 2, 2)],
                         ids=['192', '1152'])
def test_card_capped_build_matches_host_build(reps, card, record_property):
    """The card build with the cap (count with the capped total in its
    one read, the fill into candidate buffers, ``nearest_edges``,
    ``pack_edges``) against the host build with the cap at 12 A: the
    same batch key for key, bit for bit; one read; the counters."""
    from sevennet_finetuning_tpu_torch import keys as K
    from sevennet_finetuning_tpu_torch import tracing
    from sevennet_finetuning_tpu_torch.model.graph import (
        bucket_capacity, collate, structure_to_graph)
    from sevennet_finetuning_tpu_torch.model.nequip import batch_to_torch

    s = _rattled(reps, seed=sum(reps))
    calc = _capped_calculator('cuda')
    tracing.reset()
    tracing.enable()
    try:
        got = calc.batch(s)
        counts = tracing.counters()
    finally:
        tracing.disable()
        tracing.reset()
    assert counts['host_syncs'] == 1
    assert counts['graph.cap.edges'] == CAP_K * len(s)
    assert counts['graph.cap.candidates'] > 20 * counts['graph.cap.edges']
    g = structure_to_graph(s, CAP_CUTOFF, calc.type_map, CAP_K)
    b = collate([g], n_node=bucket_capacity(len(s), margin=1.0),
                n_edge=bucket_capacity(g[K.EDGE_IDX].shape[1]), n_graph=1)
    want = batch_to_torch(b, card)
    for k in (K.INFO, K.USER_LABEL, K.DATA_WEIGHT):
        want.pop(k, None)
    record_property('candidates', counts['graph.cap.candidates'])
    _assert_same_batch({k: got[k] for k in want}, want)


@pytest.mark.card
def test_uncapped_card_build_launches_as_before(card):
    """A configuration without ``max_neighbors`` launches what the build
    without the cap launches: the kernels of ``Calculator.batch`` equal, by
    name and number, those of the build assembled by hand from ``count``
    (no cap), ``with_edges`` and the fill pass."""
    from sevennet_finetuning_tpu_torch import keys as K
    from sevennet_finetuning_tpu_torch.calculator import (node_batch,
                                                          with_edges)
    from sevennet_finetuning_tpu_torch.ops.neighbor import CellList

    calc = _calculator(CUTOFF, 'cuda')
    s = _rattled((2, 1, 1), seed=3)

    def by_hand():
        nodes = node_batch(s, calc.type_map, calc.device)
        cells = CellList(s.cell, s.pbc, CUTOFF, s.pos, calc.device)
        n_live, _ = cells.count(nodes[K.POS])
        return with_edges(nodes, n_live, cells.fill)

    def kernels(fn):
        fn()
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        return sorted(e.name for e in prof.events()
                      if e.device_type == torch.autograd.DeviceType.CUDA)

    assert kernels(lambda: calc.batch(s)) == kernels(by_hand)
