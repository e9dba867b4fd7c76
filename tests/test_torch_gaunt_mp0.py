"""The port's 'gaunt' family at MACE-MP-0 medium's widths against the
benchmark's plain reference (``benchmark/reference/gaunt.py``), which forms
the Gaunt products by quadrature on the sphere instead of torus FFTs.

- energy, forces and stress of 12- and 24-atom HfO2 from
  ``benchmark/configs/gaunt_mp0_medium_widths.json``'s model dict (128
  channels), on random weights drawn from a seed under the port's names;
- the reference on its own: its product of single harmonics against the
  Clebsch-Gordan coupling times the Gaunt/w3j ratio for every (l1, l2) <=
  (1, 3), its ratio table against the port's host table, its quadrature's
  orthonormality;
- the spans and counters of ``ops/gaunt.py`` and of the halo swap.
"""

import json
import math
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmark import inputs, program
from benchmark.reference import gaunt as rg
from benchmark.reference import graph as ref_graph
from benchmark.reference.wigner import wigner_3j
from sevennet_finetuning_tpu_torch import tracing
from sevennet_finetuning_tpu_torch.calculator import Calculator
from sevennet_finetuning_tpu_torch.irreps import Irreps
from sevennet_finetuning_tpu_torch.model.build import build_model_spec
from sevennet_finetuning_tpu_torch.model.nequip import param_shapes
from sevennet_finetuning_tpu_torch.ops import gaunt as tg

ROOT = Path(__file__).resolve().parents[1]
CONFIG = ROOT / 'benchmark' / 'configs' / 'gaunt_mp0_medium_widths.json'
FT900 = ROOT / 'experiments' / 'ft_reewc_900' / 'data' / 'ft900.extxyz'

torch.set_num_threads(2)


@pytest.fixture(scope='module')
def model():
    cfg = program.model_config(json.loads(CONFIG.read_text()))
    params = rg.init_weights(cfg, 2 ** 33 + 17, 'cpu')
    return cfg, params


@pytest.fixture(autouse=True)
def recorder_off():
    yield
    tracing.disable()
    tracing.reset()


def test_reference_draws_the_ports_parameter_names_and_shapes(model):
    cfg, params = model
    want = {g: {n: tuple(s) for n, s in d.items()}
            for g, d in param_shapes(build_model_spec(cfg)).items()}
    got = {g: {n: tuple(v.shape) for n, v in d.items()}
           for g, d in params.items()}
    assert got == want
    assert sum(int(np.prod(s)) for d in want.values() for s in d.values()) \
        == json.loads(CONFIG.read_text())['parameters']


@pytest.mark.parametrize('reps', [(1, 1, 1), (2, 1, 1)])
def test_port_matches_the_reference(model, reps):
    """Both float32 on the CPU, the sums in different orders: the energy
    (some -10 eV an atom, the shift) within 2e-6 of itself, a few ulp of
    a sum of ~10^2 atomic energies (read 1.8e-7-2.7e-7); forces and stress
    within 2e-5 of their largest component, ten times the 2.5e-6 read at
    12 atoms (the torus FFTs and the quadrature round differently)."""
    cfg, params = model
    s12 = [s for s in inputs.read_extxyz(FT900)
           if len(s['numbers']) == 12][3]
    s = inputs.rattle(inputs.replicate(s12, reps), 0.05,
                      np.random.default_rng(sum(reps)))
    calc = Calculator(build_model_spec(cfg), params, device='cpu')
    got = calc.calculate(inputs.to_program(s))
    ref = rg.GauntReference(cfg, params, 'cpu', chunk=500)
    g = ref_graph.batch_graphs([s], ref.spec.cutoff, cfg['_type_map'],
                               'cpu')
    e, f, st = ref.evaluate(g)
    assert abs(got['energy'] - float(e[0])) <= 2e-6 * abs(float(e[0]))
    f = f.double().numpy()
    assert np.abs(np.asarray(got['forces']) - f).max() \
        <= 2e-5 * np.abs(f).max()
    st = st[0].double().numpy()
    assert np.abs(np.asarray(got['stress']) - st).max() \
        <= 2e-5 * np.abs(st).max()


def test_quadrature_is_orthonormal_for_component_harmonics():
    for lmax in (1, 3, 4):
        deg = 2 * lmax
        A = rg.evaluate_at(lmax, deg, torch.float64, 'cpu')
        P = rg.project_from(lmax, deg, torch.float64, 'cpu')
        assert torch.allclose(A @ P, torch.eye((lmax + 1) ** 2,
                                             dtype=torch.float64),
                              atol=1e-12)


def _single(l, m, L):
    v = torch.zeros((L + 1) ** 2, dtype=torch.float64)
    v[l * l + m] = 1.0
    return v


@pytest.mark.parametrize('l1', [0, 1])
@pytest.mark.parametrize('l2', [0, 1, 2, 3])
def test_gaunt_product_is_cg_times_the_ratio(l1, l2):
    """The product of Y_l1 and Y_l2 projected onto l: kappa C, C the
    unit-norm real Wigner-3j coupling and |kappa| = sqrt((2l1+1)(2l2+1)
    (2l+1)) |(l1 l2 l; 0 0 0)|, nought where l1 + l2 + l is odd."""
    for lo in range(abs(l1 - l2), l1 + l2 + 1):
        G = torch.zeros(2 * l1 + 1, 2 * l2 + 1, 2 * lo + 1,
                        dtype=torch.float64)
        for m1 in range(2 * l1 + 1):
            for m2 in range(2 * l2 + 1):
                c = rg.sphere_product(_single(l1, m1, l1)[None], l1,
                                      _single(l2, m2, l2)[None], l2, lo)
                G[m1, m2] = c[0, lo * lo:]
        C = torch.as_tensor(wigner_3j(l1, l2, lo), dtype=torch.float64)
        kappa = float((G * C).sum())
        assert torch.allclose(G, kappa * C, atol=1e-12)
        want = math.sqrt((2 * l1 + 1) * (2 * l2 + 1) * (2 * lo + 1)) \
            * abs(rg.wigner_3j_000(l1, l2, lo))
        assert abs(abs(kappa) - want) < 1e-12
        if (l1 + l2 + lo) % 2:
            assert want == 0.0 and float(G.abs().max()) < 1e-12


def test_racah_3j_and_the_ratio_table_match_the_ports():
    for l1 in range(4):
        for l2 in range(4):
            for lo in range(abs(l1 - l2), l1 + l2 + 1):
                C = wigner_3j(l1, l2, lo)
                assert abs(abs(rg.wigner_3j_000(l1, l2, lo))
                           - abs(C[l1, l2, lo])) < 1e-12
    for L1 in (1, 2, 3):
        for L2 in (1, 3):
            np.testing.assert_allclose(rg.gaunt_ratio(L1, L2),
                                       tg.fit_gaunt_to_w3j(L1, L2),
                                       rtol=1e-6)


def _conv_case(mul=4, N=5, E=11):
    rng = np.random.default_rng(3)
    irx = Irreps(f'{mul}x0e+{mul}x1o')
    irf = Irreps.spherical_harmonics(3, -1)
    spec = tg.gaunt_conv_spec(irx, irf, irx, (8,), 4, 'silu')
    w = [torch.tensor(rng.normal(size=(4, 8)), dtype=torch.float32),
         torch.tensor(rng.normal(size=(8, spec.weight_numel)),
                      dtype=torch.float32)]
    x = torch.tensor(rng.normal(size=(N, irx.dim)), dtype=torch.float32)
    sh = torch.tensor(rng.normal(size=(E, irf.dim)), dtype=torch.float32)
    emb = torch.tensor(rng.normal(size=(E, 4)), dtype=torch.float32)
    src = torch.tensor(rng.integers(0, N, E), dtype=torch.int32)
    dst = torch.sort(torch.tensor(rng.integers(0, N, E),
                                  dtype=torch.int32)).values
    return spec, w, x, sh, emb, src, dst, N


def test_gaunt_spans_and_grid_bytes_counter():
    """The span ``gaunt.conv`` around both formulations with the same
    attributes, ``edges`` E a call of the coupling path, which writes no
    sample grid; ``gaunt.grid_bytes`` counts only the FFT formulation's
    grids."""
    spec, w, x, sh, emb, src, dst, N = _conv_case()
    assert tracing.span('gaunt.conv') is tracing.OFF
    off = tg.apply_gaunt_conv(spec, w, x, sh, emb, src, dst, N,
                              torch.ones(1), sorted_dst=True)
    assert tracing.records() == [] and not tracing.counters()
    tracing.enable()
    on = tg.apply_gaunt_conv(spec, w, x, sh, emb, src, dst, N,
                             torch.ones(1), sorted_dst=True)
    tg.apply_gaunt_conv(spec, w, x, sh, emb, src, dst, N, torch.ones(1),
                        sorted_dst=True)
    M = 2 * (1 + 3) + 1
    E = src.shape[0]
    assert [r[6]['edges'] for r in tracing.records()] == [E, E]
    assert 'gaunt.grid_bytes' not in tracing.counters()
    tg.gaunt_conv_fft(spec, w, x, sh, emb, src, dst, N, torch.ones(1),
                      sorted_dst=True)
    pb = tg.gaunt_pb_spec(spec.irreps_x, Irreps('4x0e'), 3)
    params = {k: torch.ones(s) for k, s in tg.gaunt_pb_shapes(pb).items()}
    tg.apply_gaunt_pb(pb, params, x)
    tracing.disable()
    assert torch.equal(off, on)
    assert tracing.counters()['gaunt.grid_bytes'] == E * 4 * M * M * 4
    assert set(tracing.counters()) == {'gaunt.grid_bytes'}
    recs = {r[0]: r[6] for r in tracing.records()}
    assert recs['gaunt.conv'] == {'edges': E, 'mul': 4, 'M': M}
    assert recs['gaunt.pb'] == {'nodes': N, 'correlation': 3}
    assert [r[0] for r in tracing.records()] == ['gaunt.conv', 'gaunt.conv',
                                                 'gaunt.conv', 'gaunt.pb']
    assert all(r[6] == {'edges': E, 'mul': 4, 'M': M}
               for r in tracing.records()[:3])


def test_halo_swap_span_and_bytes_counter(monkeypatch):
    """``DistTransport.swap`` with the point-to-point calls replaced by a
    loopback: one span a swap and the bytes sent counted."""
    from sevennet_finetuning_tpu_torch.parallel import halo

    def loopback(ops):
        sends = [op[1] for op in ops if op[0] == 'send']
        for op, got in zip([op for op in ops if op[0] == 'recv'], sends):
            op[1].copy_(got)
        return []

    monkeypatch.setattr(halo.dist, 'P2POp',
                        lambda fn, t, peer, tag=0: (
                            'send' if fn is halo.dist.isend else 'recv', t))
    monkeypatch.setattr(halo.dist, 'batch_isend_irecv', loopback)
    monkeypatch.setattr(halo.dist, 'get_backend', lambda: 'gloo')
    tr = halo.DistTransport.__new__(halo.DistTransport)
    tr.ranks, tr.seconds, tr._peers = (0,), 0.0, [(0, 0)]
    up = torch.arange(24, dtype=torch.float32).reshape(1, 4, 6)
    down = -torch.arange(12, dtype=torch.float32).reshape(1, 2, 6)
    a, b = tr.swap(0, up, down)
    assert tracing.records() == []
    tracing.enable()
    a2, b2 = tr.swap(0, up, down)
    tracing.disable()
    assert torch.equal(a, up) and torch.equal(b, down)
    assert torch.equal(a2, a) and torch.equal(b2, b)
    assert tracing.counters()['halo.swap_bytes'] == (24 + 12) * 4
    (name, *_, attrs), = tracing.records()
    assert name == 'halo.swap' and attrs == {'stage': 0, 'rows': 6}
