"""The 'equiformer_v2' family (``model/equiformer_v2.py``, ``ops/so2.py``)
against the benchmark's plain reference (``benchmark/reference/
equiformer_v2.py``), at a small size with the published lmax 4, mmax 2
and grid 18 kept: channels 8-16, 2 blocks, 2 heads.

- energy, forces and stress through ``Calculator.calculate`` on seeded
  random weights, the reference on its own nearest-neighbour graph:
  HfO2 cells shorter than the cutoff (images repeat) and a cluster;
- the SO(2) linear map commutes with a rotation about the edge axis; the
  edge frame is the Wigner-D matrix the reference builds by matrix
  exponentials; the grid pair inverts band-limited coefficients;
- the host build's nearest-20 graph equals the reference's list, in its
  order within each destination;
- ``run_device`` and ``run_device_halo`` refuse a model with
  ``max_neighbors``; training and TorchScript export refuse the family;
- the configuration's parameter count; the spans and counters.
"""

import json
import math
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmark import inputs, program
from benchmark.reference import equiformer_v2 as R
from sevennet_finetuning_tpu_torch import keys as K
from sevennet_finetuning_tpu_torch import tracing
from sevennet_finetuning_tpu_torch.calculator import Calculator
from sevennet_finetuning_tpu_torch.model.build import build_model_spec
from sevennet_finetuning_tpu_torch.model.graph import structure_to_graph
from sevennet_finetuning_tpu_torch.model.equiformer_v2 import param_shapes
from sevennet_finetuning_tpu_torch.ops import so2

ROOT = Path(__file__).resolve().parents[1]
CONFIG = ROOT / 'benchmark' / 'configs' / 'equiformer_v2_31m.json'
FT900 = ROOT / 'experiments' / 'ft_reewc_900' / 'data' / 'ft900.extxyz'
SMALL = {'interaction_type': 'equiformer_v2', '_number_of_species': 2,
         '_type_map': {8: 1, 72: 0}, 'max_neighbors': 20, 'cutoff': 6.0,
         'num_layers': 2, 'sphere_channels': 16, 'attn_hidden_channels': 8,
         'attn_alpha_channels': 8, 'attn_value_channels': 4, 'num_heads': 2,
         'ffn_hidden_channels': 16, 'edge_channels': 8}
SEED = 2 ** 35 + 3

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def recorder_off():
    yield
    tracing.disable()
    tracing.reset()


@pytest.fixture(scope='module')
def small():
    params = R.init_weights(SMALL, SEED, 'cpu')
    return Calculator(build_model_spec(SMALL), params, device='cpu'), \
        R.EqV2Reference(SMALL, params, 'cpu', chunk=37)


def _ft900(n=1):
    return [s for s in inputs.read_extxyz(FT900)
            if len(s['numbers']) == 96][:n]


def _hfo2_12(seed):
    rng = np.random.default_rng(seed)
    cell = np.array([[5.1, 0.2, 0.0], [0.0, 5.2, 0.3], [0.1, 0.0, 5.3]])
    return {'numbers': np.array([72] * 4 + [8] * 8),
            'symbols': ['Hf'] * 4 + ['O'] * 8,
            'pos': rng.uniform(0.0, 5.0, (12, 3)) @ (cell / 5.0),
            'cell': cell, 'pbc': (True, True, True)}


def _cluster():
    rng = np.random.default_rng(5)
    pos = rng.uniform(0.0, 4.5, (10, 3))
    return {'numbers': np.array([72] * 3 + [8] * 7),
            'symbols': ['Hf'] * 3 + ['O'] * 7, 'pos': pos,
            'cell': np.eye(3) * 30.0, 'pbc': (False, False, False)}


CASES = {
    'hfo2_12': lambda: _hfo2_12(1),
    'hfo2_24': lambda: inputs.replicate(_hfo2_12(2), (2, 1, 1)),
    'cluster': _cluster,
}


@pytest.mark.parametrize('case', list(CASES))
def test_program_matches_the_reference(case, small):
    """Float32 both: the gaps are round-off of two orders of summation
    (1e-7 to 1e-5 read); a wrong sign, coupling, rescale or layout reads
    1e-2 or more, so 3e-5 separates them.  The energy's gap is taken over
    the sum of |per-atom energy|, as the cell takes it."""
    calc, ref = small
    s = CASES[case]()
    got = calc.calculate(inputs.to_program(s))
    e, f, st = ref.evaluate(R.capped_graph(s, 6.0, 20, 'cpu'))
    f, st = f.numpy(), st[0].numpy()
    scale = float(ref.energy_scale[0])
    assert scale >= abs(float(e[0])) > 0
    gaps = {'energy': abs(got['energy'] - float(e[0])) / scale,
            'forces': np.abs(got['forces'] - f).max() / np.abs(f).max(),
            'stress': np.abs(got['stress'] - st).max() / np.abs(st).max()}
    assert max(gaps.values()) < 3e-5, gaps


def _roll(lmax, mmax, gamma):
    """D(Ry(gamma)) on the m-major rows (a rotation about the edge axis)."""
    rows = list(so2.m_major(lmax, mmax))
    Ry = so2._rot_y(gamma)
    D = so2.fitted_wigner(lmax, tuple(Ry.reshape(-1)))
    return torch.as_tensor(D[np.ix_(rows, rows)])


def test_so2_linear_commutes_with_a_rotation_about_the_edge_axis():
    lmax, mmax, c_in, c_out, extra = 4, 2, 6, 5, 3
    sizes = so2.m_sizes(lmax, mmax)
    g = torch.Generator().manual_seed(0)
    n0 = sizes[0]
    w0 = torch.randn(n0 * c_in, extra + n0 * c_out, generator=g,
                     dtype=torch.float64)
    b0 = torch.randn(extra + n0 * c_out, generator=g, dtype=torch.float64)
    wm = [torch.randn(n * c_in, 2 * n * c_out, generator=g,
                      dtype=torch.float64) for n in sizes[1:]]
    rad = torch.randn(4, sum(sizes) * c_in, generator=g, dtype=torch.float64)
    x = torch.randn(4, len(so2.m_major(lmax, mmax)), c_in, generator=g,
                    dtype=torch.float64)
    rot = _roll(lmax, mmax, 0.7)
    y, ex = so2.so2_linear(x, w0, b0, wm, sizes, radial=rad, extra=extra)
    yr, exr = so2.so2_linear(rot @ x, w0, b0, wm, sizes, radial=rad,
                             extra=extra)
    assert torch.allclose(yr, rot @ y, atol=1e-12)
    assert torch.allclose(exr, ex, atol=1e-12)


def test_edge_frame_is_the_references_wigner_d():
    """The program's D (fitted D(Q), cos / sin powers) against the
    reference's (matrix exponentials of fitted generators), float64; and
    D takes each edge's harmonics to those of +y."""
    v = torch.as_tensor(np.random.default_rng(3).normal(size=(64, 3)))
    v[0] = torch.tensor([0.0, 2.0, 0.0])
    v[1] = torch.tensor([1e-9, -1.0, 0.0])
    rows = list(so2.m_major(4, 2))
    got = so2.edge_rotation(v, 4, 2)
    want = R.edge_wigner(v, 4)[:, rows]
    assert torch.allclose(got, want, atol=1e-10)
    from sevennet_finetuning_tpu_torch.ops.spherical import \
        spherical_harmonics
    sh = spherical_harmonics(4)
    pole = sh(torch.tensor([[0.0, 1.0, 0.0]], dtype=torch.float64))[0]
    assert torch.allclose(torch.einsum('ekd,ed->ek', got, sh(v)),
                          pole[rows].expand(64, -1), atol=1e-10)


@pytest.mark.parametrize('lmax,mmax,rows', [(4, 2, None), (4, 4, None),
                                             (5, 2, None), (4, 2, 5)])
def test_row_spans_hold_every_non_zero_of_the_edge_frame(lmax, mmax, rows):
    """Each m-major row's span (``row_spans``, the table the rotation
    kernels read) is its degree's block, and every entry of
    ``edge_rotation`` outside the spans is exactly 0 (float32 and
    float64, random directions and both poles); ``rows``: a prefix slice,
    the edge-degree embedding's m = 0 rows."""
    order = so2.m_major(lmax, mmax)
    k = len(order) if rows is None else rows
    d = (lmax + 1) ** 2
    spans = so2.row_spans(d, k)
    assert len(spans) == k
    for i, (first, count) in zip(order, spans):
        l = math.isqrt(i)
        assert (first, count) == (l * l, 2 * l + 1)
        assert first <= i < first + count
    off = torch.ones(k, d, dtype=torch.bool)
    for r, (first, count) in enumerate(spans):
        off[r, first:first + count] = False
    g = torch.Generator().manual_seed(lmax * 10 + mmax)
    for dtype in (torch.float32, torch.float64):
        v = torch.randn(200, 3, generator=g, dtype=dtype)
        v[0] = torch.tensor([0.0, 3.0, 0.0])
        v[1] = torch.tensor([0.0, -0.5, 0.0])
        D = so2.edge_rotation(v, lmax, mmax)[:, :k]
        assert torch.count_nonzero(D[:, off]) == 0
        assert torch.count_nonzero(D[:, ~off]) > 0.9 * D[:, ~off].numel()


def test_grid_pair_inverts_band_limited_coefficients():
    for lmax, mmax in ((4, 4), (4, 2)):
        to, frm = so2.grid_matrices(lmax, mmax, 18, torch.device('cpu'),
                                    torch.float64)
        scale = torch.as_tensor(so2.degree_rescale(lmax, mmax))
        assert torch.allclose(frm @ to, torch.diag(scale * scale),
                              atol=1e-12)
    to, frm = so2.node_grid_matrices(4, 18, torch.device('cpu'),
                                     torch.float64)
    assert torch.allclose(frm @ to, torch.eye(25, dtype=torch.float64),
                          atol=1e-12)
    assert np.allclose(so2.dh_weights(18), R.beta_weights(18), atol=1e-14)


def test_host_nearest_20_equals_the_references_list():
    """ft900 structure 0 (96 atoms, 10.3 A on its short axes: images
    repeat) at 12 A: every atom keeps exactly 20, the same (i, j, image)
    in the same order within each destination."""
    s = _ft900()[0]
    g = structure_to_graph(inputs.to_program(s), 12.0, {8: 1, 72: 0}, 20)
    i, j = g[K.EDGE_IDX]
    assert np.all(np.bincount(i, minlength=96) == 20)
    ref = R.capped_graph(s, 12.0, 20, 'cpu')
    cell = np.asarray(s['cell'], np.float64)
    img = np.rint(ref['shift'].double().numpy() @ np.linalg.inv(cell))
    order = np.argsort(i, kind='stable')
    want = np.argsort(ref['dst'].numpy(), kind='stable')
    got_rows = np.stack([i[order], j[order]], 1)
    want_rows = np.stack([ref['dst'].numpy()[want],
                          ref['src'].numpy()[want]], 1)
    assert np.array_equal(got_rows, want_rows)
    assert np.array_equal(g[K.CELL_SHIFT][order], img[want])


def test_device_md_refuses_a_model_with_max_neighbors(small):
    from sevennet_finetuning_tpu_torch.md import VelocityVerlet

    calc, _ = small
    s = inputs.to_program(_hfo2_12(4))
    vv = VelocityVerlet(s, calc, dt_fs=2.0)
    with pytest.raises(NotImplementedError, match='max_neighbors'):
        vv.run_device(2)
    halo = VelocityVerlet(s, calc, dt_fs=2.0, halo={'n_dev': 2})
    with pytest.raises(NotImplementedError, match='max_neighbors'):
        halo.run_device_halo(2)


def test_training_and_export_refuse_the_family(small, tmp_path):
    """The entry points of training (``Trainer``, and ``init_params``,
    the train pipeline's first step) and of both TorchScript exports
    refuse a spec that is not a ``ModelSpec``."""
    from sevennet_finetuning_tpu_torch.compat.torchscript_export import \
        export_serial
    from sevennet_finetuning_tpu_torch.compat.torchscript_export_parallel \
        import export_parallel
    from sevennet_finetuning_tpu_torch.model.nequip import init_params
    from sevennet_finetuning_tpu_torch.train.trainer import Trainer

    calc, _ = small
    with pytest.raises(NotImplementedError, match='training'):
        Trainer(calc.model, {}, device='cpu')
    with pytest.raises(NotImplementedError, match='training'):
        init_params(calc.spec, 0)
    with pytest.raises(NotImplementedError, match='TorchScript'):
        export_serial(calc.spec, {}, str(tmp_path / 'x.pt'))
    with pytest.raises(NotImplementedError, match='TorchScript'):
        export_parallel(calc.spec, {}, str(tmp_path / 'par'))


def test_configuration_holds_its_parameter_count():
    doc = json.loads(CONFIG.read_text())
    cfg = program.model_config(doc)
    spec = build_model_spec(cfg)
    n = sum(math.prod(s) for g in param_shapes(spec).values()
            for s in g.values())
    assert n == doc['parameters'] == 27_929_345
    ref = R.param_shapes(R.Spec(cfg))
    assert ref == {g: dict(d) for g, d in param_shapes(spec).items()}
    assert doc['reduced'] == [] and spec.max_neighbors == 20


def test_spans_and_counters(small):
    calc, _ = small
    s = inputs.to_program(_hfo2_12(6))
    tracing.reset()
    tracing.enable()
    calc.calculate(s)
    tracing.disable()
    recs = tracing.records()
    names = [r[0] for r in recs]
    for name in ('graph.build', 'graph.cap', 'eqv2.edge_embed', 'eqv2.head'):
        assert name in names, name
    attn = [r[6] for r in recs if r[0] == 'eqv2.attn']
    ffn = [r[6] for r in recs if r[0] == 'eqv2.ffn']
    assert [a['block'] for a in attn] == [0, 1]
    assert [a['block'] for a in ffn] == [0, 1]
    counts = tracing.counters()
    assert counts['graph.cap.edges'] == 12 * 20
    assert counts['graph.cap.candidates'] > counts['graph.cap.edges']
    assert attn[0]['edges'] >= 12 * 20 and ffn[0]['nodes'] >= 12


def test_energy_is_invariant_under_a_rotation_of_the_cluster(small):
    """The model is equivariant up to the S2 grid's aliasing: a rotated
    cluster's energy within 1e-3 relative, its forces rotated."""
    calc, _ = small
    s = _cluster()
    a = calc.calculate(inputs.to_program(s))
    rot = so2._rot_y(0.4) @ so2._rot_z(1.1)
    t = dict(s, pos=s['pos'] @ rot.T)
    b = calc.calculate(inputs.to_program(t))
    assert abs(a['energy'] - b['energy']) <= 1e-3 * abs(a['energy'])
    fr = a['forces'] @ rot.T
    assert np.abs(b['forces'] - fr).max() <= 5e-2 * np.abs(fr).max()


# --- the edge frame's kernels (csrc/so2.cu), on the card ------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card')
    return torch.device('cuda', 0)


def _frame_inputs(device, lmax=4, mmax=2, n=40, E=700, C=32, seed=0):
    """Node features, edge frames and a dst-sorted edge list with padded
    slots (the sentinel n, 37 of them, so E = 700 is not a multiple of
    the kernels' 8 edges a block), as a batch holds them."""
    from sevennet_finetuning_tpu_torch.ops.scatter import sort_perm

    g = torch.Generator().manual_seed(seed)
    live = E - 37
    dst = torch.sort(torch.randint(0, n, (live,), generator=g)).values
    src = torch.randint(0, n, (live,), generator=g)
    pad = torch.full((E - live,), n)
    dst = torch.cat([dst, pad]).int().to(device)
    src = torch.cat([src, pad]).int().to(device)
    perm, inv = sort_perm(src)
    v = torch.randn(E, 3, generator=g).to(device)
    x = torch.randn(n, (lmax + 1) ** 2, C, generator=g).to(device)
    return v, x, src, dst, perm, inv


def _grads(out, inputs, seed=1):
    g = torch.Generator().manual_seed(seed)
    w = torch.randn(out.shape, generator=g).to(out.device)
    return torch.autograd.grad((out * w).sum(), inputs)


def _off_support(D):
    """The entries of D [E, K, d] outside its rows' degree blocks."""
    off = torch.ones(D.shape[1:], dtype=torch.bool, device=D.device)
    for r, (first, count) in enumerate(so2.row_spans(D.shape[2],
                                                     D.shape[1])):
        off[r, first:first + count] = False
    return off


def _close(got, want, C):
    """Float32 sums in another order: 1e-5 relative and absolute at up to
    48 channels; at the cell's 128, sums of 2C products near 30 round
    apart by 2e-5, so chip_smoke's kernel tolerance, 1e-5 x max|plain|."""
    if C <= 48:
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    else:
        err = (got - want).detach().abs().max()
        assert float(err) <= 1e-5 * float(want.detach().abs().max())


def _same_on_support(got, want, C):
    """D's cotangent on the degree blocks, exactly 0 off them: the kernels
    leave out the cotangents of D's structural zeros, which
    ``edge_rotation``'s backward multiplies by zeros."""
    off = _off_support(got)
    _close(got[:, ~off], want[:, ~off], C)
    assert torch.count_nonzero(got[:, off]) == 0


@pytest.mark.card
@pytest.mark.parametrize('lmax,mmax,C', [(4, 2, 48), (4, 2, 128),
                                         (4, 4, 48), (5, 2, 128),
                                         (4, 2, 45)])
def test_rotation_kernels_match_their_plain_version(card, lmax, mmax, C):
    """``EdgeRotate`` / ``EdgeRotateBack`` (the gathers folded in, both
    legs a launch, the sums at the sources and destinations on the
    scatter kernels) against the plain gathers and batched products on
    the card, float32 sums in another order (``_close``): values, x's
    and y's cotangents, D's on its degree blocks (0 off them), the edge
    vectors' through ``edge_rotation``; the 5-row slice; C = 45 takes the
    kernels' scalar channels; two launches give the same bits."""
    v, x, src, dst, perm, inv = _frame_inputs(card, lmax, mmax, C=C)
    D = so2.edge_rotation(v, lmax, mmax).detach().requires_grad_(True)
    x.requires_grad_(True)
    got = so2.rotate_in(D, x, src, dst, perm, inv)
    want = so2.rotate_in_plain(D, x, src, dst, perm, inv)
    live = (dst < x.shape[0])
    _close(got[live], want[live], C)
    assert torch.equal(got, so2.rotate_in(D, x, src, dst, perm, inv))
    gd, gx = _grads(got * live[:, None, None], (D, x))
    wd, wx = _grads(want * live[:, None, None], (D, x))
    _same_on_support(gd, wd, C)
    _close(gx, wx, C)
    again = so2.rotate_in(D, x, src, dst, perm, inv) * live[:, None, None]
    assert torch.equal(gd, _grads(again, (D, x))[0])
    for rows in (None, 5):
        Dr = D if rows is None else D[:, :rows]
        y = torch.randn(D.shape[0], Dr.shape[1], C, device=card,
                        requires_grad=True)
        got = so2.rotate_back(Dr, y)
        want = torch.bmm(Dr.transpose(1, 2), y)
        _close(got, want, C)
        (gd, gy), (wd, wy) = _grads(got, (D, y)), _grads(want, (D, y))
        _same_on_support(gd, wd, C)
        _close(gy, wy, C)
    # the edge vectors' cotangent, which the forces read: into the frame,
    # a product of the two legs, back out
    vec = v.clone().requires_grad_(True)

    def composed(card_path):
        Dv = so2.edge_rotation(vec, lmax, mmax)
        rin = so2.rotate_in if card_path else so2.rotate_in_plain
        m = rin(Dv, x.detach(), src, dst, perm, inv) * live[:, None, None]
        m = m[:, :, :C] * m[:, :, C:]
        return (so2.rotate_back(Dv, m) if card_path else
                torch.bmm(Dv.transpose(1, 2), m))

    gv, = _grads(composed(True), (vec,))
    wv, = _grads(composed(False), (vec,))
    assert float((gv - wv).abs().max()) <= 1e-5 * float(wv.abs().max())


@pytest.mark.card
def test_rotation_grad_accumulates_on_the_support(card):
    """``so2_rotate_grad`` with ``accumulate``: out + A (x) B on the degree
    blocks, out unchanged off them."""
    v, x, src, dst, perm, inv = _frame_inputs(card, C=64)
    D = so2.edge_rotation(v, 4, 2)
    a = torch.randn(D.shape[0], D.shape[1], 64, device=card)
    base = torch.randn(D.shape, device=card)
    s32 = src.clamp(max=x.shape[0] - 1)
    got = so2._rotate_grad((a,), (None,), (x,), (s32,), base.clone(), True)
    want = base + torch.bmm(a, x[s32.long()].transpose(1, 2))
    off = _off_support(D)
    torch.testing.assert_close(got[:, ~off], want[:, ~off], rtol=1e-5,
                               atol=1e-5)
    assert torch.equal(got[:, off], base[:, off])


@pytest.mark.card
@pytest.mark.parametrize('mmax', [2, 4])
def test_s2_act_kernels_match_their_plain_version(card, mmax):
    to, frm = (so2.grid_matrices(4, mmax, 18, card, torch.float32)
               if mmax < 4 else
               so2.node_grid_matrices(4, 18, card, torch.float32))
    g = torch.Generator().manual_seed(2)
    x = torch.randn(300, to.shape[1], 64, generator=g).to(card)
    x.requires_grad_(True)
    got = so2.S2ActCard.apply(x, to, frm)
    want = so2.S2Act.apply(x, to, frm)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(_grads(got, (x,))[0], _grads(want, (x,))[0],
                               rtol=1e-5, atol=1e-5)
