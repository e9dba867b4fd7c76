"""The Gaunt convolution as a coupling layout (``ops/gaunt.gaunt_layout``)
against the FFT formulation it is derived from (``gaunt_conv_fft``).

- the layout's couplings: as many as the Gaunt coefficients that are not
  zero (``benchmark/count/gaunt.gaunt_nnz``, the sphere quadrature's
  count) at MACE-MP-0 medium's widths (21) and at SevenNet-0's widths
  (the gaunt and gaunt_gate families of ``golden/families_jax_cpu.npz``),
  no path that parity or the triangle rule forbids, and every plan of the
  CUDA kernels builds from it;
- in float64, ``apply_gaunt_conv`` equals ``gaunt_conv_fft`` (both
  variants) to 1e-12 of the largest magnitude in value and in the
  gradients of x, the harmonics, the radial embedding and the MLP
  weights, on sorted and unsorted destinations, and as the halo split's
  two-part sum;
- ``gradgradcheck`` through the coupling path (training's double
  backward);
- the plain CG table rounds each coupling to float32 once, as before.
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmark.count.gaunt import gaunt_nnz
from sevennet_finetuning_tpu_torch import keys as K
from sevennet_finetuning_tpu_torch.irreps import Irreps
from sevennet_finetuning_tpu_torch.model.build import build_model_spec
from sevennet_finetuning_tpu_torch.ops import cg_tables as ct
from sevennet_finetuning_tpu_torch.ops import gaunt as tg
from sevennet_finetuning_tpu_torch.ops.fused_conv import (_group_ccat,
                                                          layout_from_spec)
from sevennet_finetuning_tpu_torch.ops.fused_conv_agg import agg_config

ROOT = Path(__file__).resolve().parents[1]
FAMILIES = ROOT / 'sevennet_finetuning_tpu_torch' / 'golden' \
    / 'families_jax_cpu.npz'

torch.set_num_threads(2)

REL = 1e-12


def _family_specs(name):
    """The Gaunt convolution specs of a families-golden configuration."""
    cfg = json.loads(str(np.load(FAMILIES)['configs']))[name]
    cfg[K.TYPE_MAP] = {int(z): i for z, i in cfg[K.TYPE_MAP]}
    return [b.gaunt_conv for b in build_model_spec(cfg).blocks
            if b.gaunt_conv is not None]


def _mp0_spec():
    irx = Irreps('128x0e+128x1o')
    return tg.gaunt_conv_spec(irx, Irreps.spherical_harmonics(3, -1), irx,
                              (64, 64, 64), 8, 'silu')


SPECS = {
    'mp0_medium': _mp0_spec,
    'gaunt_sevennet0': lambda: _family_specs('gaunt_sevennet0_widths')[0],
    'gaunt_gate_sevennet0': lambda: _family_specs(
        'gaunt_gate_sevennet0_widths')[0],
}


@pytest.mark.parametrize('name', list(SPECS))
def test_layout_couplings_are_the_gaunt_coefficients(name):
    spec = SPECS[name]()
    layout = tg.gaunt_layout(spec)
    nnz = sum(len(p.nnz) for g in layout.groups for p in g.paths)
    assert nnz == gaunt_nnz(spec.L_x, spec.L_f, spec.L_out)
    if name == 'mp0_medium':
        assert nnz == 21
    ir_of = {}
    for irreps in (spec.irreps_x, spec.irreps_filter):
        for mi, sl in zip(irreps, irreps.slices()):
            ir_of[id(irreps), sl.start] = mi.ir
    path_out = tg._coupling(spec)[1]
    n_path = 0
    for g in layout.groups:
        a = ir_of[id(spec.irreps_x), g.x_off]
        b = ir_of[id(spec.irreps_filter), g.sh_off]
        assert g.mul == spec.mul and (g.d1, g.d2) == (a.dim, b.dim)
        for p in g.paths:
            c = spec.irreps_out[path_out[n_path]].ir
            assert p.d_out == c.dim
            # each path its own weight slice, in path order
            assert p.w_off == n_path * spec.mul
            n_path += 1
            # parity and the triangle rule: every path a product that
            # Gaunt's integral allows
            assert abs(a.l - b.l) <= c.l <= a.l + b.l
            assert (a.l + b.l + c.l) % 2 == 0
            assert a.p * b.p == c.p
    assert layout.dim_w == n_path * spec.mul
    assert layout.dim_msg == sum(p.d_out * spec.mul for g in layout.groups
                                 for p in g.paths)


@pytest.mark.parametrize('name', list(SPECS))
def test_every_kernel_plan_builds_from_the_layout(name):
    """The host plans of cg_agg, cg_multi / cg_gmulti, cg_gagg and every
    cg_quad mode take the layout (dims <= 7, each w and msg column one
    path's, the sh couplings inside the Wigner-3j selection rule)."""
    layout = tg.gaunt_layout(SPECS[name]())
    cfg = agg_config(layout)
    ct.agg_plan(layout, cfg.nodes, cfg.warps)
    ct.gmulti_plan(layout, 16)
    ct.gagg_plan(layout)
    for mode in ct.QUAD_MODES:
        ct.quad_plan(layout, mode, 8, 8)


def _case(seed, mul=3, N=7, E=29, irx='{m}x0e+{m}x1o',
          irf='1x0e+1x1o+1x2e+1x3o', dtype=torch.float64):
    """A narrow Gaunt convolution with seeded inputs, every one a leaf
    that needs its gradient; ``dst`` ascending with two sentinel edges."""
    irx = Irreps(irx.format(m=mul))
    spec = tg.gaunt_conv_spec(irx, Irreps(irf), irx, (6,), 5, 'silu')
    rng = np.random.default_rng(seed)

    def leaf(*s):
        return torch.tensor(rng.normal(size=s), dtype=dtype,
                            requires_grad=True)

    mlp = [leaf(5, 6), leaf(6, spec.weight_numel)]
    x, sh, emb = leaf(N, irx.dim), leaf(E, Irreps(irf).dim), leaf(E, 5)
    src = torch.tensor(rng.integers(0, N, E), dtype=torch.int32)
    dst = torch.tensor(np.sort(rng.integers(0, N, E)), dtype=torch.int32)
    dst[-2:] = N
    proj = torch.tensor(rng.normal(size=(N, irx.dim)), dtype=dtype)
    return spec, mlp, x, sh, emb, src, dst, N, proj


def _value_and_grads(conv, case, sorted_dst, **kw):
    spec, mlp, x, sh, emb, src, dst, N, proj = case
    leaves = [x, sh, emb, *mlp]
    out = conv(spec, mlp, x, sh, emb, src, dst, N,
               torch.tensor(2.5, dtype=x.dtype), sorted_dst=sorted_dst, **kw)
    grads = torch.autograd.grad((out * proj).sum(), leaves)
    return [out.detach(), *grads]


def _rel(got, want):
    return float(((got - want).abs().max() / want.abs().max()).detach())


@pytest.mark.parametrize('rfft', [True, False])
@pytest.mark.parametrize('sorted_dst', [True, False])
@pytest.mark.parametrize('irx,irf', [
    ('{m}x0e+{m}x1o', '1x0e+1x1o+1x2e+1x3o'),
    ('{m}x0e+{m}x1o+{m}x2e', '1x0e+1x1o+1x2e')])
def test_coupling_path_equals_the_fft_formulation(rfft, sorted_dst, irx,
                                                  irf):
    case = _case(3, irx=irx, irf=irf)
    got = _value_and_grads(tg.apply_gaunt_conv, case, sorted_dst)
    want = _value_and_grads(tg.gaunt_conv_fft, case, sorted_dst, rfft=rfft)
    names = ('value', 'x', 'harmonics', 'embedding', 'mlp w0', 'mlp w1')
    for g, w, n in zip(got, want, names):
        assert _rel(g, w) <= REL, (n, _rel(g, w))
    # the sentinel edges' harmonics get no cotangent
    assert torch.all(got[2][-2:] == 0)


def test_halo_split_sum_equals_the_whole():
    """Two edge partitions, each with denominator 1, summed and then
    divided: the whole convolution, as the model's halo split runs it."""
    spec, mlp, x, sh, emb, src, dst, N, _ = _case(4)
    den = torch.tensor(2.5, dtype=x.dtype)
    whole = tg.gaunt_conv_fft(spec, mlp, x, sh, emb, src, dst, N, den,
                              sorted_dst=True)
    cut = 11
    parts = [tg.apply_gaunt_conv(spec, mlp, x, sh[sl], emb[sl], src[sl],
                                 dst[sl], N, torch.ones_like(den),
                                 sorted_dst=True)
             for sl in (slice(0, cut), slice(cut, None))]
    assert _rel((parts[0] + parts[1]) / den, whole) <= REL


def test_gradgradcheck_through_the_coupling_path():
    spec, mlp, x, sh, emb, src, dst, N, _ = _case(5, mul=2, N=4, E=9)
    den = torch.tensor(2.0, dtype=torch.float64)
    assert torch.autograd.gradgradcheck(
        lambda x_, sh_, emb_, w1: tg.apply_gaunt_conv(
            spec, [mlp[0], w1], x_, sh_, emb_, src, dst, N, den,
            sorted_dst=True),
        (x, sh, emb, mlp[1]), fast_mode=True)


def test_plain_table_rounds_each_coupling_once_in_float32():
    """``_group_ccat`` keeps the couplings in float64; cast to float32 it
    equals the couplings rounded one by one (the kernels' tables)."""
    from sevennet_finetuning_tpu_torch.ops.tensor_product import uvu_tp_spec

    tp = uvu_tp_spec(Irreps('4x0e+4x1o+4x2e'), Irreps('1x0e+1x1o+1x2e'),
                     Irreps('4x0e+4x1o+4x2e'))
    for layout in (layout_from_spec(tp), tg.gaunt_layout(_mp0_spec())):
        for g in layout.groups:
            want = np.zeros(_group_ccat(g).shape, np.float32)
            k0 = 0
            for p in g.paths:
                for (k, i, j, c) in p.nnz:
                    want[i, j, k0 + k] = c
                k0 += p.d_out
            got = torch.as_tensor(_group_ccat(g), dtype=torch.float32)
            assert np.array_equal(got.numpy(), want)
