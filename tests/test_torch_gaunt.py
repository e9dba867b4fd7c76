"""The port's Gaunt family against the JAX package's.

On the same numpy-seeded inputs through both packages, the JAX side
under ``jax.enable_x64(False)`` (the test session turns x64 on, which
would make its FFTs complex128):

- the host tables ``y_coeffs`` / ``z_coeffs`` / ``fit_gaunt_to_w3j`` bit
  for bit; ``to_fourier`` / ``to_spherical``, ``_real_samples`` (an odd
  M through ``irfft2(s=(M, M))``) and ``_coeffs_from_real_samples``
  within 1e-6 of the largest magnitude;
- the convolution on each of the port's paths (``apply_gaunt_conv``'s
  coupling layout, ``gaunt_conv_fft``'s rfft and complex variants)
  against JAX's FFT formulation: value, and the gradient of a seeded
  projection with respect to x and edge_attr (1e-5 relative); the two
  FFT variants within 1e-5 of each other in the port;
- ``apply_gaunt_pb`` and its gradient (1e-5 relative);
- ``init_params`` bit for bit for ``gaunt`` and ``gaunt_gate``;
- energy, forces and stress of the whole model (1e-5 relative) with the
  port's rotation equivariance;
- one train step per family (loss terms 1e-5, per-leaf gradients 1e-4 of
  the leaf's max|g|).
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sevennet_finetuning_tpu.irreps import Irreps as JIrreps
from sevennet_finetuning_tpu.ops import gaunt as jg
from sevennet_finetuning_tpu_torch import keys as K
from sevennet_finetuning_tpu_torch.irreps import Irreps
from sevennet_finetuning_tpu_torch.model.build import build_model_spec
from sevennet_finetuning_tpu_torch.ops import gaunt as tg
from tests.test_torch_mace import (_ckdtree, _rel_close,  # noqa: F401
                                   check_model_matches_jax,
                                   check_rotation_equivariance,
                                   check_train_step_matches_jax,
                                   narrow_config)

torch.set_num_threads(2)


def test_host_tables_match_jax():
    for L in (1, 2, 3):
        assert np.array_equal(tg.y_coeffs(L), jg.y_coeffs(L))
        assert np.array_equal(tg.z_coeffs(L), jg.z_coeffs(L))
        assert np.array_equal(tg.z_coeffs(2 * L, L), jg.z_coeffs(2 * L, L))
        assert np.array_equal(tg.weight_align_matrix(L),
                              jg.weight_align_matrix(L))
        for L2 in (1, 2, 3):
            assert np.array_equal(tg.fit_gaunt_to_w3j(L, L2),
                                  jg.fit_gaunt_to_w3j(L, L2))


@pytest.mark.parametrize('Lg,L', [(1, 2), (2, 4), (3, 5)])
def test_fourier_grids_match_jax(Lg, L):
    """SH -> Fourier -> real samples (odd M) -> coefficients -> SH."""
    rng = np.random.default_rng(Lg)
    x = rng.normal(size=(5, 3, (Lg + 1) ** 2)).astype(np.float32)
    with jax.enable_x64(False):
        jf = jg.to_fourier(jnp.asarray(x), Lg)
        js = jg._real_samples(jf, Lg, L)
        jc = jg._coeffs_from_real_samples(js, L)
        jsph = jg.to_spherical(jc, L, Lg)
        want = [np.asarray(a) for a in (jf, js, jc, jsph)]
    tf = tg.to_fourier(torch.tensor(x), Lg)
    ts = tg._real_samples(tf, Lg, L)
    tc = tg._coeffs_from_real_samples(ts, L)
    tsph = tg.to_spherical(tc, L, Lg)
    assert ts.shape[-2:] == (2 * L + 1, 2 * L + 1)
    for got, w in zip((tf, ts, tc, tsph), want):
        assert got.numpy().dtype == w.dtype
        _rel_close(got.numpy(), w, rtol=1e-6)
    # the round trip through the samples is the identity on x
    _rel_close(tsph.numpy(), x, rtol=1e-5)


def _conv_case(seed=0, mul=3, N=6, E=17):
    """A narrow Gaunt convolution (x l <= 2, filter l <= 2) with seeded
    inputs and an ascending dst whose last two edges are sentinels."""
    irreps_x = '3x0e+3x1o+3x2e'.replace('3', str(mul))
    j_spec = jg.gaunt_conv_spec(JIrreps(irreps_x), JIrreps('1x0e+1x1o+1x2e'),
                                JIrreps(irreps_x), (8,), 8, 'silu')
    t_spec = tg.gaunt_conv_spec(Irreps(irreps_x), Irreps('1x0e+1x1o+1x2e'),
                                Irreps(irreps_x), (8,), 8, 'silu')
    rng = np.random.default_rng(seed)

    def f(*s):
        return rng.normal(size=s).astype(np.float32)

    mlp = [f(8, 8), f(8, t_spec.weight_numel)]
    x = f(N, Irreps(irreps_x).dim)
    attr = f(E, 9)
    emb = f(E, 8)
    src = rng.integers(0, N, E).astype(np.int32)
    dst = np.sort(rng.integers(0, N, E)).astype(np.int32)
    dst[-2:] = N
    proj = f(N, Irreps(irreps_x).dim)
    return j_spec, t_spec, mlp, x, attr, emb, src, dst, proj


def _j_conv(case, rfft):
    j_spec, _, mlp, x, attr, emb, src, dst, proj = case
    N = x.shape[0]
    with jax.enable_x64(False):
        def f(x_, a_):
            out = jg.apply_gaunt_conv(
                j_spec, [jnp.asarray(w) for w in mlp], x_, a_,
                jnp.asarray(emb), jnp.asarray(src), jnp.asarray(dst), N,
                jnp.asarray(np.float32(4.0)), sorted_dst=True, rfft=rfft)
            return jnp.sum(out * proj), out

        (_, out), (gx, ga) = jax.jit(jax.value_and_grad(
            f, argnums=(0, 1), has_aux=True))(jnp.asarray(x),
                                              jnp.asarray(attr))
    return [np.asarray(a) for a in (out, gx, ga)]


def _t_conv(case, rfft, sorted_dst=True):
    """The port's convolution: ``rfft`` 'coupling' for ``apply_gaunt_conv``,
    else ``gaunt_conv_fft`` with that ``rfft``."""
    _, t_spec, mlp, x, attr, emb, src, dst, proj = case
    N = x.shape[0]
    xt = torch.tensor(x, requires_grad=True)
    at = torch.tensor(attr, requires_grad=True)
    conv = (tg.apply_gaunt_conv if rfft == 'coupling'
            else functools.partial(tg.gaunt_conv_fft, rfft=rfft))
    out = conv(
        t_spec, [torch.tensor(w) for w in mlp], xt, at, torch.tensor(emb),
        torch.tensor(src), torch.tensor(dst), N, torch.tensor(4.0),
        sorted_dst=sorted_dst)
    (out * torch.tensor(proj)).sum().backward()
    return [a.detach().numpy() for a in (out, xt.grad, at.grad)]


@pytest.mark.parametrize('rfft', [True, False, 'coupling'])
def test_gaunt_conv_matches_jax(rfft):
    """Value and gradients (x, edge_attr) on one path of the port (the
    FFT formulation's variant, or the coupling layout against JAX's rfft
    variant), both packages; the sentinel edges drop; the unsorted
    aggregation gives the same."""
    case = _conv_case()
    want = _j_conv(case, True if rfft == 'coupling' else rfft)
    got = _t_conv(case, rfft)
    for g, w, name in zip(got, want, ('out', 'grad x', 'grad edge_attr')):
        _rel_close(g, w, name=name)
    assert np.all(got[2][-2:] == 0.0)
    for g, w in zip(_t_conv(case, rfft, sorted_dst=False), got):
        _rel_close(g, w)


def test_gaunt_conv_rfft_matches_complex():
    """``gaunt_conv_fft``'s Hermitian variant against its complex one."""
    case = _conv_case(seed=1, mul=2)
    fast, slow = _t_conv(case, True), _t_conv(case, False)
    for g, w in zip(fast, slow):
        _rel_close(g, w)


@pytest.mark.parametrize('irreps,corr', [('3x0e+3x1o+3x2e', 2),
                                         ('2x0e+2x1o+2x2e', 3),
                                         ('4x0e+4x1o', 3)])
def test_gaunt_pb_matches_jax(irreps, corr):
    j_spec = jg.gaunt_pb_spec(JIrreps(irreps), JIrreps(irreps), corr)
    t_spec = tg.gaunt_pb_spec(Irreps(irreps), Irreps(irreps), corr)
    rng = np.random.default_rng(corr)
    w = jg.init_gaunt_pb(j_spec, rng)
    assert {k: v.shape for k, v in w.items()} == tg.gaunt_pb_shapes(t_spec)
    x = rng.normal(size=(5, Irreps(irreps).dim)).astype(np.float32)
    proj = rng.normal(size=x.shape).astype(np.float32)
    with jax.enable_x64(False):
        def f(x_):
            out = jg.apply_gaunt_pb(j_spec, w, x_)
            return jnp.sum(out * proj), out

        (_, want), want_g = jax.jit(jax.value_and_grad(f, has_aux=True))(
            jnp.asarray(x))
    xt = torch.tensor(x, requires_grad=True)
    got = tg.apply_gaunt_pb(t_spec, {k: torch.tensor(v)
                                     for k, v in w.items()}, xt)
    (got * torch.tensor(proj)).sum().backward()
    _rel_close(got, np.asarray(want))
    _rel_close(xt.grad, np.asarray(want_g))


def _gaunt_config(itype):
    return narrow_config(itype, **{K.NUM_CONVOLUTION: 3,
                                   K.CONV_DENOMINATOR: 8.0})


@pytest.mark.parametrize('itype', ['gaunt', 'gaunt_gate'])
def test_gaunt_model_matches_jax(itype):
    cfg = _gaunt_config(itype)
    kinds = [(b.block_type, b.conv_kind)
             for b in build_model_spec(cfg).blocks]
    assert kinds[0] == (itype, 'cg') and kinds[1] == (itype, 'gaunt')
    model, tb = check_model_matches_jax(cfg)
    check_rotation_equivariance(model, tb)


@pytest.mark.parametrize('itype', ['gaunt', 'gaunt_gate'])
def test_gaunt_train_step_matches_jax(itype):
    check_train_step_matches_jax(_gaunt_config(itype))
