"""The port's dense ops against the JAX package's, on the same numpy-seeded
float32 inputs: spherical harmonics, radial basis and cutoffs, safe_norm
(value and gradient, at r = 0 too), activations, mlp, linear (with
``out_stride``) and gate.  Tolerance: 1e-5 relative to the largest
magnitude of the JAX result (float32 sums in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sevennet_finetuning_tpu.irreps import Irreps as JIrreps
from sevennet_finetuning_tpu.ops import activations as j_act
from sevennet_finetuning_tpu.ops import gate as j_gate
from sevennet_finetuning_tpu.ops import linear as j_lin
from sevennet_finetuning_tpu.ops import mlp as j_mlp
from sevennet_finetuning_tpu.ops import radial as j_rad
from sevennet_finetuning_tpu.ops import spherical as j_sph
from sevennet_finetuning_tpu.ops import util as j_util
from sevennet_finetuning_tpu_torch.irreps import Irreps
from sevennet_finetuning_tpu_torch.ops import activations as t_act
from sevennet_finetuning_tpu_torch.ops import gate as t_gate
from sevennet_finetuning_tpu_torch.ops import linear as t_lin
from sevennet_finetuning_tpu_torch.ops import mlp as t_mlp
from sevennet_finetuning_tpu_torch.ops import radial as t_rad
from sevennet_finetuning_tpu_torch.ops import spherical as t_sph
from sevennet_finetuning_tpu_torch.ops import util as t_util

torch.set_num_threads(2)
RTOL = 1e-5


def _f32(a):
    return np.asarray(a, np.float32)


def _close(got, want, rtol=RTOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-30)
    assert float(np.abs(got - want).max()) <= rtol * scale


def _vec(n=64, seed=0, zero_rows=2):
    v = np.random.default_rng(seed).normal(size=(n, 3)).astype(np.float32)
    v[:zero_rows] = 0.0   # padded edges carry zero vectors
    return v


@pytest.mark.parametrize('lmax', [1, 2, 3])
@pytest.mark.parametrize('normalize', [True, False])
def test_spherical_harmonics(lmax, normalize):
    v = _vec(zero_rows=0)
    want = j_sph.spherical_harmonics(lmax, normalize)(jnp.asarray(v))
    got = t_sph.spherical_harmonics(lmax, normalize)(torch.from_numpy(v))
    _close(got, want)


def test_safe_norm_value_and_grad_at_zero():
    v = _vec()
    want = j_util.safe_norm(jnp.asarray(v))
    want_g = jax.grad(lambda x: j_util.safe_norm(x).sum())(jnp.asarray(v))
    tv = torch.from_numpy(v).requires_grad_(True)
    got = t_util.safe_norm(tv)
    got_g, = torch.autograd.grad(got.sum(), tv)
    _close(got, want)
    _close(got_g, want_g)
    assert torch.isfinite(got_g).all()
    assert float(got_g[:2].abs().max()) == 0.0


@pytest.mark.parametrize('cutoff_fn', ['poly', 'xplor'])
def test_radial_embedding_value_and_grad(cutoff_fn):
    v = _vec(seed=1)
    coeffs = _f32(j_rad.bessel_init(5.0, 8))

    def j_emb(x):
        r = j_util.safe_norm(x) * 2.0
        env = (j_rad.poly_cutoff(r, 5.0, 6) if cutoff_fn == 'poly'
               else j_rad.xplor_cutoff(r, 5.0, 4.5))
        return j_rad.bessel_basis(r, jnp.asarray(coeffs), 5.0) * env[:, None]

    def t_emb(x):
        r = t_util.safe_norm(x) * 2.0
        env = (t_rad.poly_cutoff(r, 5.0, 6) if cutoff_fn == 'poly'
               else t_rad.xplor_cutoff(r, 5.0, 4.5))
        return t_rad.bessel_basis(r, torch.from_numpy(coeffs),
                                  5.0) * env[:, None]

    want = j_emb(jnp.asarray(v))
    want_g = jax.grad(lambda x: j_emb(x).sum())(jnp.asarray(v))
    tv = torch.from_numpy(v).requires_grad_(True)
    got = t_emb(tv)
    got_g, = torch.autograd.grad(got.sum(), tv)
    _close(got, want)
    _close(got_g, want_g)
    assert torch.isfinite(got_g).all()


@pytest.mark.parametrize('name', ['silu', 'ssp', 'tanh', 'abs', 'relu',
                                  'sigmoid', 'elu'])
def test_activations(name):
    x = np.random.default_rng(2).normal(size=(257,)).astype(np.float32) * 3
    assert t_act.moment2_const(name) == j_act.moment2_const(name)
    want = j_act.get_activation(name, True)(jnp.asarray(x))
    got = t_act.get_activation(name, True)(torch.from_numpy(x))
    _close(got, want)


def test_mlp():
    rng = np.random.default_rng(3)
    ws = [_f32(rng.normal(size=s)) for s in ((8, 16), (16, 16), (16, 40))]
    x = _f32(rng.normal(size=(50, 8)))
    want = j_mlp.mlp_apply([jnp.asarray(w) for w in ws], jnp.asarray(x),
                           'silu')
    got = t_mlp.mlp_apply([torch.from_numpy(w) for w in ws],
                          torch.from_numpy(x), 'silu')
    _close(got, want)


@pytest.mark.parametrize('out_stride', [False, True])
@pytest.mark.parametrize('biases', [False, True])
def test_linear(out_stride, biases):
    ir_in, ir_out = '8x0e+4x1e+2x2e+3x1o', '6x0e+5x1e+4x2e+2x0o'
    js = j_lin.linear_spec(JIrreps(ir_in), JIrreps(ir_out), biases=biases)
    ts = t_lin.linear_spec(Irreps(ir_in), Irreps(ir_out), biases=biases)
    assert len(js.instructions) == len(ts.instructions)
    for a, b in zip(js.instructions, ts.instructions):
        assert (a.i_in, a.i_out, a.coeff, tuple(a.weight_shape)) == (
            b.i_in, b.i_out, b.coeff, tuple(b.weight_shape))
    rng = np.random.default_rng(4)
    ws = [_f32(rng.normal(size=ins.weight_shape)) for ins in js.instructions]
    x = _f32(rng.normal(size=(33, JIrreps(ir_in).dim)))
    want = j_lin.apply_linear(js, [jnp.asarray(w) for w in ws],
                              jnp.asarray(x), out_stride=out_stride)
    got = t_lin.apply_linear(ts, [torch.from_numpy(w) for w in ws],
                             torch.from_numpy(x), out_stride=out_stride)
    _close(got, want)


@pytest.mark.parametrize('irreps', ['16x0e+8x1e+4x2e', '8x0e+4x1o+4x1e',
                                    '6x0o+3x1e'])
def test_gate(irreps):
    acts_s = {'e': 'silu', 'o': 'tanh'}
    acts_g = {'e': 'silu', 'o': 'tanh'}
    js = j_gate.gate_spec(JIrreps(irreps), acts_s, acts_g)
    ts = t_gate.gate_spec(Irreps(irreps), acts_s, acts_g)
    assert tuple(js.perm) == ts.perm
    assert str(js.irreps_in) == str(ts.irreps_in)
    x = _f32(np.random.default_rng(5).normal(size=(21, js.irreps_in.dim)))
    want = j_gate.apply_gate(js, jnp.asarray(x))
    got = t_gate.apply_gate(ts, torch.from_numpy(x))
    _close(got, want)
