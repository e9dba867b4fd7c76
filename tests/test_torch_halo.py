"""Halo-parallel inference and MD of the port against its serial model and
the JAX package, on the CPU.

The JAX side runs ``make_halo_forward`` under ``shard_map`` on the
8-device virtual mesh of ``tests/conftest.py``; the port holds every
partition in one process (``LocalTransport``).  Both
packages build their neighbor lists with the native core.  Limits are
the JAX tests' (``tests/test_halo_md.py``, ``tests/test_md_device.py``):

- ``build_halo_plan``: every array of the plan bit-equal to JAX's, for
  D = 1, 2, 4 on the JAX test's 60-atom cell, the 2-D bricks, and the
  2x2x2 brick on ft900 structure 0 (96-atom HfO2) replicated to 768
  atoms; ``choose_dims`` refuses the same slabs as JAX, with the same
  message;
- the forward: energy within 1e-3 relative of the port's serial
  ``Calculator`` and of JAX's halo forward, forces within 1e-4 eV/A (2e-4
  at 768 atoms, as JAX's brick test), stress within 1e-6;
- the MACE and Gaunt families and a custom block (its ``ctx`` carrying
  the exchange) under ``halo_split`` against the serial model, the same
  limits;
- the exchange alone: gradcheck and gradgradcheck in float64 (its
  backward is its forward's adjoint and is itself differentiable);

Halo MD and the two gloo ranks: ``tests/test_torch_halo_md.py``.
"""

import dataclasses
from pathlib import Path

import numpy as np
import pytest
import torch

from sevennet_finetuning_tpu_torch import keys as K

ROOT = Path(__file__).resolve().parent.parent
FT900 = ROOT / 'experiments/ft_reewc_900/data/ft900.extxyz'
torch.set_num_threads(2)


@pytest.fixture(autouse=True, scope='module')
def _native_neighbor_list():
    """Both packages build this file's graphs with the native neighbor
    list; restored after."""
    with pytest.MonkeyPatch.context() as mp:
        mp.delenv('SEVENN_NO_NATIVE', raising=False)
        yield


def _arrays(n=60, seed=0, a=12.0, species=('O', 'Si')):
    rng = np.random.default_rng(seed)
    return dict(species=[species[i % 2] for i in range(n)],
                pos=rng.uniform(0, a, (n, 3)), cell=np.eye(3) * a)


def _cfg(tm, cutoff=3.5, **over):
    """The JAX halo test's narrow model (``tests/test_halo_md.py``)."""
    cfg = {K.NUM_SPECIES: len(tm), K.TYPE_MAP: tm,
           K.NODE_FEATURE_MULTIPLICITY: 4, K.LMAX: 1,
           K.NUM_CONVOLUTION: 3, K.CUTOFF: cutoff, K.IS_PARITY: True,
           K.CONV_DENOMINATOR: 15.0, K.SHIFT: -3.0, K.SCALE: 1.2}
    cfg.update(over)
    return cfg


def _both(arrays, reps=(1, 1, 1)):
    """(port Structure, JAX Structure) of the arrays, replicated."""
    from sevennet_finetuning_tpu.data.vasp import Structure as JS
    from sevennet_finetuning_tpu.data.vasp import replicate as jrep
    from sevennet_finetuning_tpu_torch.data.vasp import Structure, replicate

    return replicate(Structure(**arrays), *reps), jrep(JS(**arrays), *reps)


def _hfo2_768():
    from sevennet_finetuning_tpu.data.readers import read_extxyz as jread
    from sevennet_finetuning_tpu.data.vasp import replicate as jrep
    from sevennet_finetuning_tpu_torch.data.readers import read_extxyz
    from sevennet_finetuning_tpu_torch.data.vasp import replicate

    return (replicate(read_extxyz(str(FT900))[0], 2, 2, 2),
            jrep(jread(str(FT900))[0], 2, 2, 2))


# (name, structure maker, type map, cutoff, D, dims)
SI_O = {8: 0, 14: 1}
HF_O = {8: 0, 72: 1}
CASES = {
    'd1': (lambda: _both(_arrays()), SI_O, 3.5, 1, None),
    'd2': (lambda: _both(_arrays()), SI_O, 3.5, 2, None),
    'd4': (lambda: _both(_arrays(), (2, 1, 1)), SI_O, 3.5, 4, None),
    'brick221': (lambda: _both(_arrays(40, 2, 9.0), (2, 2, 2)), SI_O, 3.0,
                 4, (2, 2, 1)),
    'brick122': (lambda: _both(_arrays(40, 2, 9.0), (2, 2, 2)), SI_O, 3.0,
                 4, (1, 2, 2)),
    'brick212': (lambda: _both(_arrays(40, 2, 9.0), (2, 2, 2)), SI_O, 3.0,
                 4, (2, 1, 2)),
    'hfo2_222': (_hfo2_768, HF_O, 4.0, 8, None),
}


def _plans(case):
    from sevennet_finetuning_tpu.parallel.halo import build_halo_plan as jb
    from sevennet_finetuning_tpu_torch.parallel.halo import build_halo_plan

    make, tm, cutoff, n_dev, dims = CASES[case]
    s, js = make()
    return (s, js, build_halo_plan(s, cutoff, tm, n_dev, dims=dims),
            jb(js, cutoff, tm, n_dev, dims=dims))


def _same_plan(got, want):
    for f in dataclasses.fields(want):
        a, b = getattr(got, f.name), getattr(want, f.name)
        if f.name == 'stages':
            assert len(a) == len(b)
            for sa, sb in zip(a, b):
                _same_plan(sa, sb)
        elif isinstance(b, dict):
            assert set(a) == set(b)
            for k in b:
                assert a[k].dtype == b[k].dtype and np.array_equal(
                    a[k], b[k]), (f.name, k)
        elif isinstance(b, np.ndarray):
            assert a.dtype == b.dtype and np.array_equal(a, b), f.name
        else:
            assert a == b, f.name


@pytest.mark.parametrize('case', list(CASES))
def test_halo_plan_matches_jax(case):
    s, js, plan, jplan = _plans(case)
    _same_plan(plan, jplan)
    assert plan.buffer_rows == jplan.buffer_rows
    if case == 'hfo2_222':
        assert plan.dims == (2, 2, 2) and len(plan.stages) == 3


def test_halo_rejects_too_small_slabs():
    """A >2-way split narrower than the cutoff aborts, as in JAX
    (reference: comm_brick.cpp:1071); the messages are JAX's."""
    from sevennet_finetuning_tpu.parallel.halo import build_halo_plan as jb
    from sevennet_finetuning_tpu.parallel.halo import choose_dims as jcd
    from sevennet_finetuning_tpu_torch.parallel.halo import (build_halo_plan,
                                                             choose_dims)

    s, js = _both(_arrays(a=8.0))
    for args in ((3.5, SI_O, 8, (8, 1, 1)), (3.5, SI_O, 16, None)):
        with pytest.raises(ValueError) as got:
            build_halo_plan(s, *args[:3], dims=args[3])
        with pytest.raises(ValueError) as want:
            jb(js, *args[:3], dims=args[3])
        assert str(got.value) == str(want.value)
    assert choose_dims(s.cell, 3.5, 4) == jcd(js.cell, 3.5, 4)


def _port_model(cfg):
    from sevennet_finetuning_tpu_torch.model.build import build_model_spec
    from sevennet_finetuning_tpu_torch.model.nequip import (
        NequIP, init_params, load_jax_params)

    spec = build_model_spec(cfg)
    return load_jax_params(NequIP(spec), init_params(spec, 0))


def _serial(model, s):
    from sevennet_finetuning_tpu_torch.calculator import Calculator
    from sevennet_finetuning_tpu_torch.model.nequip import init_params

    calc = Calculator(model.spec, init_params(model.spec, 0), device='cpu')
    out = calc.calculate(s)
    return out['energy'], out['forces'], out['stress']


def _port_halo(model, plan, s):
    from sevennet_finetuning_tpu_torch.parallel.halo import (
        gather_forces, make_halo_forward, scatter_positions)

    fwd = make_halo_forward(model, plan)
    e, f, st = fwd(torch.as_tensor(
        scatter_positions(plan, s.pos.astype(np.float32))))
    return float(e), gather_forces(plan, f.numpy()), st.numpy()


def _jax_halo(cfg, jplan, js):
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    from sevennet_finetuning_tpu.model.build import build_model_spec
    from sevennet_finetuning_tpu.model.nequip import init_params
    from sevennet_finetuning_tpu.parallel.halo import (
        SP_AXIS, gather_forces, make_halo_forward, scatter_positions)

    with jax.enable_x64(False):
        spec = build_model_spec(cfg)
        mesh = Mesh(np.array(jax.devices()[:jplan.n_dev]), (SP_AXIS,))
        pj = jax.tree_util.tree_map(jnp.asarray, init_params(spec, 0))
        fwd = make_halo_forward(spec, pj, jplan, mesh)
        pos = jax.device_put(
            jnp.asarray(scatter_positions(jplan, js.pos.astype(np.float32))),
            NamedSharding(mesh, P(SP_AXIS)))
        e, f, st = fwd(pos)
        return float(e), gather_forces(jplan, f), np.asarray(st)


def _check(got, want, f_atol=1e-4):
    e, f, st = got
    e_w, f_w, st_w = want
    assert abs(e - e_w) < 1e-3 * max(1, abs(e_w))
    np.testing.assert_allclose(f, f_w, atol=f_atol)
    np.testing.assert_allclose(st, st_w, atol=1e-6)


@pytest.mark.parametrize('case', list(CASES))
def test_halo_forward_matches_serial_and_jax(case):
    s, js, plan, jplan = _plans(case)
    _, tm, cutoff, _, _ = CASES[case]
    cfg = _cfg(tm, cutoff)
    model = _port_model(cfg)
    got = _port_halo(model, plan, s)
    f_atol = 2e-4 if case == 'hfo2_222' else 1e-4
    _check(got, _serial(model, s), f_atol)
    # JAX's halo forward on the same plan (one 2-D brick: each case
    # compiles a shard_map program of its own)
    if case not in ('brick122', 'brick212'):
        _check(got, _jax_halo(cfg, jplan, js), f_atol)


# --- the other block families ------------------------------------------------

CUSTOM_CALLS = []


def _custom_block(t, irreps):
    """A node-local plugin block between two convolutions that records
    whether its ``ctx`` carried the halo exchange."""
    from sevennet_finetuning_tpu_torch.model.nequip import CustomBlockSpec
    from sevennet_finetuning_tpu_torch.ops.linear import (
        apply_linear, init_linear_weights, linear_spec)

    lin = linear_spec(irreps, irreps)

    def init(rng):
        return {f'w{i}': w
                for i, w in enumerate(init_linear_weights(lin, rng))}

    def apply(params, x, ctx):
        CUSTOM_CALLS.append(ctx['exchange_fn'] is not None)
        return x + 0.5 * apply_linear(
            lin, [params[f'w{i}'] for i in range(len(params))], x)

    return CustomBlockSpec(t=t, irreps_x=irreps, irreps_out=irreps,
                           init=init, apply=apply)


@pytest.mark.parametrize('family', ['mace', 'gaunt', 'gaunt_gate', 'custom'])
def test_halo_families_match_serial(family):
    from sevennet_finetuning_tpu_torch.model.nequip import (
        NequIP, init_params, load_jax_params)
    from sevennet_finetuning_tpu_torch.parallel.halo import build_halo_plan

    s, _ = _both(_arrays())
    itype = 'nequip' if family == 'custom' else family
    model = _port_model(_cfg(SI_O, 3.5, **{K.INTERACTION_TYPE: itype,
                                           K.NUM_CONVOLUTION: 2}))
    if family == 'custom':
        spec = model.spec
        b0, b1 = spec.blocks
        spec = dataclasses.replace(spec, blocks=(
            b0, _custom_block(2, b0.irreps_out), b1))
        model = load_jax_params(NequIP(spec), init_params(spec, 0))
        CUSTOM_CALLS.clear()
    plan = build_halo_plan(s, 3.5, SI_O, 2)
    _check(_port_halo(model, plan, s), _serial(model, s))
    if family == 'custom':
        assert CUSTOM_CALLS == [True, False]


def test_exchange_gradcheck_and_gradgradcheck():
    """The exchange's backward (the reverse swap, the owners' sorted
    adds) is the adjoint of its forward, and its own backward works
    (``create_graph``): gradcheck and gradgradcheck in float64 over a
    two-stage plan (dims (2, 2, 1)) held in one process."""
    from sevennet_finetuning_tpu_torch.parallel.halo import (
        HaloExchange, LocalTransport, build_halo_plan)

    s, _ = _both(_arrays(40, 2, 9.0), (2, 2, 1))
    plan = build_halo_plan(s, 3.0, SI_O, 4, dims=(2, 2, 1))
    assert len(plan.stages) == 2
    exchange = HaloExchange(plan, LocalTransport(plan), 'cpu')
    rng = np.random.default_rng(0)
    x = torch.tensor(rng.standard_normal((4 * plan.n_local, 1)),
                     requires_grad=True)
    w = torch.tensor(rng.standard_normal((4 * plan.buffer_rows, 1)))

    def f(v):
        return (exchange(v) * w).sin()

    assert exchange(x).shape == (4 * plan.buffer_rows, 1)
    assert torch.autograd.gradcheck(f, (x,), fast_mode=True)
    assert torch.autograd.gradgradcheck(f, (x,), fast_mode=True)
