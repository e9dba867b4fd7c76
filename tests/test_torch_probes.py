"""The measurement probes of ``sevennet_finetuning_tpu_torch.tools`` against
the TPU tools' own Pallas kernels.

``tools/bench_dma.py`` and ``tools/test_mosaic_feats.py`` define their
kernels as closures inside ``main()``, so the kernel bodies below are
copied from them verbatim (only ``interpret=True`` is added) and run in
interpret mode on the CPU.  Each plain PyTorch version of the port is held
against them on the same numpy-seeded inputs: the copies, transpose,
split and window bit for bit, the column sum within 2e-6 x the column's
sum of |x|, the product within 2e-6 x max|plain| of the interpret-mode
result and 1e-4 of float64.  The CUDA kernels themselves run only on the
card (``chip_smoke.py``, ``python -m
sevennet_finetuning_tpu_torch.tools.{bench_dma,hopper_feats}``).
"""

import importlib.util
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from sevennet_finetuning_tpu_torch.ops import _cuda
from sevennet_finetuning_tpu_torch.tools import bench_dma, hopper_feats

ROOT = Path(__file__).resolve().parents[1]
# the bench's kernels at a small slab; the feature probes at their own
# shapes
E, D = 1024, 256
C = 1.0000001
KERNEL_TOL = 2e-6


def _rng(seed):
    return np.random.default_rng(seed)


# ---- tools/bench_dma.py, main(): bs_copy, bs_read, manual_copy ----

def bs_copy(te, arr, fm=False):
    shape = arr.shape
    if fm:
        grid = (shape[1] // te,)
        spec = pl.BlockSpec((shape[0], te), lambda i: (0, i),
                            memory_space=pltpu.VMEM)
    else:
        grid = (shape[0] // te,)
        spec = pl.BlockSpec((te, shape[1]), lambda i: (i, 0),
                            memory_space=pltpu.VMEM)

    def kern(i_ref, o_ref):
        o_ref[:] = i_ref[:] * C

    call = pl.pallas_call(
        kern,
        grid_spec=pl.GridSpec(grid=grid, in_specs=[spec],
                              out_specs=spec),
        out_shape=jax.ShapeDtypeStruct(shape, jnp.float32),
        interpret=True,
    )
    return call


def bs_read(te):
    grid = (E // te,)

    def kern(i_ref, o_ref):
        @pl.when(pl.program_id(0) == 0)
        def _():
            o_ref[:] = jnp.zeros_like(o_ref)
        o_ref[:] += jnp.sum(i_ref[:], axis=0, keepdims=True)

    call = pl.pallas_call(
        kern,
        grid_spec=pl.GridSpec(
            grid=grid,
            in_specs=[pl.BlockSpec((te, D), lambda i: (i, 0),
                                   memory_space=pltpu.VMEM)],
            out_specs=pl.BlockSpec((1, D), lambda i: (0, 0),
                                   memory_space=pltpu.VMEM),
        ),
        out_shape=jax.ShapeDtypeStruct((1, D), jnp.float32),
        interpret=True,
    )
    return call


def manual_copy(te, S, split=1):
    T = E // te
    csz = D // split

    def kern(x_hbm, y_hbm, ibuf, obuf, lsem, ssem):
        def load(t):
            return [pltpu.make_async_copy(
                x_hbm.at[t, :, s * csz:(s + 1) * csz],
                ibuf.at[t % S, :, s * csz:(s + 1) * csz],
                lsem.at[t % S, s]) for s in range(split)]

        def store(t):
            return [pltpu.make_async_copy(
                obuf.at[t % S, :, s * csz:(s + 1) * csz],
                y_hbm.at[t, :, s * csz:(s + 1) * csz],
                ssem.at[t % S, s]) for s in range(split)]

        for t in range(min(S, T)):
            for cp in load(t):
                cp.start()
        for t in range(T):
            for cp in load(t):
                cp.wait()
            if t >= S:
                for cp in store(t - S):
                    cp.wait()
            obuf[t % S] = ibuf[t % S] * C
            for cp in store(t):
                cp.start()
            if t + S < T:
                for cp in load(t + S):
                    cp.start()
        for t in range(max(T - S, 0), T):
            for cp in store(t):
                cp.wait()

    call = pl.pallas_call(
        kern,
        grid_spec=pltpu.PrefetchScalarGridSpec(
            num_scalar_prefetch=0,
            grid=(1,),
            in_specs=[pl.BlockSpec(memory_space=pl.ANY)],
            out_specs=pl.BlockSpec(memory_space=pl.ANY),
            scratch_shapes=[
            pltpu.VMEM((S, te, D), jnp.float32),
            pltpu.VMEM((S, te, D), jnp.float32),
            pltpu.SemaphoreType.DMA((S, split)),
            pltpu.SemaphoreType.DMA((S, split)),
        ]),
        out_shape=jax.ShapeDtypeStruct((T, te, D), jnp.float32),
        compiler_params=pltpu.CompilerParams(has_side_effects=True),
        interpret=True,
    )

    def step(c):
        return call(c.reshape(T, te, D)).reshape(E, D)

    return step


# ---- tools/test_mosaic_feats.py, main(): the four kernels ----

def t_transpose(x):
    def kern(i_ref, o_ref):
        o_ref[:] = i_ref[:].T

    out = pl.pallas_call(
        kern,
        out_shape=jax.ShapeDtypeStruct((512, 256), jnp.float32),
        in_specs=[pl.BlockSpec(memory_space=pltpu.VMEM)],
        out_specs=pl.BlockSpec(memory_space=pltpu.VMEM),
        interpret=True,
    )(x)
    return out


def t_split(v):
    def kern(i_ref, o_ref):
        x = i_ref[:]
        xi = pltpu.bitcast(x, jnp.uint32)
        hi = pltpu.bitcast(xi & jnp.uint32(0xFFFF0000), jnp.float32)
        r1 = x - hi
        r1i = pltpu.bitcast(r1, jnp.uint32)
        mid = pltpu.bitcast(r1i & jnp.uint32(0xFFFF0000),
                            jnp.float32)
        lo = r1 - mid
        h = hi.astype(jnp.bfloat16).astype(jnp.float32)
        m = mid.astype(jnp.bfloat16).astype(jnp.float32)
        l_ = lo.astype(jnp.bfloat16).astype(jnp.float32)
        o_ref[:] = h + m + l_

    out = pl.pallas_call(
        kern,
        out_shape=jax.ShapeDtypeStruct((128, 256), jnp.float32),
        in_specs=[pl.BlockSpec(memory_space=pltpu.VMEM)],
        out_specs=pl.BlockSpec(memory_space=pltpu.VMEM),
        interpret=True,
    )(v)
    return out


def t_dotgen(a, b):
    def kern(a_ref, b_ref, o_ref):
        o_ref[:] = jax.lax.dot_general(
            a_ref[:], b_ref[:],
            dimension_numbers=(((0,), (0,)), ((), ())),
            preferred_element_type=jnp.float32,
            precision=jax.lax.Precision.HIGHEST,
        )

    out = pl.pallas_call(
        kern,
        out_shape=jax.ShapeDtypeStruct((384, 256), jnp.float32),
        in_specs=[pl.BlockSpec(memory_space=pltpu.VMEM)] * 2,
        out_specs=pl.BlockSpec(memory_space=pltpu.VMEM),
        interpret=True,
    )(a, b)
    return out


def t_winDMA(y, sel):
    NB, WB, D = 12, 64, 384

    def kern(sel_ref, y_hbm, o_ref, buf, sem):
        s = sel_ref[0]
        for nb in range(NB):
            @pl.when(nb == s)
            def _(nb=nb):
                cp = pltpu.make_async_copy(
                    y_hbm.at[nb * WB:(nb + 1) * WB, :], buf, sem)
                cp.start()
                cp.wait()
        o_ref[:] = buf[:]

    out = pl.pallas_call(
        kern,
        grid_spec=pltpu.PrefetchScalarGridSpec(
            num_scalar_prefetch=1,
            grid=(1,),
            in_specs=[pl.BlockSpec(memory_space=pl.ANY)],
            out_specs=pl.BlockSpec(memory_space=pltpu.VMEM),
            scratch_shapes=[
                pltpu.VMEM((WB, D), jnp.float32),
                pltpu.SemaphoreType.DMA(()),
            ],
        ),
        out_shape=jax.ShapeDtypeStruct((WB, D), jnp.float32),
        compiler_params=pltpu.CompilerParams(has_side_effects=True),
        interpret=True,
    )(sel, y)
    return out


# ---- row 8: the copy-bandwidth probe ----

@pytest.fixture(scope='module')
def slab():
    return _rng(0).standard_normal((E, D)).astype(np.float32)


@pytest.mark.parametrize('te,fm', [(128, False), (256, False), (256, True)])
def test_copy_tiled_plain_matches_pallas(slab, te, fm):
    arr = slab.T.copy() if fm else slab
    want = np.asarray(bs_copy(te, arr, fm)(jnp.asarray(arr)))
    got = bench_dma.copy_tiled(torch.as_tensor(arr), te, fm).numpy()
    assert np.array_equal(got, want)


@pytest.mark.parametrize('te', [256, 512])
def test_colsum_plain_matches_pallas(slab, te):
    want = np.asarray(bs_read(te)(jnp.asarray(slab)))
    got = bench_dma.colsum(torch.as_tensor(slab), te).numpy()
    assert got.shape == want.shape == (1, D)
    scale = np.abs(slab.astype(np.float64)).sum(0, keepdims=True)
    ref = slab.astype(np.float64).sum(0, keepdims=True)
    assert (np.abs(got - want) <= KERNEL_TOL * scale).all()
    assert (np.abs(got - ref) <= KERNEL_TOL * scale).all()


@pytest.mark.parametrize('rows', [E, 1000, 7])
def test_colsum_stripes_cover_every_row_once(rows):
    """probe_colsum's first pass: every band of 32 float4 columns takes
    the slabs' warp stripes; each (row, float4 column) is summed once, at
    the TPU shape's rows and at row counts that are not a multiple of
    the slab."""
    slab_rows = bench_dma.COLSUM_SLAB_ROWS
    cols4 = D // 4
    n_band = -(-cols4 // 32)
    count = np.zeros((rows, n_band * 32), np.int64)
    stripes = bench_dma.colsum_stripes(rows)
    assert len(stripes) == -(-rows // slab_rows) * bench_dma.COLSUM_WARPS
    for band in range(n_band):
        for k, _, r0, r1 in stripes:
            assert k * slab_rows <= r0 <= r1 <= min(rows,
                                                    (k + 1) * slab_rows)
            count[r0:r1, band * 32:(band + 1) * 32] += 1
    assert (count[:, :cols4] == 1).all()


@pytest.mark.parametrize('rows', [E, 1000])
def test_colsum_stripe_order_within_tolerance(slab, rows):
    """The kernel's float32 order (each stripe row by row, the warps in
    order, then the slabs in order) within 2e-6 x sum|x| of float64 and
    of the plain version."""
    x = slab[:rows]
    part = {}
    for k, w, r0, r1 in bench_dma.colsum_stripes(rows):
        acc = np.zeros(D, np.float32)
        for r in range(r0, r1):
            acc = acc + x[r]
        part[k] = acc if w == 0 else part[k] + acc
    got = np.zeros(D, np.float32)
    for k in sorted(part):
        got = got + part[k]
    scale = np.abs(x.astype(np.float64)).sum(0)
    assert (np.abs(got - x.astype(np.float64).sum(0)) <= KERNEL_TOL
            * scale).all()
    want = bench_dma.colsum_plain(torch.as_tensor(x), 8).numpy()[0]
    assert (np.abs(got - want) <= KERNEL_TOL * scale).all()


@pytest.mark.parametrize('te,S,split', [(256, 2, 1), (256, 4, 2)])
def test_copy_ring_plain_matches_pallas(slab, te, S, split):
    want = np.asarray(manual_copy(te, S, split)(jnp.asarray(slab)))
    # the card's ring takes tiles of a few rows (227 KB of shared
    # memory); the function is the same
    got = bench_dma.copy_ring(torch.as_tensor(slab), 16, S, split)
    assert np.array_equal(got.numpy(), want)


def test_ring_planner_fits_the_card():
    variants = bench_dma.ring_variants()
    assert len(variants) >= 8
    assert any(split > 1 for _, _, split in variants)
    for rows, slots, split in variants:
        assert bench_dma.ring_smem_bytes(rows, slots) <= 232448
        assert (bench_dma.D // split * 4) % 16 == 0
        assert bench_dma.D % split == 0
        assert bench_dma.E % rows == 0
        assert 2 <= slots <= bench_dma.RING_MAX_SLOTS
    # the TPU's own tiles do not fit a block's shared memory
    assert not bench_dma.ring_fits(256, 2, 1)
    assert not bench_dma.ring_fits(32, 3, 1)
    assert not bench_dma.ring_fits(16, 1, 1)       # a ring needs two slots
    assert not bench_dma.ring_fits(100, 2, 1)      # 100 does not divide E


def test_ring_planner_rejects_unaligned_copies():
    # 764 columns in 2 copies: 1528 bytes each, not a multiple of 16
    assert not bench_dma.ring_fits(8, 2, 2, n_rows=64, cols=764)
    assert bench_dma.ring_fits(8, 2, 1, n_rows=64, cols=764)


# ---- row 9: the Hopper feature probes ----

@pytest.fixture(scope='module')
def probe_inputs():
    return hopper_feats.probe_inputs()


def test_probe_inputs_have_the_tpu_shapes(probe_inputs):
    shapes = {k: v.shape for k, v in probe_inputs.items()}
    assert shapes == {'x': (256, 512), 'v': (128, 256), 'a': (64, 384),
                      'b': (64, 256), 'y': (768, 384), 'sel': (1,)}
    assert all(v.dtype == np.float32 for k, v in probe_inputs.items()
               if k != 'sel')
    assert int(probe_inputs['sel'][0]) == 5


def test_transpose_plain_matches_pallas(probe_inputs):
    x = probe_inputs['x']
    want = np.asarray(t_transpose(jnp.asarray(x)))
    got = hopper_feats.transpose(torch.as_tensor(x)).numpy()
    assert np.array_equal(got, want) and np.array_equal(got, x.T)


def test_split_plain_matches_pallas(probe_inputs):
    v = probe_inputs['v']
    want = np.asarray(t_split(jnp.asarray(v)))
    parts, recon = hopper_feats.split3(torch.as_tensor(v))
    assert np.array_equal(recon.numpy(), want)
    assert np.array_equal(recon.numpy(), v)
    assert parts.dtype == torch.bfloat16 and parts.shape == (3, 128, 256)


def test_split_parts_are_exact_bf16_pieces():
    v = np.array([0.0, -0.0, 1.0, np.pi, -1e30, 1e-30, 3.0e38, -7.25e-3,
                  65504.0, 1.0000001], np.float32)
    parts, recon = hopper_feats.split_plain(torch.as_tensor(v))
    p = parts.float().numpy()
    assert np.array_equal(recon.numpy(), v)
    # hi holds the top 16 bits of x; each part is smaller than the last
    assert np.array_equal(p[0].view(np.uint32),
                          v.view(np.uint32) & np.uint32(0xFFFF0000))
    nz = v != 0
    assert (np.abs(p[1][nz]) < np.abs(p[0][nz])).all()
    assert (np.abs(p[2][nz]) <= np.abs(p[1][nz])).all()
    assert np.array_equal(((p[0] + p[1]) + p[2]).astype(np.float32), v)


def test_dot_plain_matches_pallas(probe_inputs):
    a, b = probe_inputs['a'], probe_inputs['b']
    want = np.asarray(t_dotgen(jnp.asarray(a), jnp.asarray(b)))
    got = hopper_feats.dot_lane_contract(torch.as_tensor(a),
                                         torch.as_tensor(b)).numpy()
    assert got.shape == want.shape == (384, 256)
    assert np.abs(got - want).max() <= KERNEL_TOL * np.abs(got).max()
    ref = a.astype(np.float64).T @ b.astype(np.float64)
    assert np.allclose(got, ref, atol=1e-4)
    err, ratio = hopper_feats.dot_error(torch.as_tensor(got), a, b)
    assert err <= 1e-4 and ratio <= KERNEL_TOL


def test_dot_plain_is_six_split_products():
    # the six products recover a^T b to float32 rounding; the three left
    # out (ml, lm, ll) are below 2^-32 of each product
    rng = _rng(3)
    a = rng.standard_normal((16, 64)).astype(np.float32)
    b = rng.standard_normal((16, 64)).astype(np.float32)
    got = hopper_feats.dot_plain(torch.as_tensor(a), torch.as_tensor(b))
    ref = a.astype(np.float64).T @ b.astype(np.float64)
    scale = np.abs(a.astype(np.float64)).T @ np.abs(b.astype(np.float64))
    assert (np.abs(got.numpy() - ref) <= 1e-6 * scale).all()
    assert len(hopper_feats.PRODUCTS) == 6
    assert len(set(hopper_feats.PRODUCTS)) == 6
    assert all(i + j <= 2 for i, j in hopper_feats.PRODUCTS)


@pytest.mark.parametrize('sel', [5, 0, 11])
def test_window_plain_matches_pallas(probe_inputs, sel):
    y = probe_inputs['y']
    s = np.array([sel], np.int32)
    want = np.asarray(t_winDMA(jnp.asarray(y), jnp.asarray(s)))
    got = hopper_feats.window(torch.as_tensor(y), torch.as_tensor(s))
    assert np.array_equal(got.numpy(), want)


def test_window_out_of_range_gives_zeros(probe_inputs):
    y = torch.as_tensor(probe_inputs['y'])
    got = hopper_feats.window_plain(y, torch.tensor([12], dtype=torch.int32))
    assert got.shape == (64, 384) and not bool(got.any())


# ---- entry points, wrappers and the kernel table ----

@pytest.mark.parametrize('module', [bench_dma, hopper_feats])
def test_main_needs_a_card(module, monkeypatch):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='CUDA'):
        module.main()


CUDA_CALLS = {
    'probe_copy_tiled': lambda x: bench_dma.copy_tiled_cuda(x, 8),
    'probe_colsum': lambda x: bench_dma.colsum_cuda(x, 8),
    'probe_copy_ring': lambda x: bench_dma.copy_ring_cuda(x, 8, 2),
    'probe_transpose': hopper_feats.transpose_cuda,
    'probe_split': hopper_feats.split_cuda,
    'probe_dot': lambda x: hopper_feats.dot_cuda(x, x),
    'probe_window': lambda x: hopper_feats.window_cuda(
        x, torch.zeros(1, dtype=torch.int32)),
}


@pytest.mark.parametrize('name', sorted(CUDA_CALLS))
def test_cuda_wrappers_refuse_cpu_tensors(name):
    before = dict(_cuda.LAUNCHES)
    with pytest.raises(ValueError, match='CUDA'):
        CUDA_CALLS[name](torch.zeros(64, 64))
    assert dict(_cuda.LAUNCHES) == before


def test_dispatch_runs_plain_versions_on_cpu(probe_inputs):
    before = dict(_cuda.LAUNCHES)
    x = torch.as_tensor(_rng(1).standard_normal((64, 128)), dtype=torch.float32)
    assert torch.equal(bench_dma.copy_tiled(x, 8), x * C)
    assert torch.equal(bench_dma.copy_ring(x, 8, 2), x * C)
    assert torch.allclose(bench_dma.colsum(x, 8), x.sum(0, keepdim=True),
                          atol=1e-5)
    a = torch.as_tensor(probe_inputs['a'])
    assert torch.equal(hopper_feats.dot_lane_contract(a, a),
                       hopper_feats.dot_plain(a, a))
    assert dict(_cuda.LAUNCHES) == before


def test_every_entry_point_matches_its_c_signature():
    for name in _cuda.KERNELS:
        fn_name, argtypes = _cuda.SIGNATURES[name]
        src = (_cuda.CSRC / f'{_cuda.SOURCE_OF[name]}.cu').read_text()
        m = re.search(r'extern "C" int ' + fn_name + r'\((.*?)\)', src, re.S)
        assert m, (name, fn_name)
        params = [p.strip() for p in m.group(1).split(',')]
        assert len(params) == len(argtypes), (name, params)
        for p, t in zip(params, argtypes):
            kind = ('ptr' if '*' in p else 'float' if p.startswith('float')
                    else 'int')
            want = {'ptr': _cuda._P, 'float': _cuda._F, 'int': _cuda._I}[kind]
            assert t is want, (name, p, t)
    assert set(_cuda.SOURCE_OF.values()) == set(_cuda.SOURCES)


def _chip_smoke():
    spec = importlib.util.spec_from_file_location('chip_smoke',
                                                  ROOT / 'chip_smoke.py')
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_chip_smoke_tables_name_every_kernel():
    cs = _chip_smoke()
    assert set(cs.SOURCES) == set(_cuda.KERNELS)
    assert set(cs.TRAIN_CENSUS) == set(cs.UNSORTED_CENSUS) == set(
        _cuda.KERNELS)
    assert set(cs.PATH_KERNELS['probes']) == {
        k for k in _cuda.KERNELS if k.startswith('probe_')}
    assert all(cs.KERNEL_PATH[k] == 'probes'
               for k in cs.PATH_KERNELS['probes'])
    for name, info in cs.SOURCES.items():
        assert (ROOT / info['source']).is_file(), name
        path, line = info['replaces'].split(':')
        text = (ROOT / path).read_text().splitlines()[int(line) - 1]
        assert 'pl.pallas_call(' in text, (name, info['replaces'], text)
