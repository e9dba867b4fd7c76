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
from sevennet_finetuning_tpu_torch.tools import (bench_dma, feats_time,
                                              hopper_feats)

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


@pytest.mark.parametrize('te,fm', [(128, False), (256, False), (512, False),
                                   (1024, False), (256, True), (512, True)])
def test_copy_tiled_plain_matches_pallas(slab, te, fm):
    arr = slab.T.copy() if fm else slab
    want = np.asarray(bs_copy(te, arr, fm)(jnp.asarray(arr)))
    got = bench_dma.copy_tiled(torch.as_tensor(arr), te, fm).numpy()
    assert np.array_equal(got, want)


TILED_SHAPES = ([(bench_dma.E, bench_dma.D, te, False)
                 for te in bench_dma.EM_TILES]
                + [(bench_dma.D, bench_dma.E, te, True)
                   for te in bench_dma.FM_TILES]
                # rows or tiles that are not a multiple of a chunk
                + [(1000, 2048, 256, True), (48, 764, 8, False),
                   (96, 1200, 16, False),
                   # rows of 7, 255, 257, 300 and 512 float4s: a thread's
                   # step of COPY_THREADS float4s wraps the row in every
                   # way (several rows, none, one and a part)
                   (24, 56, 28, True), (30, 1020, 10, False),
                   (64, 1028, 16, False), (40, 2400, 1200, True),
                   (12, 2048, 4, False)])


@pytest.mark.parametrize('rows,cols,te,fm', TILED_SHAPES)
def test_tiled_chunks_cover_every_element_once(rows, cols, te, fm):
    """probe_copy_tiled's chunks (``tiled_chunks``): chunks of at most
    COPY_THREADS x COPY_DEPTH float4s numbered tile by tile (the TPU's
    tile order), chunk q on block q % grid; each thread walks its chunk
    as copy_tiled_kernel does (from j0, COPY_THREADS float4s on as step_r
    rows and step_c float4s, wrapping the column), lands where the
    tile's row-major order puts j, and every float4 of the slab is
    copied once; at the TPU sweep's tiles and at shapes whose tiles are
    not a multiple of a chunk."""
    grid = 1056
    threads, depth = bench_dma.COPY_THREADS, bench_dma.COPY_DEPTH
    chunk = threads * depth
    chunks = bench_dma.tiled_chunks(rows, cols, te, fm, grid)
    for q, (block, tile, j0, j1) in enumerate(chunks):
        assert block == q % grid and 0 < j1 - j0 <= chunk
        assert q == 0 or (tile, j0) > chunks[q - 1][1:3]
        assert j0 % chunk == 0
    _, width4, stride4, n = bench_dma.tiled_region(rows, cols, te, fm, 0)
    base = np.array([bench_dma.tiled_region(rows, cols, te, fm, t)[0]
                     for _, t, _, _ in chunks])[:, None]
    assert max(j1 for *_, j1 in chunks) == n
    # the kernel's walk: every thread of every chunk at once
    step_r, step_c = threads // width4, threads % width4
    j0 = np.array([c[2] for c in chunks])[:, None] + np.arange(threads)
    r, col = j0 // width4, j0 % width4
    at = []
    for d in range(depth):
        j = j0 + d * threads
        live = j < n
        assert np.array_equal((r * stride4 + col)[live],
                              (j // width4 * stride4 + j % width4)[live])
        at.append((base + r * stride4 + col)[live])
        r, col = r + step_r, col + step_c
        wrap = col >= width4
        r, col = r + wrap, col - wrap * width4
    count = np.bincount(np.concatenate(at), minlength=rows * cols // 4)
    assert count.shape == (rows * cols // 4,) and (count == 1).all()


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
    # the card's two rings take tiles of a few rows (227 KB of shared
    # memory); the function is the same
    rows = 16 if S == 2 else 8
    assert bench_dma.ring_fits(rows, S, split, E, D)
    got = bench_dma.copy_ring(torch.as_tensor(slab), rows, S, split)
    assert np.array_equal(got.numpy(), want)


def test_ring_planner_fits_the_card():
    variants = bench_dma.ring_variants()
    assert len(variants) >= 8
    assert any(split > 1 for _, _, split in variants)
    # the TPU sweep's split shapes, at the shared memory of the one-ring
    # design's table cases (16, 4, 2) and (32, 2, 1)
    assert {(8, 4, 2), (8, 4, 4), (16, 2, 1)} <= set(variants)
    for rows, slots, split in variants:
        # a header of three mbarriers a slot, then two rings of slots
        assert bench_dma.ring_smem_bytes(rows, slots) == (
            24 * bench_dma.RING_MAX_SLOTS + 2 * slots * rows * bench_dma.D
            * 4) <= 232448
        piece = bench_dma.D // split
        w = bench_dma.ring_box(bench_dma.D, split)
        assert piece % w == 0 and piece // w <= 256 and w * 4 % 16 == 0
        assert rows * piece * 4 % 128 == 0 and split <= 32
        assert bench_dma.E % rows == 0
        assert 2 <= slots <= bench_dma.RING_MAX_SLOTS
    # the TPU's own tiles do not fit a block's shared memory, nor do the
    # one-ring design's tiles now that there are two rings
    assert not bench_dma.ring_fits(256, 2, 1)
    assert not bench_dma.ring_fits(32, 2, 1)
    assert not bench_dma.ring_fits(16, 4, 2)
    assert not bench_dma.ring_fits(16, 1, 1)       # a ring needs two slots
    assert not bench_dma.ring_fits(100, 2, 1)      # 100 does not divide E


def test_ring_planner_rejects_unaligned_copies():
    # 764 columns in 2 copies: 1528 bytes each, not a multiple of 16
    assert not bench_dma.ring_fits(8, 2, 2, n_rows=64, cols=764)
    assert bench_dma.ring_fits(8, 2, 1, n_rows=64, cols=764)
    assert bench_dma.ring_box(764, 1) == 4      # 191 boxes of 16 bytes
    # a copy's rows x piece not a multiple of 128 bytes in shared memory
    assert not bench_dma.ring_fits(1, 2, 1, n_rows=64, cols=764)
    # a copy wider than 256 x 64 floats has no box
    assert bench_dma.ring_box(20480, 1) == 0
    assert not bench_dma.ring_fits(1, 2, 1, n_rows=64, cols=20480)
    assert not bench_dma.ring_fits(8, 2, 64, n_rows=64, cols=4096)


def _source_constants():
    src = (_cuda.CSRC / 'probe_copy.cu').read_text()
    out = {k: int(v) for k, v in re.findall(
        r'constexpr int (\w+) = (\d+);', src)}
    return src, out


def test_probe_copy_layout_matches_source():
    """The host mirrors (chunks, ring planner, the ring's protocol model)
    use the source's constants: the tiled copy's threads and depth, the
    ring's slot limit, header (three mbarriers a slot) and shared memory,
    the box widths, the storing warp's wait for its store's read before
    the slot's next tile, tile k + slots."""
    src, k = _source_constants()
    assert k['COPY_THREADS'] == bench_dma.COPY_THREADS
    assert k['COPY_DEPTH'] == bench_dma.COPY_DEPTH
    assert k['RING_MAX_SLOTS'] == bench_dma.RING_MAX_SLOTS
    assert k['SMEM_MAX'] == bench_dma.SMEM_BYTES
    assert 'constexpr int RING_HEADER = 3 * 8 * RING_MAX_SLOTS;' in src
    assert bench_dma.RING_HEADER == 3 * 8 * bench_dma.RING_MAX_SLOTS
    assert 'for (int w = 64; w >= 4; w /= 2)' in src
    assert 'piece / w <= 256' in src
    assert 'cp.async.bulk.wait_group.read 0;' in src
    assert 'if (lane == 0) mbar_arrive(&vacant[k % slots]);' in src


def _ring_run(n_local, slots, p_load, p_read, rng):
    """A random interleaving of copy_ring_kernel's warps over one block's
    n_local tiles: the loading warp, the storing warp, the consumers,
    and the copy engine landing loads (chance p_load a turn)
    and finishing stores' reads (p_read) at random later times.  Each
    wait is an mbarrier parity wait: it must find the barrier at most one
    phase past the one it waits for, or the card would wait forever.
    Returns the order of stored tiles."""
    full = [0] * slots      # completed phases of each mbarrier
    done = [0] * slots
    vacant = [0] * slots
    inp = [None] * slots    # the tile each input / output slot holds
    out = [None] * slots
    loads, stores = [], []  # in flight: (tile, slot); stores in order
    read = []               # tiles whose stores have read their slot
    stored = []

    def passes(bar, slot, phase):
        assert bar[slot] <= phase + 1, 'a barrier ran two phases ahead'
        return bar[slot] == phase + 1

    def loader():
        for k in range(min(slots, n_local)):
            loads.append((k, k % slots))
        for k in range(n_local - slots):
            while not passes(done, k % slots, k // slots):
                yield
            # the consumers are done with input slot k % slots
            loads.append((k + slots, k % slots))
            yield

    def storer():
        for k in range(n_local):
            while not passes(done, k % slots, k // slots):
                yield
            assert out[k % slots] == k
            stores.append((k, k % slots))
            stored.append(k)
            if k + slots < n_local:
                # wait_group.read 0: the store just issued has read the
                # slot that tile k + slots takes next
                while stores:
                    yield
                assert k in read
                vacant[k % slots] += 1
            yield

    def consumers():
        for k in range(n_local):
            slot, lap = k % slots, k // slots
            if lap > 0:
                while not passes(vacant, slot, lap - 1):
                    yield
            while not passes(full, slot, lap):
                yield
            assert inp[slot] == k
            # the store of tile k - slots has read the output slot
            assert lap == 0 or k - slots in read
            out[slot] = k
            done[slot] += 1
            yield

    def engine():
        while True:
            if loads and rng.random() < p_load:
                t, slot = loads.pop(0)
                inp[slot] = t
                full[slot] += 1
            if stores and rng.random() < p_read:
                read.append(stores.pop(0)[0])
            yield

    agents = [loader(), storer(), consumers()]
    eng = engine()
    for _ in range(100000):
        if not agents:
            break
        a = agents[rng.integers(len(agents))]
        try:
            next(a)
        except StopIteration:
            agents.remove(a)
        next(eng)
    assert not agents, 'the ring did not finish: a deadlock'
    return stored


@pytest.mark.parametrize('slots', [2, 3, 4])
@pytest.mark.parametrize('p_load,p_read', [(0.5, 0.5), (0.1, 0.9),
                                           (0.9, 0.1)])
def test_ring_protocol_runs_every_tile_once(slots, p_load, p_read):
    """The ring's mbarrier protocol (full / done / vacant, the storing
    warp's wait_group.read 0 before freeing tile k + slots's slot): no slot
    rewritten before it is read, no barrier two phases ahead, every tile
    stored once in order, in many random interleavings and tile counts,
    with loads or stores' reads the slow side or neither."""
    rng = _rng(slots * 100 + int(p_load * 10))
    for n_local in (1, slots - 1, slots, slots + 1, 3 * slots + 2, 11):
        for _ in range(20):
            if n_local > 0:
                assert _ring_run(n_local, slots, p_load, p_read,
                                 rng) == list(range(n_local))


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


def _feats_constants():
    src = (_cuda.CSRC / 'probe_feats.cu').read_text()
    return src, {k: int(v) for k, v in re.findall(
        r'constexpr int (\w+) = (\d+);', src)}


def test_probe_feats_layout_matches_source():
    """The wrappers' tile and piece limits are the kernels' own."""
    src, k = _feats_constants()
    assert (k['DOT_M'], k['DOT_N']) == (hopper_feats.DOT_M,
                                        hopper_feats.DOT_N)
    assert 'wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16' in src
    assert 'constexpr int WINDOW_MAX_PIECE = 49152 - WINDOW_HEADER;' in src
    assert hopper_feats.WINDOW_MAX_PIECE == 49152 - k['WINDOW_HEADER']
    assert (k['TRANSPOSE_SUB'], k['TRANSPOSE_BLOCK_ROWS']) == (
        hopper_feats.TRANSPOSE_SUB, hopper_feats.TRANSPOSE_BLOCK_ROWS)
    assert hopper_feats.TRANSPOSE_MAX_ROWS == (k['TRANSPOSE_MAX_GRID_Y']
                                               * k['TRANSPOSE_BLOCK_ROWS'])
    assert hopper_feats.SPLIT_MAX_N == k['SPLIT_MAX_N']


def test_window_plan_covers_the_window_once(probe_inputs):
    """The wrapper's own plan for the probe's window: 48 pieces of 2 KB,
    one wave of the 132 SMs, each a 16-byte multiple that fits a block's
    shared memory, together the window once."""
    y = probe_inputs['y']
    win = y.size // hopper_feats.N_WINDOWS
    n_pieces, piece = hopper_feats.window_plan(win)
    assert piece * 4 % 16 == 0 and piece * 4 <= hopper_feats.WINDOW_MAX_PIECE
    assert (n_pieces - 1) * piece < win <= n_pieces * piece
    assert (n_pieces, piece * 4) == (48, hopper_feats.WINDOW_PIECE_BYTES)


@pytest.mark.parametrize('win,plan', [
    (12, (1, 12)),              # shorter than a piece: one piece
    (512, (1, 512)),            # one whole piece
    (516, (2, 512)),            # the last piece shorter
])
def test_window_plan_takes_a_short_window(win, plan):
    assert hopper_feats.window_plan(win) == plan


@pytest.mark.parametrize('win', [6, 0, -4])
def test_window_plan_refuses_a_window_off_16_bytes(win):
    with pytest.raises(ValueError, match='window'):
        hopper_feats.window_plan(win)


@pytest.fixture
def cpu_stands_for_card(monkeypatch):
    """The wrappers' checks with CPU tensors standing for CUDA ones (all
    but the device check), and any launch an error."""
    real = _cuda.require

    def require(t, name, dtype, shape=None):
        real(_OnCard(t), name, dtype, shape)

    def launch(name):
        raise AssertionError(f'{name} was launched')

    monkeypatch.setattr(_cuda, 'require', require)
    monkeypatch.setattr(_cuda, 'kernel', launch)
    before = dict(_cuda.LAUNCHES)
    yield
    assert dict(_cuda.LAUNCHES) == before


class _OnCard:
    """A CPU tensor that answers the device check as a CUDA one."""
    is_cuda = True

    def __init__(self, t):
        self._t = t

    def __getattr__(self, name):
        return getattr(self._t, name)


def _offset(shape):
    """A contiguous float32 tensor 4 bytes past a 16-byte boundary."""
    n = int(np.prod(shape))
    return torch.zeros(n + 1)[1:].view(shape)


@pytest.mark.parametrize('a_shape,b_shape', [
    ((64, 384), (32, 256)),     # W differs
    ((24, 64), (24, 32)),       # W not a multiple of 16
    ((80, 64), (80, 32)),       # W over a tile
    ((64, 96), (64, 32)),       # C not a multiple of 64
    ((64, 64), (64, 24)),       # TE not a multiple of 16
    ((64, 64), (64, 8)),        # TE under a tile
    ((64, 0), (64, 32)),        # empty
    ((64,), (64, 32)),          # not a matrix
    ('offset', (64, 32)),       # a not 16-byte aligned
])
def test_dot_cuda_refuses_shapes_before_launch(cpu_stands_for_card, a_shape,
                                               b_shape):
    a = _offset((64, 64)) if a_shape == 'offset' else torch.zeros(a_shape)
    with pytest.raises(ValueError, match='dot'):
        hopper_feats.dot_cuda(a, torch.zeros(b_shape))


@pytest.mark.parametrize('y', [
    (64, 384),                  # 12 windows do not divide 64 rows
    (12, 3),                    # a window of 12 bytes
    (0, 384),                   # empty
    (768,),                     # not a matrix
    'offset',                   # y not 16-byte aligned
])
def test_window_cuda_refuses_shapes_before_launch(cpu_stands_for_card, y):
    y = _offset((768, 384)) if y == 'offset' else torch.zeros(y)
    with pytest.raises(ValueError, match='window'):
        hopper_feats.window_cuda(y, torch.zeros(1, dtype=torch.int32))


@pytest.mark.parametrize('x,out', [
    ((36, 18), None),           # cols not a multiple of 4
    ((34, 20), None),           # rows not a multiple of 4
    ((0, 512), None),           # empty
    ((512,), None),             # not a matrix
    ('offset', None),           # x not 16-byte aligned
    ((256, 512), 'offset'),     # out not 16-byte aligned
    ('tall', None),             # more row tiles than the grid's y axis
])
def test_transpose_cuda_refuses_shapes_before_launch(cpu_stands_for_card, x,
                                                     out):
    if x == 'offset':
        x = _offset((256, 512))
    elif x == 'tall':
        x = torch.empty((hopper_feats.TRANSPOSE_MAX_ROWS + 4, 4),
                        device='meta')
    else:
        x = torch.zeros(x)
    if out == 'offset':
        out = _offset((512, 256))
    with pytest.raises(ValueError, match='transpose'):
        hopper_feats.transpose_cuda(x, out=out)


@pytest.mark.parametrize('n', [0, hopper_feats.SPLIT_MAX_N + 1])
def test_split_cuda_refuses_shapes_before_launch(cpu_stands_for_card, n):
    """No element, or more than the kernel's int indexing reaches (a meta
    tensor: the size without the memory)."""
    with pytest.raises(ValueError, match='split'):
        hopper_feats.split_cuda(torch.empty(n, device='meta'))


def test_refusal_checks_pass_the_probe_shapes(cpu_stands_for_card,
                                              probe_inputs):
    """At the probe's own shapes, the ragged shapes ``chip_smoke.py``
    holds and the largest the kernels take, the checks pass and the
    wrapper goes on to the launch (which the fixture turns into an
    error)."""
    t = {k: torch.as_tensor(v) for k, v in probe_inputs.items()}
    with pytest.raises(AssertionError, match='probe_dot was launched'):
        hopper_feats.dot_cuda(t['a'], t['b'])
    with pytest.raises(AssertionError, match='probe_window was launched'):
        hopper_feats.window_cuda(t['y'], t['sel'])
    for x in (t['x'], torch.zeros(36, 20),
              torch.empty((hopper_feats.TRANSPOSE_MAX_ROWS, 4),
                          device='meta')):
        with pytest.raises(AssertionError,
                           match='probe_transpose was launched'):
            hopper_feats.transpose_cuda(x)
    with pytest.raises(AssertionError, match='probe_transpose was launched'):
        hopper_feats.transpose_cuda(t['x'], out=torch.empty(512, 256))
    for v in (t['v'], torch.zeros(4100),
              torch.empty(hopper_feats.SPLIT_MAX_N, device='meta')):
        with pytest.raises(AssertionError, match='probe_split was launched'):
            hopper_feats.split_cuda(v)


# ---- entry points, wrappers and the kernel table ----

class _Event:
    """A row of ``key_averages()`` as the profiler gives it."""

    def __init__(self, key, device_type, us, count=1, annotation=False):
        self.key, self.count = key, count
        self.device_type = f'DeviceType.{device_type}'
        self.self_device_time_total = us
        self.is_user_annotation = annotation


class _Profile:
    def __init__(self, events):
        self._events = events

    def key_averages(self):
        return self._events


def test_device_rows_keeps_the_devices_own_events():
    """Kernels and copies count once: not the CPU op that launched them
    (its key also has a CPU row), a user range laid over them, or an
    event with no device time."""
    prof = _Profile([
        _Event('probe_dot_kernel', 'CUDA', 270.0, count=100),
        _Event('Memcpy DtoD', 'CUDA', 30.0, count=10),
        _Event('aten::mm', 'CPU', 0.0),
        _Event('aten::mm', 'CUDA', 500.0),
        _Event('Optimizer.step#Adam.step', 'CUDA', 900.0, annotation=True),
        _Event('idle_kernel', 'CUDA', 0.0),
    ])
    assert bench_dma.device_rows(prof) == [
        ('probe_dot_kernel', 100, 0.27), ('Memcpy DtoD', 10, 0.03)]


@pytest.mark.parametrize('empty,want', [(0, 2.7), (2, 2.7), (3, None)])
def test_device_us_per_call_retakes_an_empty_profile(monkeypatch, empty,
                                                     want):
    """A profile with no device event is taken again up to twice; then
    the time is not measured (None)."""
    import torch.profiler

    taken = []

    class Profile(_Profile):
        def __init__(self, activities):
            super().__init__([] if len(taken) < empty else [
                _Event('probe_dot_kernel', 'CUDA', 135.0, count=50)])
            taken.append(self)

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

    monkeypatch.setattr(torch.profiler, 'profile', Profile)
    monkeypatch.setattr(torch.cuda, 'synchronize', lambda: None)
    got = bench_dma.device_us_per_call(lambda: None)
    assert got == pytest.approx(want) if want else got is None
    assert len(taken) == min(empty + 1, 3)


@pytest.mark.parametrize('module', [bench_dma, hopper_feats,
                                    feats_time])
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
        # a kernel replaces a Pallas call, or (MD's neighbor rebuild) the
        # host core's entry point, or (a family the JAX package lacks)
        # stands beside its plain version
        want = ('sevennl_build(' if name in cs.NEIGHBOR else
                cs.SO2_PLAIN.get(name, 'pl.pallas_call('))
        assert want in text, (name, info['replaces'], text)
