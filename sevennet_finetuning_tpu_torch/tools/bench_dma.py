"""Copy bandwidth of the card: hand-written copy kernels against PyTorch's
own kernel on the same traffic.

Counterpart of ``tools/bench_dma.py``, which measured the TPU's Pallas
HBM pipelining ceiling against XLA.  Same slab (E x D float32, 66 MB),
same 300 launches per variant, same sweep: an overhead control, library
controls, tiled copies by row tile (em) and by column strip of the
transposed slab (fm), a read-only column sum, and a ring of bulk copies
in several shapes.

    python -m sevennet_finetuning_tpu_torch.tools.bench_dma

prints one line per variant, then one JSON dict of GB/s per variant (the
overhead control in microseconds per launch), the best hand-written copy
rate and PyTorch's as shares of the published 3.35 TB/s, and the card's
name and power limit.  Launches take N_SLABS input and output slabs in
turn, so no launch finds its input in the 50 MB L2.  Each hand-written
variant's output is held against its plain version once, bit for bit.
A variant that fails is recorded, the sweep goes on, and the exit code
is then 1.  The card is required: there is no CPU path.

Kernels (``csrc/probe_copy.cu``), each wrapper beside its plain version:

- ``copy_tiled``: y = x * C over chunks of ``COPY_THREADS x COPY_DEPTH``
  float4s of the row tiles or column strips, numbered in tile order, a
  grid sized to the card (``bs_copy``, bench_dma.py:84);
  ``tiled_chunks`` lays the chunks out;
- ``colsum``: the column sum in two passes, slabs of rows by bands of
  columns, then the slabs' partial rows (``bs_read``, :109);
  ``colsum_stripes`` lays out its first pass;
- ``copy_ring``: y = x * C through an input ring and an output ring in
  shared memory, each tile in ``split`` tensor-map bulk copies (one box
  a TPU column copy), a loading warp, a storing warp and consumer warps
  (``manual_copy``, :167); ``ring_variants`` plans the shapes that fit a
  block's shared memory, ``ring_box`` the copies' box.
"""

from __future__ import annotations

import json
import subprocess
import sys
from typing import Callable, Dict, List, Optional, Tuple

import torch

from ..ops import _cuda

E, D = 21504, 768          # ~66 MB float32 slab, the TPU sweep's shape
N_IT = 300                 # launches timed per variant
C = 1.0000001
N_SLABS = 3                # 3 x 2 x 66 MB between two uses of a slab
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
SMEM_BYTES = 232448        # shared memory one block may use (227 KB)
RING_MAX_SLOTS = 16
# bytes before the two rings: three mbarriers a slot (full, done, vacant)
RING_HEADER = 3 * 8 * RING_MAX_SLOTS
# the tiled copy: threads a block, 16-byte loads in flight a thread
# (csrc/probe_copy.cu COPY_THREADS, COPY_DEPTH), a chunk one of each
COPY_THREADS = 256
COPY_DEPTH = 4
EM_TILES = (128, 256, 512, 1024)
FM_TILES = (256, 512)
READ_TILES = (256, 512)
# the column sum's first pass: slabs of COLSUM_SLAB_ROWS rows, a block a
# slab and a band of 32 float4 columns, COLSUM_WARPS warps a block
# (84 x 6 = 504 blocks at E x D: several a streaming multiprocessor)
COLSUM_SLAB_ROWS = 256
COLSUM_WARPS = 8
# ring shapes tried, (rows per tile, slots, column copies a tile); the
# planner keeps those that fit.  Two rings share the 227 KB, so a tile
# has half the rows the one-ring design gave the same slots; (8, 4, 2)
# and (16, 2, 1) take the shared memory of its table cases (16, 4, 2)
# and (32, 2, 1)
RING_CANDIDATES = tuple((rows, slots, 1) for rows in (4, 8, 16)
                        for slots in (2, 3, 4)) + (
    (8, 4, 2), (8, 4, 4), (16, 2, 4), (4, 4, 2))


def copy_tiled_plain(x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the tiled copy and of the ring."""
    return x * C


def tiled_region(rows: int, cols: int, te: int, fm: bool, tile: int):
    """Tile ``tile`` of x [rows, cols] in float4s, as the tiled copy takes
    it: (first float4, row width, row stride, float4s).  em: ``te``
    contiguous rows; fm: ``te`` columns of every row."""
    cols4 = cols // 4
    if fm:
        return tile * (te // 4), te // 4, cols4, rows * (te // 4)
    return tile * te * cols4, cols4, cols4, te * cols4


def tiled_chunks(rows: int, cols: int, te: int, fm: bool, grid: int):
    """The tiled copy's chunks as the kernel takes them: (block, tile,
    first, end) in the tile's row-major float4 order (``tiled_region``),
    each tile cut into chunks of ``COPY_THREADS x COPY_DEPTH`` float4s
    (the last shorter), numbered tile by tile; chunk q goes to block q %
    grid."""
    chunk = COPY_THREADS * COPY_DEPTH
    n_tiles = (cols if fm else rows) // te
    tile_n = tiled_region(rows, cols, te, fm, 0)[3]
    per_tile = -(-tile_n // chunk)
    return [(q % grid, q // per_tile, (q % per_tile) * chunk,
             min(tile_n, (q % per_tile + 1) * chunk))
            for q in range(n_tiles * per_tile)]


def copy_tiled_cuda(x: torch.Tensor, te: int, fm: bool = False,
                    out: torch.Tensor = None) -> torch.Tensor:
    """y = x * C by the kernel over the ``te``-row tiles of x [R, K] or,
    with ``fm``, its ``te``-column strips, in chunks spread over a grid
    sized to the card."""
    _cuda.require(x, 'x', torch.float32)
    rows, cols = x.shape
    if te <= 0 or (cols if fm else rows) % te or cols % 4 or (fm and te % 4):
        raise ValueError(f'copy_tiled: tile {te} does not divide '
                         f'{tuple(x.shape)} ({"fm" if fm else "em"})')
    x = _cuda.aligned16(x)
    out = torch.empty_like(x) if out is None else out
    _cuda.require(out, 'out', torch.float32, x.shape)
    fn = _cuda.kernel('probe_copy_tiled')
    _cuda.LAUNCHES['probe_copy_tiled'] += 1
    _cuda.check('probe_copy_tiled', fn(
        x.data_ptr(), out.data_ptr(), rows, cols, te, int(fm), C,
        _cuda.stream_ptr(x.device)))
    return out


def copy_tiled(x: torch.Tensor, te: int, fm: bool = False) -> torch.Tensor:
    if x.is_cuda:
        return copy_tiled_cuda(x, te, fm)
    return copy_tiled_plain(x)


def colsum_plain(x: torch.Tensor, te: int) -> torch.Tensor:
    """Plain version: each tile's column sum, then the sum over tiles;
    [R, K] -> [1, K]."""
    rows, cols = x.shape
    return x.view(rows // te, te, cols).sum(1).sum(0, keepdim=True)


def colsum_stripes(rows: int):
    """The first pass's rows, as ``probe_colsum``'s kernel takes them:
    (slab, warp, first row, end row) of every warp's contiguous stripe,
    each warp of a slab's block ``ceil(n / COLSUM_WARPS)`` rows of the
    slab's n (the last stripes shorter or empty).  Every band of columns
    takes the same stripes."""
    out = []
    for k in range(-(-rows // COLSUM_SLAB_ROWS)):
        r0 = k * COLSUM_SLAB_ROWS
        n = min(COLSUM_SLAB_ROWS, rows - r0)
        per = -(-n // COLSUM_WARPS)
        for w in range(COLSUM_WARPS):
            out.append((k, w, r0 + min(n, w * per),
                        r0 + min(n, (w + 1) * per)))
    return out


def colsum_cuda(x: torch.Tensor, te: int) -> torch.Tensor:
    """The column sum by the kernel: a partial row per slab of
    ``COLSUM_SLAB_ROWS`` rows, then the partials in slab order (no
    atomics).  ``te``, the TPU tool's tile, must divide the rows; the
    schedule does not use it."""
    _cuda.require(x, 'x', torch.float32)
    rows, cols = x.shape
    if te <= 0 or rows % te or cols % 4:
        raise ValueError(f'colsum: tile {te} does not divide '
                         f'{tuple(x.shape)}')
    x = _cuda.aligned16(x)
    part = torch.empty((-(-rows // COLSUM_SLAB_ROWS), cols), dtype=x.dtype,
                       device=x.device)
    out = torch.empty((1, cols), dtype=x.dtype, device=x.device)
    fn = _cuda.kernel('probe_colsum')
    _cuda.LAUNCHES['probe_colsum'] += 1
    _cuda.check('probe_colsum', fn(
        x.data_ptr(), part.data_ptr(), out.data_ptr(), rows, cols, te,
        COLSUM_SLAB_ROWS, _cuda.stream_ptr(x.device)))
    return out


def colsum(x: torch.Tensor, te: int) -> torch.Tensor:
    if x.is_cuda:
        return colsum_cuda(x, te)
    return colsum_plain(x, te)


def ring_smem_bytes(rows: int, slots: int, cols: int = D) -> int:
    """Shared memory of one ring block: the mbarriers, then the input
    ring's slots, then the output ring's."""
    return RING_HEADER + 2 * slots * rows * cols * 4


def ring_box(cols: int, split: int) -> int:
    """The width w of the ring's tensor-map box for copies of ``cols /
    split`` columns: the widest of 64 .. 4 floats (16-byte multiples) that
    divides a copy in at most 256 steps (a box dimension's limit); 0 if
    none does.  A copy is the box (w, piece / w, rows)."""
    piece = cols // split
    return next((w for w in (64, 32, 16, 8, 4)
                 if piece % w == 0 and piece // w <= 256), 0)


def ring_fits(rows: int, slots: int, split: int, n_rows: int = E,
              cols: int = D) -> bool:
    """Whether the card takes this ring shape: tiles divide the slab,
    2 <= slots <= RING_MAX_SLOTS, at most 32 copies a tile (a lane each)
    of a tensor-map box (``ring_box``; at most 256 rows), every copy's
    place in shared memory 128-byte aligned, and both rings fit a block's
    shared memory."""
    return (0 < rows <= 256 and n_rows % rows == 0
            and 2 <= slots <= RING_MAX_SLOTS
            and 0 < split <= 32 and cols % split == 0
            and ring_box(cols, split) > 0
            and rows * (cols // split) * 4 % 128 == 0
            and ring_smem_bytes(rows, slots, cols) <= SMEM_BYTES)


def ring_variants() -> List[Tuple[int, int, int]]:
    """The (rows, slots, split) shapes of the ring sweep that fit the
    bench's slab."""
    return [v for v in RING_CANDIDATES if ring_fits(*v)]


def copy_ring_cuda(x: torch.Tensor, rows: int, slots: int, split: int = 1,
                   out: torch.Tensor = None) -> torch.Tensor:
    """y = x * C by the bulk-copy rings: tiles of ``rows`` rows, ``slots``
    slots a ring, each tile in ``split`` column copies; as many blocks as
    the card holds at that shared memory."""
    _cuda.require(x, 'x', torch.float32)
    n_rows, cols = x.shape
    if not ring_fits(rows, slots, split, n_rows, cols):
        raise ValueError(f'copy_ring: shape rows={rows} slots={slots} '
                         f'split={split} does not fit {tuple(x.shape)}')
    x = _cuda.aligned16(x)
    out = torch.empty_like(x) if out is None else out
    _cuda.require(out, 'out', torch.float32, x.shape)
    fn = _cuda.kernel('probe_copy_ring')
    _cuda.LAUNCHES['probe_copy_ring'] += 1
    _cuda.check('probe_copy_ring', fn(
        x.data_ptr(), out.data_ptr(), n_rows, cols, rows, slots, split, C,
        _cuda.stream_ptr(x.device)))
    return out


def copy_ring(x: torch.Tensor, rows: int, slots: int,
              split: int = 1) -> torch.Tensor:
    if x.is_cuda:
        return copy_ring_cuda(x, rows, slots, split)
    return copy_tiled_plain(x)


def time_ms(step: Callable[[int], object], n_it: int = N_IT) -> float:
    """ms per launch of step(i), i = 0..n_it-1, between two CUDA events
    after three warm-up launches."""
    for i in range(3):
        step(i)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(n_it):
        step(i)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / n_it


def card_line() -> str:
    """The card's name and power limit as nvidia-smi gives them."""
    try:
        out = subprocess.run(
            ['nvidia-smi', '--query-gpu=name,power.limit',
             '--format=csv,noheader'], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError) as e:
        return f'nvidia-smi unavailable: {e}'


def _self_device_us(evt) -> float:
    for attr in ('self_device_time_total', 'self_cuda_time_total'):
        v = getattr(evt, attr, None)
        if v is not None:
            return float(v)
    return 0.0


def device_rows(prof) -> List[Tuple[str, int, float]]:
    """(key, count, ms) of the device's own events (kernels, copies,
    fills) in a torch.profiler run.  CPU ops carry their kernels' time
    too and would count it twice, and so would a user range
    (``record_function``: the optimizer's ``Optimizer.step#Adam.step``)
    that the profiler also lays on the device's timeline over the
    kernels it spans."""
    avgs = prof.key_averages()
    cpu_keys = {e.key for e in avgs
                if not str(getattr(e, 'device_type', '')).endswith('CUDA')}
    return [(e.key, e.count, _self_device_us(e) / 1e3) for e in avgs
            if str(getattr(e, 'device_type', '')).endswith('CUDA')
            and not getattr(e, 'is_user_annotation', False)
            and e.key not in cpu_keys and _self_device_us(e) > 0]


def device_us_per_call(fn: Callable[[], object], n: int = 50,
                       retries: int = 2) -> Optional[float]:
    """Device time per call of fn in microseconds: its ``device_rows``
    under torch.profiler over n calls after one warm-up call, summed, /
    n.  A profile with no device event (the profiler now and then records
    none) is taken again, up to ``retries`` times; then None."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(retries + 1):
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        us = [r[2] * 1e3 for r in device_rows(prof)]
        if us:
            return sum(us) / n
    return None


def sweep(device: torch.device) -> Tuple[Dict[str, object], List[str]]:
    """Every variant once; returns ({name: GB/s, or 'FAIL: ...'}, names
    that failed).  ``overhead_tiny_us`` is microseconds per launch."""
    gen = torch.Generator(device=device).manual_seed(0)
    xs = [torch.randn(E, D, device=device, generator=gen)
          for _ in range(N_SLABS)]
    ys = [torch.empty_like(x) for x in xs]
    xts = [x.view(D, E) for x in xs]      # the fm slab: [D, E]
    yts = [y.view(D, E) for y in ys]
    nbytes = E * D * 4
    results: Dict[str, object] = {}
    failures: List[str] = []

    def run(name, step, n_bytes, check=None):
        try:
            if check is not None:
                check()
            ms = time_ms(step)
        except (RuntimeError, ValueError, AssertionError) as e:
            results[name] = f'FAIL: {type(e).__name__}: {e}'
            failures.append(name)
            print(f'{name:38s} FAIL {e}', flush=True)
            return
        if n_bytes is None:
            results[name] = ms * 1e3
            print(f'{name:38s} {ms * 1e3:8.3f} us per launch', flush=True)
            return
        results[name] = n_bytes / (ms * 1e-3) / 1e9
        print(f'{name:38s} {results[name]:8.1f} GB/s', flush=True)

    def exact(fn, x, want):
        def check():
            got = fn(x)
            if not torch.equal(got, want):
                raise AssertionError('MISMATCH against the plain version: '
                                     f'max|diff| {(got - want).abs().max()}')
        return check

    def mul(i):
        return torch.mul(xs[i % N_SLABS], C, out=ys[i % N_SLABS])

    # ---- overhead control: one tiny launch, ~zero traffic ----
    tiny = torch.ones(8, 128, device=device)
    tiny_out = torch.empty_like(tiny)
    run('overhead_tiny_us',
        lambda i: copy_tiled_cuda(tiny, 8, out=tiny_out), None,
        exact(lambda t: copy_tiled_cuda(t, 8), tiny, copy_tiled_plain(tiny)))

    # ---- PyTorch controls (the TPU sweep's XLA controls) ----
    time_ms(mul)              # warm-up: the card's clocks, the caches
    run('torch_mul', mul, 2 * nbytes)
    # x + x.sum() * 1e-30: two kernels, three passes over the slab;
    # counted at the two the function needs, as the TPU sweep counted it
    run('torch_copy_plus_reduce',
        lambda i: torch.add(xs[i % N_SLABS], xs[i % N_SLABS].sum() * 1e-30,
                            out=ys[i % N_SLABS]), 2 * nbytes)

    want = copy_tiled_plain(xs[0])
    want_t = copy_tiled_plain(xts[0])
    # ---- tiled copy: row tiles (em) and column strips (fm) ----
    for te in EM_TILES:
        run(f'cuda_tiled_em_te{te}',
            lambda i, te=te: copy_tiled_cuda(xs[i % N_SLABS], te,
                                             out=ys[i % N_SLABS]),
            2 * nbytes, exact(lambda x, te=te: copy_tiled_cuda(x, te),
                              xs[0], want))
    for te in FM_TILES:
        run(f'cuda_tiled_fm_te{te}',
            lambda i, te=te: copy_tiled_cuda(xts[i % N_SLABS], te, fm=True,
                                             out=yts[i % N_SLABS]),
            2 * nbytes, exact(lambda x, te=te: copy_tiled_cuda(x, te, True),
                              xts[0], want_t))

    # ---- read-only column sum ----
    for te in READ_TILES:
        def check(te=te):
            got = colsum_cuda(xs[0], te)
            x64 = xs[0].double()
            err = (got.double() - x64.sum(0, keepdim=True)).abs()
            if bool((err > 2e-6 * x64.abs().sum(0, keepdim=True)).any()):
                raise AssertionError('MISMATCH against the float64 sum')
        run(f'cuda_colsum_te{te}',
            lambda i, te=te: colsum_cuda(xs[i % N_SLABS], te), nbytes, check)

    # ---- bulk-copy ring ----
    for v in ring_variants():
        name = f'cuda_ring_r{v[0]}_s{v[1]}' + (
            f'_split{v[2]}' if v[2] > 1 else '')
        run(name,
            lambda i, v=v: copy_ring_cuda(xs[i % N_SLABS], *v,
                                          out=ys[i % N_SLABS]),
            2 * nbytes, exact(lambda x, v=v: copy_ring_cuda(x, *v),
                              xs[0], want))
    return results, failures


def summary(results: Dict[str, object]) -> Dict[str, object]:
    """The best hand-written copy and PyTorch's multiply as shares of the
    published peak."""
    copies = {k: v for k, v in results.items()
              if k.startswith(('cuda_tiled', 'cuda_ring'))
              and isinstance(v, float)}
    out: Dict[str, object] = {}
    if copies:
        best = max(copies, key=copies.get)
        out.update(best_hand_written=best,
                   best_hand_written_gbs=copies[best],
                   best_hand_written_share_of_peak=(
                       copies[best] * 1e9 / HBM_BYTES_PER_S))
    if isinstance(results.get('torch_mul'), float):
        out['torch_mul_share_of_peak'] = (results['torch_mul'] * 1e9
                                          / HBM_BYTES_PER_S)
    return out


def main() -> int:
    if not torch.cuda.is_available():
        raise RuntimeError('bench_dma measures the CUDA card: no CUDA '
                           'device (there is no CPU path)')
    results, failures = sweep(torch.device('cuda'))
    above = [k for k, v in results.items() if k != 'overhead_tiny_us'
             and isinstance(v, float) and v * 1e9 > HBM_BYTES_PER_S]
    print(json.dumps(results), flush=True)
    print(json.dumps(summary(results)), flush=True)
    if above:
        print(f'above the published 3.35 TB/s (an L2 artefact to find, '
              f'not a result): {above}', flush=True)
    print(f'card: {card_line()}', flush=True)
    if failures:
        print(f'failed: {failures}', flush=True)
    return 1 if failures or above else 0


if __name__ == '__main__':
    sys.exit(main())
