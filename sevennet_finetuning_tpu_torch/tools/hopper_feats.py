"""Hopper feature probes: does the card do what a faster ``cg_*`` kernel
would ask of it, and how accurately?

Counterpart of ``tools/test_mosaic_feats.py`` (the TPU's feasibility
probes for the gather-fused backward).  Four tiny kernels of
``csrc/probe_feats.cu`` at the TPU probe's shapes, each wrapper beside its
plain PyTorch version:

1. ``transpose``: in-kernel transpose of a [256, 512] float32 tile
   (``t_transpose``, test_mosaic_feats.py:47), a warp a 16 x 32 tile, a
   lane a 4 x 4 sub-block transposed in registers; bit-exact;
2. ``split3``: bitcast + mask split of float32 into hi / mid / lo bf16
   whose sum is x bit for bit, [128, 256] with values x 100 (``t_split``,
   :74);
3. ``dot_lane_contract``: a[W, C]^T b[W, TE] = [384, 256], W = 64, on
   wgmma as the six bf16 products of the split operands that
   Precision.HIGHEST takes on the TPU (``t_dotgen``, :96), a block a 64 x
   16 output tile; within atol 1e-4 of float64, the TPU probe's rule.  It
   also prints the max-abs error over |a|^T |b| beside the port's 2e-6
   kernel tolerance;
4. ``window``: window ``sel`` (a runtime scalar on the device, 5) of 12
   windows of [64, 384] float32, cut into the pieces of ``window_plan``,
   a block a piece: each fetches its piece by one bulk copy under a
   predicate per window and stores it by one bulk store (``t_winDMA``,
   :123); bit-exact.

    python -m sevennet_finetuning_tpu_torch.tools.hopper_feats

prints OK / MISMATCH / FAIL per probe, goes on after a failure, and exits
non-zero unless every probe is OK.  The card is required: there is no CPU
path.
"""

from __future__ import annotations

import sys
import time
from typing import Dict, Tuple

import numpy as np
import torch

from ..ops import _cuda

KERNEL_TOL = 2e-6          # the port's kernel tolerance (relative)
DOT_ATOL = 1e-4            # the TPU probe's rule for the product
N_WINDOWS, WINDOW_ROWS, WINDOW_COLS = 12, 64, 384
SELECTED = 5
SEED = 0
# the six products of the split operands, (part of a, part of b) with
# parts 0 = hi, 1 = mid, 2 = lo, smallest first: mm, hl, lh, hm, mh, hh
PRODUCTS = ((1, 1), (0, 2), (2, 0), (0, 1), (1, 0), (0, 0))
_HI_MASK = -65536          # 0xFFFF0000 as int32
# a block's output tile of the product (csrc/probe_feats.cu DOT_M, DOT_N;
# DOT_M is also the largest W)
DOT_M, DOT_N = 64, 16
# the transpose: a lane a TRANSPOSE_SUB x TRANSPOSE_SUB sub-block, so rows
# and cols are multiples of it; a block a tile of TRANSPOSE_BLOCK_ROWS
# rows, the row tiles along the grid's y axis, at most 65535 of them
# (csrc/probe_feats.cu)
TRANSPOSE_SUB = 4
TRANSPOSE_BLOCK_ROWS = 16
TRANSPOSE_MAX_ROWS = 65535 * TRANSPOSE_BLOCK_ROWS
# the split indexes its three parts by int: 3 n - 1 < 2^31
# (csrc/probe_feats.cu SPLIT_MAX_N)
SPLIT_MAX_N = (2 ** 31 - 1) // 3
# the window's pieces, a block each: WINDOW_PIECE_BYTES a piece; at most
# WINDOW_MAX_PIECE, a block's default dynamic shared memory beside its
# mbarrier (csrc/probe_feats.cu)
WINDOW_PIECE_BYTES = 2048
WINDOW_MAX_PIECE = 49152 - 128


def probe_inputs() -> Dict[str, np.ndarray]:
    """The probes' inputs at the TPU probe's shapes, drawn in its order
    from numpy seed SEED."""
    rng = np.random.default_rng(SEED)
    x = rng.standard_normal((256, 512)).astype(np.float32)
    v = (rng.standard_normal((128, 256)) * 100).astype(np.float32)
    a = rng.standard_normal((64, 384)).astype(np.float32)
    b = rng.standard_normal((64, 256)).astype(np.float32)
    y = rng.standard_normal((N_WINDOWS * WINDOW_ROWS, WINDOW_COLS)).astype(
        np.float32)
    return dict(x=x, v=v, a=a, b=b, y=y,
                sel=np.array([SELECTED], np.int32))


# ---- 1. transpose ----

def transpose_plain(x: torch.Tensor) -> torch.Tensor:
    return x.t().contiguous()


def transpose_cuda(x: torch.Tensor, out: torch.Tensor = None
                   ) -> torch.Tensor:
    """x.T by the kernel, into ``out`` where given: x [rows, cols] with
    rows and cols multiples of TRANSPOSE_SUB, rows at most
    TRANSPOSE_MAX_ROWS, x and out 16-byte aligned (float4 loads and
    stores)."""
    _cuda.require(x, 'x', torch.float32)
    if x.dim() != 2:
        raise ValueError('transpose: x must be a matrix')
    rows, cols = x.shape
    if (rows == 0 or cols == 0 or rows % TRANSPOSE_SUB
            or cols % TRANSPOSE_SUB or rows > TRANSPOSE_MAX_ROWS):
        raise ValueError(f'transpose: shape {tuple(x.shape)} needs rows and '
                         f'cols positive multiples of {TRANSPOSE_SUB}, rows '
                         f'at most {TRANSPOSE_MAX_ROWS}')
    if out is None:
        out = torch.empty((cols, rows), dtype=x.dtype, device=x.device)
    _cuda.require(out, 'out', torch.float32, (cols, rows))
    if x.data_ptr() % 16 or out.data_ptr() % 16:
        raise ValueError('transpose: the float4 loads and stores need '
                         '16-byte aligned x and out')
    fn = _cuda.kernel('probe_transpose')
    _cuda.LAUNCHES['probe_transpose'] += 1
    _cuda.check('probe_transpose', fn(x.data_ptr(), out.data_ptr(), rows,
                                      cols, _cuda.stream_ptr(x.device)))
    return out


def transpose(x: torch.Tensor) -> torch.Tensor:
    if x.is_cuda:
        return transpose_cuda(x)
    return transpose_plain(x)


# ---- 2. bf16x3 split ----

def split_plain(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(parts [3, *x.shape] bf16 = hi, mid, lo; (hi + mid) + lo in
    float32), by int32 bit masks."""
    hi = (x.view(torch.int32) & _HI_MASK).view(torch.float32)
    r1 = x - hi
    mid = (r1.view(torch.int32) & _HI_MASK).view(torch.float32)
    lo = r1 - mid
    parts = torch.stack([hi, mid, lo]).to(torch.bfloat16)
    recon = (parts[0].float() + parts[1].float()) + parts[2].float()
    return parts, recon


def split_cuda(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """split_plain by the kernel, an element a thread: any x of 1 to
    SPLIT_MAX_N elements."""
    _cuda.require(x, 'x', torch.float32)
    if not 0 < x.numel() <= SPLIT_MAX_N:
        raise ValueError(f'split: {x.numel()} elements, the kernel takes 1 '
                         f'to {SPLIT_MAX_N}')
    parts = torch.empty((3,) + tuple(x.shape), dtype=torch.bfloat16,
                        device=x.device)
    recon = torch.empty_like(x)
    fn = _cuda.kernel('probe_split')
    _cuda.LAUNCHES['probe_split'] += 1
    _cuda.check('probe_split', fn(x.data_ptr(), parts.data_ptr(),
                                  recon.data_ptr(), x.numel(),
                                  _cuda.stream_ptr(x.device)))
    return parts, recon


def split3(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    if x.is_cuda:
        return split_cuda(x)
    return split_plain(x)


# ---- 3. lane-contracting product ----

def dot_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a[W, C]^T b[W, TE] as the six split products, each a float32
    matmul of bf16-valued operands (exact products; only the order of
    the sums differs from the kernel)."""
    pa = split_plain(a)[0].float()
    pb = split_plain(b)[0].float()
    out = None
    for i, j in PRODUCTS:
        term = torch.matmul(pa[i].t(), pb[j])
        out = term if out is None else out + term
    return out


def dot_cuda(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    _cuda.require(a, 'a', torch.float32)
    _cuda.require(b, 'b', torch.float32)
    if a.dim() != 2 or b.dim() != 2:
        raise ValueError('dot: a and b must be matrices')
    w, m = a.shape
    n = b.shape[1]
    if (b.shape[0] != w or w % 16 or not 0 < w <= DOT_M or m % DOT_M
            or m == 0 or n % DOT_N or n == 0):
        raise ValueError(f'dot: shapes {tuple(a.shape)} x {tuple(b.shape)} '
                         f'need W = b rows, a multiple of 16 up to {DOT_M}, '
                         f'C a multiple of {DOT_M} and TE of {DOT_N}')
    if a.data_ptr() % 16 or b.data_ptr() % 16:
        raise ValueError('dot: the float4 loads need 16-byte aligned a and b')
    out = torch.empty((m, n), dtype=a.dtype, device=a.device)
    fn = _cuda.kernel('probe_dot')
    _cuda.LAUNCHES['probe_dot'] += 1
    _cuda.check('probe_dot', fn(a.data_ptr(), b.data_ptr(), out.data_ptr(),
                                w, m, n, _cuda.stream_ptr(a.device)))
    return out


def dot_lane_contract(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    if a.is_cuda:
        return dot_cuda(a, b)
    return dot_plain(a, b)


# ---- 4. predicated window copy ----

def window_plain(y: torch.Tensor, sel: torch.Tensor) -> torch.Tensor:
    """Window ``sel[0]`` of the N_WINDOWS row windows of y, as a slice;
    zeros for a selector out of range."""
    wb = y.shape[0] // N_WINDOWS
    s = int(sel[0])
    if not 0 <= s < N_WINDOWS:
        return y.new_zeros((wb, y.shape[1]))
    return y[s * wb:(s + 1) * wb].clone()


def window_plan(win_floats: int) -> Tuple[int, int]:
    """(pieces, floats a piece) of a window of ``win_floats`` float32: the
    window cut into pieces of WINDOW_PIECE_BYTES (the last one shorter), a
    block each.  Every piece is a multiple of 16 bytes, as bulk copies
    need, and fits a block's shared memory."""
    if win_floats <= 0 or win_floats % 4:
        raise ValueError(f'window: {win_floats} floats are not a positive '
                         'multiple of 16 bytes')
    piece = min(WINDOW_PIECE_BYTES // 4, win_floats)
    return -(-win_floats // piece), piece


def window_cuda(y: torch.Tensor, sel: torch.Tensor) -> torch.Tensor:
    """Window ``sel[0]`` of y by the kernel, a block for each piece of
    ``window_plan``."""
    _cuda.require(y, 'y', torch.float32)
    _cuda.require(sel, 'sel', torch.int32, (1,))
    if y.dim() != 2 or y.shape[0] % N_WINDOWS or y.numel() == 0:
        raise ValueError(f'window: {N_WINDOWS} windows do not divide '
                         f'{tuple(y.shape)} into row windows')
    wb = y.shape[0] // N_WINDOWS
    win_floats = wb * y.shape[1]
    n_pieces, piece = window_plan(win_floats)
    if y.data_ptr() % 16:
        raise ValueError('window: the bulk copies need a 16-byte aligned y')
    out = torch.empty((wb, y.shape[1]), dtype=y.dtype, device=y.device)
    fn = _cuda.kernel('probe_window')
    _cuda.LAUNCHES['probe_window'] += 1
    _cuda.check('probe_window', fn(sel.data_ptr(), y.data_ptr(),
                                   out.data_ptr(), N_WINDOWS, win_floats,
                                   n_pieces, piece,
                                   _cuda.stream_ptr(y.device)))
    return out


def window(y: torch.Tensor, sel: torch.Tensor) -> torch.Tensor:
    if y.is_cuda:
        return window_cuda(y, sel)
    return window_plain(y, sel)


def dot_error(out: torch.Tensor, a: np.ndarray, b: np.ndarray
              ) -> Tuple[float, float]:
    """(max|out - a^T b| against float64, the largest ratio of that error
    to |a|^T |b| element by element)."""
    a64, b64 = a.astype(np.float64), b.astype(np.float64)
    err = np.abs(out.double().cpu().numpy() - a64.T @ b64)
    return float(err.max()), float((err / (np.abs(a64).T @ np.abs(b64))
                                    ).max())


def run_probes(device: torch.device) -> Dict[str, str]:
    """Each probe on the card with the TPU probe's pass rule; returns
    {probe: 'OK' | 'MISMATCH' | 'FAIL: ...'}."""
    inp = probe_inputs()
    t = {k: torch.as_tensor(v, device=device) for k, v in inp.items()}

    def p_transpose():
        return torch.equal(transpose_cuda(t['x']).cpu(),
                           torch.as_tensor(inp['x'].T.copy())), ''

    def p_split():
        parts, recon = split_cuda(t['v'])
        want_parts = split_plain(t['v'].cpu())[0]
        return (torch.equal(recon.cpu(), torch.as_tensor(inp['v']))
                and torch.equal(parts.cpu(), want_parts)), ''

    def p_dot():
        out = dot_cuda(t['a'], t['b'])
        ref = inp['a'].astype(np.float64).T @ inp['b'].astype(np.float64)
        ok = np.allclose(out.cpu().numpy(), ref, atol=DOT_ATOL)
        err, ratio = dot_error(out, inp['a'], inp['b'])
        return ok, (f'max-abs err vs float64 {err:.3e}; max err / '
                    f'(|a|^T|b|) {ratio:.3e} (kernel tolerance '
                    f'{KERNEL_TOL:g}: {"within" if ratio <= KERNEL_TOL else "above"})')

    def p_window():
        out = window_cuda(t['y'], t['sel'])
        s = int(inp['sel'][0])
        return torch.equal(out.cpu(), torch.as_tensor(
            inp['y'][s * WINDOW_ROWS:(s + 1) * WINDOW_ROWS])), ''

    status = {}
    for name, probe in (('in-kernel transpose', p_transpose),
                        ('bf16x3 bitcast split', p_split),
                        ('wgmma lane-contract', p_dot),
                        ('predicated window bulk copy', p_window)):
        t0 = time.perf_counter()
        try:
            ok, detail = probe()
            torch.cuda.synchronize()
        except (RuntimeError, ValueError) as e:
            status[name] = f'FAIL: {type(e).__name__}: {str(e)[:200]}'
            print(f'{name:28s} {status[name]}', flush=True)
            continue
        status[name] = 'OK' if ok else 'MISMATCH'
        print(f'{name:28s} {status[name]} ({time.perf_counter() - t0:.3f} s)'
              + (f' {detail}' if detail else ''), flush=True)
    return status


def main() -> int:
    if not torch.cuda.is_available():
        raise RuntimeError('hopper_feats probes the CUDA card: no CUDA '
                           'device (there is no CPU path)')
    status = run_probes(torch.device('cuda'))
    return 0 if all(v == 'OK' for v in status.values()) else 1


if __name__ == '__main__':
    sys.exit(main())
