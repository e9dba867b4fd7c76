"""Sorted segment sum and the scatter/gather pair built on it.

Port of ``sevennet_finetuning_tpu/ops/pallas_scatter.py``.  The
message-passing aggregation ``out[n] = sum_{e: dst[e]=n} msg[e]`` for an
ascending ``dst`` (the collate contract) runs as the CUDA kernel
``csrc/segment_sum.cu`` on CUDA tensors and as its plain PyTorch version
on CPU tensors.  Destinations >= n (the padding sentinel) are dropped.

- ``segment_sum_sorted``: the kernel as an autograd Function; its
  backward is the gather ``ct[dst]`` with zeros at the sentinel.
- ``scatter_rows``: scatter-add by an unsorted index given the static
  permutation that sorts it (collate's ``EDGE_SRC_PERM``, required):
  permute, then the sorted kernel.
- ``gather_rows``: ``x[idx]`` (clamped, as a JAX gather) whose backward is
  ``scatter_rows``, which DROPS the cotangents of out-of-range (padded)
  rows; exact for the model because EDGE_MASK zeroes padded messages.
"""

from __future__ import annotations

import torch

from . import _cuda


def row_offsets(dst: torch.Tensor, n_rows: int) -> torch.Tensor:
    """CSR offsets of an ascending index: rows n own [offs[n], offs[n+1])."""
    bounds = torch.arange(n_rows + 1, dtype=dst.dtype, device=dst.device)
    return torch.searchsorted(dst, bounds).to(torch.int32)


def segment_sum_plain(msg: torch.Tensor, dst: torch.Tensor,
                      n_rows: int) -> torch.Tensor:
    """Plain PyTorch version: index_add_ with a drop row for the sentinel."""
    out = msg.new_zeros((n_rows + 1, msg.shape[1]))
    out.index_add_(0, dst.clamp(max=n_rows).long(), msg)
    return out[:n_rows]


def segment_sum_cuda(msg: torch.Tensor, dst: torch.Tensor,
                     n_rows: int) -> torch.Tensor:
    """The CUDA kernel: msg [E, D] f32, dst [E] int32 ascending."""
    E, D = msg.shape
    _cuda.require(msg, 'msg', torch.float32)
    _cuda.require(dst, 'dst', torch.int32, (E,))
    offs = row_offsets(dst, n_rows)
    out = torch.empty((n_rows, D), dtype=msg.dtype, device=msg.device)
    fn = _cuda.kernel('segment_sum')
    _cuda.LAUNCHES['segment_sum'] += 1
    _cuda.check('segment_sum', fn(
        msg.data_ptr(), offs.data_ptr(), out.data_ptr(), n_rows, D,
        _cuda.stream_ptr(msg.device)))
    return out


def _segment_sum(msg, dst, n_rows):
    if msg.is_cuda:
        return segment_sum_cuda(msg.contiguous(), dst.contiguous(), n_rows)
    return segment_sum_plain(msg, dst, n_rows)


def gather_zero_oob(values: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """values[idx] with zero rows where idx >= len(values)."""
    n = values.shape[0]
    out = values[idx.clamp(max=n - 1).long()]
    return out * (idx < n).to(values.dtype)[:, None]


class SegmentSumSorted(torch.autograd.Function):
    @staticmethod
    def forward(ctx, msg, dst, n_rows):
        ctx.save_for_backward(dst)
        ctx.n_rows = n_rows
        return _segment_sum(msg, dst, n_rows)

    @staticmethod
    def backward(ctx, ct):
        (dst,) = ctx.saved_tensors
        return gather_zero_oob(ct, dst), None, None


def segment_sum_sorted(msg: torch.Tensor, dst: torch.Tensor,
                       n_rows: int) -> torch.Tensor:
    """Sum of msg [E, D] rows into [n_rows, D] by ascending ``dst``."""
    return SegmentSumSorted.apply(msg, dst, n_rows)


def scatter_rows(values: torch.Tensor, idx: torch.Tensor, n_rows: int,
                 perm: torch.Tensor) -> torch.Tensor:
    """``out[idx[e]] += values[e]`` for unsorted ``idx``, given ``perm``
    with idx[perm] ascending: the sum runs on the sorted kernel."""
    perm = perm.long()
    return segment_sum_sorted(values[perm], idx[perm], n_rows)


class GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, idx, perm):
        ctx.save_for_backward(idx, perm)
        ctx.n_rows = x.shape[0]
        return x[idx.clamp(max=x.shape[0] - 1).long()]

    @staticmethod
    def backward(ctx, ct):
        idx, perm = ctx.saved_tensors
        return scatter_rows(ct, idx, ctx.n_rows, perm), None, None


def gather_rows(x: torch.Tensor, idx: torch.Tensor,
                perm: torch.Tensor) -> torch.Tensor:
    """``x[idx]`` (out-of-range idx clamps to the last row); ``perm``
    sorts ``idx``, so the backward drops out-of-range cotangents and
    rides the kernel."""
    return GatherRows.apply(x, idx, perm)
