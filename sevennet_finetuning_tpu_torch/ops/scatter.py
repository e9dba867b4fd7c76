"""Sorted segment sum and the scatter/gather pair built on it.

Port of ``sevennet_finetuning_tpu/ops/pallas_scatter.py``.  The
message-passing aggregation ``out[n] = sum_{e: dst[e]=n} msg[e]`` for an
ascending ``dst`` (the collate contract) runs as the CUDA kernel
``csrc/segment_sum.cu`` on CUDA tensors and as its plain PyTorch version
on CPU tensors.  Destinations >= n (the padding sentinel) are dropped.

- ``segment_sum_sorted``: the kernel as an autograd Function; its
  backward is ``gather_zero_oob``, the gather ``ct[dst]`` with zeros at
  the sentinel, whose own backward is the segment sum again.
- ``scatter_rows``: scatter-add by an unsorted index given the static
  permutation that sorts it (collate's ``EDGE_SRC_PERM``) and its
  inverse (built once per batch by ``model.nequip.batch_to_torch``):
  permute, then the sorted kernel.  The permutation's backward gathers by
  the inverse.
- ``gather_rows``: ``x[idx]`` (clamped, as a JAX gather) whose backward is
  ``scatter_rows``, which DROPS the cotangents of out-of-range (padded)
  rows; exact for the model because EDGE_MASK zeroes padded messages.
  Without a permutation it builds the stable sort of ``idx`` on the
  device (``sort_perm``).  (JAX's ``gather_rows`` without one is a plain
  ``x[idx]``, whose transpose adds a padded row's cotangent to the last
  row; the two agree because those cotangents are exactly zero.)
- ``aggregate_messages``: the port of JAX ``aggregate_messages``; an
  unsorted ``dst`` takes its stable device sort, then ``scatter_rows``, so
  the sum stays on the sorted kernel and runs in a fixed order (no
  ``index_add_`` atomics on the card).  The sentinel dst = n_node drops,
  as XLA's ``segment_sum`` drops it.

- ``segment_softmax``: softmax of per-edge logits over each ascending
  destination's edges (the attention of the 'equiformer_v2' family),
  its sums on the sorted kernel.

Every backward here calls only Functions of this module, so the family
is closed under ``create_graph=True``: a double backward (the train
step's force loss) stays on the kernel and runs no accumulating scatter.
"""

from __future__ import annotations

import functools
from typing import Optional

import torch

from . import _cuda


def row_offsets(dst: torch.Tensor, n_rows: int) -> torch.Tensor:
    """CSR offsets of an ascending index: rows n own [offs[n], offs[n+1])
    (the cg_agg, cg_gagg and cg_multi wrappers pass them to their
    kernels; segment_sum's kernel finds its row bounds itself)."""
    bounds = torch.arange(n_rows + 1, dtype=dst.dtype, device=dst.device)
    return torch.searchsorted(dst, bounds).to(torch.int32)


def segment_sum_plain(msg: torch.Tensor, dst: torch.Tensor,
                      n_rows: int) -> torch.Tensor:
    """Plain PyTorch version: index_add_ with a drop row for the sentinel."""
    out = msg.new_zeros((n_rows + 1, msg.shape[1]))
    out.index_add_(0, dst.clamp(max=n_rows).long(), msg)
    return out[:n_rows]


# the staged shape serves calls with at most this many output elements
STAGED_MAX_OUTPUTS = 16384
# ... over rows of at least this many edges on average
STAGED_MIN_EDGES_PER_ROW = 64
# floats of one of its two shared-memory buffers (csrc/segment_sum.cu)
STAGED_FLOATS = 4096
# ... and its threads, one a column: wider rows take the rows shape
STAGED_MAX_D = 256


@functools.lru_cache(maxsize=None)
def segment_plan(n_edge: int, d: int, n_rows: int) -> int:
    """The kernel's shape for msg [n_edge, d] into n_rows rows, both
    adding each row's edges in edge order: 0 for one thread per output
    element, else the staged shape's edges per chunk (one block a row,
    the row staged through shared memory).  Few output elements over
    long rows (the per-graph energy and virial) are staged."""
    if (n_rows == 0 or d == 0 or d > STAGED_MAX_D
            or n_rows * d > STAGED_MAX_OUTPUTS
            or -(-n_edge // n_rows) < STAGED_MIN_EDGES_PER_ROW):
        return 0
    return STAGED_FLOATS // d


def segment_sum_cuda(msg: torch.Tensor, dst: torch.Tensor,
                     n_rows: int) -> torch.Tensor:
    """The CUDA kernel: msg [E, D] f32, dst [E] int32 ascending; one
    launch, the row bounds found on the device."""
    E, D = msg.shape
    _cuda.require(msg, 'msg', torch.float32)
    _cuda.require(dst, 'dst', torch.int32, (E,))
    out = msg.new_empty((n_rows, D))
    fn = _cuda.kernel('segment_sum')
    _cuda.LAUNCHES['segment_sum'] += 1
    _cuda.check('segment_sum', fn(
        msg.data_ptr(), dst.data_ptr(), out.data_ptr(), E, n_rows, D,
        segment_plan(E, D, n_rows), _cuda.stream_ptr(msg.device)))
    return out


def _segment_sum(msg, dst, n_rows):
    if msg.is_cuda:
        return segment_sum_cuda(msg.contiguous(), dst.contiguous(), n_rows)
    return segment_sum_plain(msg, dst, n_rows)


def _gather_zero_oob(values, idx):
    n = values.shape[0]
    out = values[idx.clamp(max=n - 1).long()]
    return out * (idx < n).to(values.dtype)[:, None]


class GatherZeroOOB(torch.autograd.Function):
    """values[idx] (ascending idx) with zero rows where idx >= n; the
    backward is the sorted segment sum over the same index."""

    @staticmethod
    def forward(ctx, values, idx):
        ctx.save_for_backward(idx)
        ctx.n_rows = values.shape[0]
        return _gather_zero_oob(values, idx)

    @staticmethod
    def backward(ctx, ct):
        (idx,) = ctx.saved_tensors
        return segment_sum_sorted(ct, idx, ctx.n_rows), None


def gather_zero_oob(values: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """values[idx] with zero rows where idx >= len(values); ``idx``
    ascending (its backward rides the sorted kernel)."""
    return GatherZeroOOB.apply(values, idx)


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


class PermuteRows(torch.autograd.Function):
    """values[perm]; the backward gathers by the inverse permutation."""

    @staticmethod
    def forward(ctx, values, perm, inv):
        ctx.save_for_backward(perm, inv)
        return values[perm.long()]

    @staticmethod
    def backward(ctx, ct):
        perm, inv = ctx.saved_tensors
        return PermuteRows.apply(ct, inv, perm), None, None


def scatter_rows(values: torch.Tensor, idx: torch.Tensor, n_rows: int,
                 perm: torch.Tensor, inv: torch.Tensor) -> torch.Tensor:
    """``out[idx[e]] += values[e]`` for unsorted ``idx``, given ``perm``
    with idx[perm] ascending and its inverse ``inv``: the sum runs on the
    sorted kernel."""
    return segment_sum_sorted(PermuteRows.apply(values, perm, inv),
                              idx[perm.long()], n_rows)


def inverse_perm(perm: torch.Tensor) -> torch.Tensor:
    """inv with inv[perm[i]] = i (a permutation: no two writes collide)."""
    inv = torch.empty_like(perm)
    inv[perm.long()] = torch.arange(perm.shape[0], dtype=perm.dtype,
                                    device=perm.device)
    return inv


def sort_perm(idx: torch.Tensor):
    """(perm, inv): the stable ascending sort of ``idx`` on its device and
    the inverse permutation, both of ``idx``'s dtype."""
    perm = torch.sort(idx, stable=True).indices.to(idx.dtype)
    return perm, inverse_perm(perm)


def aggregate_messages(msg: torch.Tensor, dst: torch.Tensor, n_node: int,
                       sorted_dst: bool, perm: Optional[torch.Tensor] = None,
                       inv: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``out[n] = sum_{e: dst[e]=n} msg[e]``, dst >= n_node dropped.  For
    an unsorted ``dst``, ``perm`` / ``inv`` may carry its stable sort and
    inverse (``sort_perm``) so that a caller sorts once for many calls."""
    if sorted_dst:
        return segment_sum_sorted(msg, dst, n_node)
    if perm is None:
        perm, inv = sort_perm(dst)
    return scatter_rows(msg, dst, n_node, perm, inv)


class GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, idx, perm, inv):
        ctx.save_for_backward(idx, perm, inv)
        ctx.n_rows = x.shape[0]
        return x[idx.clamp(max=x.shape[0] - 1).long()]

    @staticmethod
    def backward(ctx, ct):
        idx, perm, inv = ctx.saved_tensors
        return (scatter_rows(ct, idx, ctx.n_rows, perm, inv),
                None, None, None)


def gather_rows(x: torch.Tensor, idx: torch.Tensor,
                perm: Optional[torch.Tensor] = None,
                inv: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``x[idx]`` (out-of-range idx clamps to the last row); ``perm``
    sorts ``idx`` stably and ``inv`` inverts it (built here when not
    given), so the backward drops out-of-range cotangents and rides the
    kernel."""
    if perm is None:
        perm, inv = sort_perm(idx)
    elif inv is None:
        inv = inverse_perm(perm)
    return GatherRows.apply(x, idx, perm, inv)


def segment_softmax(logits: torch.Tensor, dst: torch.Tensor,
                    n_rows: int) -> torch.Tensor:
    """Softmax of ``logits`` [E, H] over the edges of each destination
    (ascending ``dst``; the sentinel rows >= n_rows read 0), shifted by the
    detached per-destination maximum, 1e-16 added to each sum
    (torch_geometric's softmax)."""
    idx = dst.clamp(max=n_rows).long()[:, None].expand_as(logits)
    top = logits.new_full((n_rows + 1, logits.shape[1]), -torch.inf)
    top = top.scatter_reduce(0, idx, logits.detach(), 'amax')
    ex = torch.exp(logits - top.gather(0, idx))
    total = segment_sum_sorted(ex, dst, n_rows)
    return ex / (gather_zero_oob(total, dst) + 1e-16) \
        * (dst < n_rows).to(logits.dtype)[:, None]
