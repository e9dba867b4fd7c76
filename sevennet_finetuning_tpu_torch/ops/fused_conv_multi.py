"""Fused multi-mode backward of the cg_node family (first order).

Port of the first-order part of ``sevennet_finetuning_tpu/ops/
fused_conv_multi.py``: ``cg_node_multi`` computes several of the edge
cotangents xn / shn / wn over one shared (ybar, x, sh, w, dst), so the
node cotangent g = ybar[dst[e]] is fetched once for all of them.  On CUDA
tensors it is the kernel ``csrc/cg_multi.cu``; on CPU tensors, one plain
single-mode evaluation per job.

``CGNodeMulti``'s own backward (the double backward of the convolution,
which training needs) belongs to the training slice of the port.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

from . import _cuda
from .cg_tables import multi_table, on_device
from .fused_conv import CGLayout
from .fused_conv_agg import node_mode_plain

_JOB_LEGS = {'xn': ('sh', 'w'), 'shn': ('x', 'w'), 'wn': ('x', 'sh')}

# edges per block of the multi kernel (consecutive, so they mostly share
# one destination node and its staged ybar row)
EDGES_PER_BLOCK = 16


def multi_plain(ybar, x, sh, w, dst, jobs: Sequence[str],
                layout: CGLayout, n_node: int):
    legs = {'x': x, 'sh': sh, 'w': w}
    return tuple(
        node_mode_plain(j, ybar, *(legs[l] for l in _JOB_LEGS[j]), dst,
                        layout, n_node)
        for j in jobs)


def multi_cuda(ybar, x, sh, w, dst, jobs: Tuple[str, ...],
               layout: CGLayout, n_node: int):
    """The CUDA kernel: ybar [n_node, dim_msg], edge legs [E, dim] f32,
    dst [E] int32 ascending -> one [E, dim] array per job."""
    E = dst.shape[0]
    _cuda.require(ybar, 'ybar', torch.float32, (n_node, layout.dim_msg))
    _cuda.require(x, 'x', torch.float32, (E, layout.dim_x))
    _cuda.require(sh, 'sh', torch.float32, (E, layout.dim_sh))
    _cuda.require(w, 'w', torch.float32, (E, layout.dim_w))
    _cuda.require(dst, 'dst', torch.int32, (E,))
    tab = multi_table(layout, jobs)
    item_start, item_out, terms, red_start, red_out = on_device(
        ('multi', layout, jobs),
        (tab.item_start, tab.item_out, tab.terms, tab.red_start,
         tab.red_out), x.device)
    outs = [torch.empty((E, d), dtype=x.dtype, device=x.device)
            for d in tab.out_dims]
    ptrs = [o.data_ptr() for o in outs] + [0] * (3 - len(outs))
    dims = list(tab.out_dims) + [0] * (3 - len(outs))
    fn = _cuda.kernel('cg_multi')
    _cuda.LAUNCHES['cg_multi'] += 1
    _cuda.check('cg_multi', fn(
        ybar.data_ptr(), x.data_ptr(), sh.data_ptr(), w.data_ptr(),
        dst.data_ptr(), item_start.data_ptr(), item_out.data_ptr(),
        terms.data_ptr(), len(tab.item_out), red_start.data_ptr(),
        red_out.data_ptr(), len(tab.red_start) - 1, tab.n_part,
        *ptrs, *dims, E, n_node, layout.dim_msg, layout.dim_x,
        layout.dim_sh, layout.dim_w, EDGES_PER_BLOCK,
        _cuda.stream_ptr(x.device)))
    return tuple(outs)


class CGNodeMulti(torch.autograd.Function):
    @staticmethod
    def forward(ctx, ybar, x, sh, w, dst, jobs, layout, n_node):
        if ybar.is_cuda:
            return multi_cuda(ybar.contiguous(), x.contiguous(),
                              sh.contiguous(), w.contiguous(),
                              dst.contiguous(), jobs, layout, n_node)
        return multi_plain(ybar, x, sh, w, dst, jobs, layout, n_node)

    @staticmethod
    def backward(ctx, *cts):
        raise NotImplementedError(
            'the backward of cg_node_multi (the double backward of the '
            'convolution) belongs to the training slice of the port')


def cg_node_multi(ybar, x, sh, w, dst, *, jobs, layout: CGLayout,
                  n_node: int):
    """Several backward modes from ('xn', 'shn', 'wn') at once; returns
    one edge-major array per job."""
    jobs = tuple(jobs)
    assert jobs and all(j in _JOB_LEGS for j in jobs), jobs
    return CGNodeMulti.apply(ybar, x, sh, w, dst, jobs, layout, n_node)
