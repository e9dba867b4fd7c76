"""Scatter-fused convolution: messages + aggregation in one kernel.

Port of ``sevennet_finetuning_tpu/ops/fused_conv_agg.py``.  Composing the
dst-sorted segment sum into the quadrilinear scalar form

    S = sum_e C . x[e] . sh[e] . w[e] . ybar[dst[e]]

gives the ``cg_node`` modes:

    'agg' = dS/dybar : (x, sh, w)    -> [N, dim_msg]   (forward)
    'xn'  = dS/dx    : (ybar, sh, w) -> [E, dim_x]
    'shn' = dS/dsh   : (ybar, x, w)  -> [E, dim_sh]
    'wn'  = dS/dw    : (ybar, x, sh) -> [E, dim_w]

``CGNodeAgg`` is 'agg' as an autograd Function: its forward is the CUDA
kernel ``csrc/cg_agg.cu`` on CUDA tensors (the plain version on CPU
tensors), and its backward asks ``CGNodeMulti`` (ops/fused_conv_multi.py)
for exactly the edge cotangents autograd needs -- the transpose of the
JAX package's ``cg_node_linsum``.  Edge legs are edge-major [E, dim];
``dst`` is ascending with padded edges at the sentinel n_node, whose
cotangent g is 0.
"""

from __future__ import annotations

import torch

from . import _cuda
from .cg_tables import agg_table, on_device
from .fused_conv import CGLayout, cg_modes
from .scatter import gather_zero_oob, row_offsets, segment_sum_plain

_EDGE_JOBS = ('xn', 'shn', 'wn')
_EMIT = {'xn': 'x', 'shn': 'sh', 'wn': 'w'}


def agg_plain(x, sh, w, dst, layout: CGLayout, n_node: int):
    """Plain PyTorch 'agg': per-edge messages, then the segment sum (a
    port of the JAX package's XLA composition)."""
    return segment_sum_plain(cg_modes('msg', x, sh, w, layout), dst, n_node)


def node_mode_plain(mode: str, ybar, b, c, dst, layout: CGLayout,
                    n_node: int):
    """Plain PyTorch 'xn' (b, c = sh, w), 'shn' (x, w) or 'wn' (x, sh):
    gather g = ybar[dst] (0 at the sentinel), then the per-edge mode."""
    g = gather_zero_oob(ybar, dst)
    return cg_modes(_EMIT[mode], g, b, c, layout)


def agg_tile_edges(layout: CGLayout) -> int:
    """Edges staged per tile: as many x/sh/w rows as fit in 48 KB."""
    row = layout.dim_x + layout.dim_sh + layout.dim_w
    return max(1, min(32, (48 * 1024 // 4) // row))


def agg_cuda(x, sh, w, dst, layout: CGLayout, n_node: int):
    """The CUDA kernel: x [E, dim_x], sh [E, dim_sh], w [E, dim_w] f32
    (stride layout), dst [E] int32 ascending -> [n_node, dim_msg]."""
    E = dst.shape[0]
    _cuda.require(x, 'x', torch.float32, (E, layout.dim_x))
    _cuda.require(sh, 'sh', torch.float32, (E, layout.dim_sh))
    _cuda.require(w, 'w', torch.float32, (E, layout.dim_w))
    _cuda.require(dst, 'dst', torch.int32, (E,))
    col_start, terms = on_device(('agg', layout), agg_table(layout),
                                 x.device)
    offs = row_offsets(dst, n_node)
    out = torch.empty((n_node, layout.dim_msg), dtype=x.dtype,
                      device=x.device)
    fn = _cuda.kernel('cg_agg')
    _cuda.LAUNCHES['cg_agg'] += 1
    _cuda.check('cg_agg', fn(
        x.data_ptr(), sh.data_ptr(), w.data_ptr(), offs.data_ptr(),
        col_start.data_ptr(), terms.data_ptr(), out.data_ptr(), n_node,
        layout.dim_x, layout.dim_sh, layout.dim_w, layout.dim_msg,
        agg_tile_edges(layout), _cuda.stream_ptr(x.device)))
    return out


def _agg(x, sh, w, dst, layout, n_node):
    if x.is_cuda:
        return agg_cuda(x.contiguous(), sh.contiguous(), w.contiguous(),
                        dst.contiguous(), layout, n_node)
    return agg_plain(x, sh, w, dst, layout, n_node)


class CGNodeAgg(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, sh, w, dst, layout, n_node):
        ctx.save_for_backward(x, sh, w, dst)
        ctx.layout = layout
        ctx.n_node = n_node
        return _agg(x, sh, w, dst, layout, n_node)

    @staticmethod
    def backward(ctx, ybar):
        from .fused_conv_multi import cg_node_multi

        x, sh, w, dst = ctx.saved_tensors
        jobs = tuple(j for j, need in zip(_EDGE_JOBS,
                                          ctx.needs_input_grad[:3])
                     if need)
        grads = dict.fromkeys(_EDGE_JOBS)
        if jobs:
            outs = cg_node_multi(ybar, x, sh, w, dst, jobs=jobs,
                                 layout=ctx.layout, n_node=ctx.n_node)
            grads.update(zip(jobs, outs))
        return grads['xn'], grads['shn'], grads['wn'], None, None, None


def conv_aggregate(layout: CGLayout, x_src, sh, w, dst, n_node: int):
    """Fused convolution: [N, dim_msg] aggregated messages."""
    return CGNodeAgg.apply(x_src, sh, w, dst, layout, n_node)
