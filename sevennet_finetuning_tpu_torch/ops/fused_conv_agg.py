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
tensors; the kernel's plan and launch are ``cg_tables.agg_plan`` and
``agg_config``), and its backward asks ``CGNodeMulti``
(ops/fused_conv_multi.py)
for exactly the edge cotangents autograd needs -- the transpose of the
JAX package's ``cg_node_linsum``.  Edge legs are edge-major [E, dim];
``dst`` is ascending with padded edges at the sentinel n_node, whose
cotangent g is 0.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Dict, Optional

import torch

from .. import tracing
from . import _cuda
from .cg_tables import AGG_SMEM_MAX, AggConfig, agg_plan, agg_smem
from .fused_conv import CGLayout, ConvFamily, cg_modes, conv_messages
from .mlp import mlp_apply
from .scatter import (aggregate_messages, gather_rows, gather_zero_oob,
                      segment_sum_plain)

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


# cg_agg.cu's launch, measured at SevenNet-0's layouts (tools/agg_sweep.py:
# every tile, stage count, node count and warp count that fits, by device
# time): layouts of many units (30 at the interior block) run fastest with
# one node and 16 warps a block and tiles of 6 edges in 2 stages (92 KB,
# two blocks an SM); layouts of few (12 and 7 at blocks 0 and 4) with 2
# nodes, 8 warps and tiles of 12 (61-72 KB).  More stages never paid: the
# arithmetic, not the copies, sets the time
AGG_FEW_UNITS = 16
AGG_FEW = AggConfig(tile=12, stages=2, nodes=2, warps=8)
AGG_MANY = AggConfig(tile=6, stages=2, nodes=1, warps=16)


@functools.lru_cache(maxsize=None)
def agg_config(layout: CGLayout) -> AggConfig:
    """The launch of cg_agg.cu at a layout: ``AGG_FEW`` where a node has
    fewer than ``AGG_FEW_UNITS`` units, else ``AGG_MANY``; the tile halves
    until the block fits the card's shared memory."""
    n_unit = len(agg_plan(layout, 1, 1).items)
    cfg = AGG_FEW if n_unit < AGG_FEW_UNITS else AGG_MANY
    b_row = agg_plan(layout, cfg.nodes, cfg.warps).b_row
    while agg_smem(layout, cfg, b_row).nbytes > AGG_SMEM_MAX:
        if cfg.tile == 1:
            raise ValueError('cg_agg: a tile of one edge does not fit')
        cfg = dataclasses.replace(cfg, tile=cfg.tile // 2)
    return cfg


# per (layout object, cfg, device): the layout, the plan on the device and
# the launch's host arrays; keyed by the layout's id, so a call hashes no
# layout (a SevenNet-0 layout takes ~15 us to hash)
_LAUNCH: Dict[tuple, tuple] = {}


def _agg_launch(layout: CGLayout, cfg: Optional[AggConfig],
                device: torch.device):
    key = (id(layout), cfg, device)
    hit = _LAUNCH.get(key)
    if hit is not None and hit[0] is layout:
        return hit[1:]
    use = cfg or agg_config(layout)
    plan = agg_plan(layout, use.nodes, use.warps)
    flat, meta = plan.packed()
    sm = agg_smem(layout, use, plan.b_row)
    _LAUNCH[key] = (layout, torch.as_tensor(flat).to(device), (
        _cuda.host_ints(meta),
        _cuda.host_ints((use.tile, use.stages, use.nodes, use.warps)),
        _cuda.host_ints((sm.x_cap, sm.sh_cap, sm.stage, sm.b_base,
                         sm.acc_base, plan.b_row, sm.total))))
    return _LAUNCH[key][1:]


def agg_cuda(x, sh, w, dst, layout: CGLayout, n_node: int,
             cfg: Optional[AggConfig] = None):
    """The CUDA kernel: x [E, dim_x], sh [E, dim_sh], w [E, dim_w] f32
    (stride layout), dst [E] int32 ascending -> [n_node, dim_msg];
    ``cfg`` overrides ``agg_config`` (tools/agg_sweep.py)."""
    E = dst.shape[0]
    _cuda.require(x, 'x', torch.float32, (E, layout.dim_x))
    _cuda.require(sh, 'sh', torch.float32, (E, layout.dim_sh))
    _cuda.require(w, 'w', torch.float32, (E, layout.dim_w))
    _cuda.require(dst, 'dst', torch.int32, (E,))
    plan, c_args = _agg_launch(layout, cfg, x.device)
    x, sh, w = (_cuda.aligned16(t) for t in (x, sh, w))
    # the kernel writes the node ranges (row_offsets' values) here itself
    offs = torch.empty(n_node + 1, dtype=torch.int32, device=x.device)
    out = torch.empty((n_node, layout.dim_msg), dtype=x.dtype,
                      device=x.device)
    fn = _cuda.kernel('cg_agg')
    if n_node:
        _cuda.LAUNCHES['cg_agg'] += 1
    _cuda.check('cg_agg', fn(
        x.data_ptr(), sh.data_ptr(), w.data_ptr(), dst.data_ptr(),
        offs.data_ptr(), plan.data_ptr(), *c_args, out.data_ptr(), E,
        n_node, layout.dim_x, layout.dim_sh, layout.dim_w, layout.dim_msg,
        _cuda.stream_ptr(x.device)))
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


def convolve(conv: ConvFamily, mlp_w, parts, n_node: int, denominator):
    """A block's convolution -> [N, dim_out] e3nn features.  ``parts``
    yields each edge partition as (source rows [N_src, dim_x], stride
    layout; edges: ``src``, ``dst``, ``emb``, ``sh``, the source sort
    ``perm`` / ``inv``, ``dst_sort``).  Per partition the radial weights,
    the source gather, ``conv_aggregate`` on ascending dst (``dst_sort``
    absent or None), else ``conv_messages`` and the sorted segment sum
    over ``dst_sort`` ((None, None): sorted here), and the family's map to
    e3nn; then their sum over ``denominator``, in the family's span
    (``edges``: every partition's)."""
    name, attrs = conv.span or (None, None)
    with (tracing.span(name, **attrs) if name else tracing.OFF) as sp:
        w_mlp = conv.weights(mlp_w)
        out, n_edge = None, 0
        for rows, e in parts:
            # gather_rows' backward drops padded-edge cotangents; exact
            # because the edge mask zeroes the radial embedding, so padded
            # messages and their gradients are identically zero
            w = mlp_apply(w_mlp, e['emb'], conv.act_radial)
            x_src = gather_rows(rows, e['src'], e['perm'], e['inv'])
            if e.get('dst_sort') is None:
                # the [E, dim_msg] message tensor never exists
                agg = conv_aggregate(conv.layout, x_src, e['sh'], w,
                                     e['dst'], n_node)
            else:
                agg = aggregate_messages(
                    conv_messages(conv.layout, x_src, e['sh'], w), e['dst'],
                    n_node, False, *e['dst_sort'])
            y = conv.to_e3nn(agg)
            out = y if out is None else out + y
            n_edge += e['src'].shape[0]
        sp.set(edges=n_edge)
        return out / denominator
