"""The per-edge quadrilinear family on the card: ``csrc/cg_quad.cu``.

Port of ``sevennet_finetuning_tpu/ops/fused_conv_kernel.py`` (one Pallas
kernel per mode of ``ops.fused_conv``: msg / x / sh / w over edge tiles).
Here one CUDA source serves all four modes, a kernel template per mode:
a persistent grid walks the edge tiles through a ring of bulk copies, a
lane is one channel, and each path's couplings are listed once
(``cg_tables.quad_plan`` / ``quad_smem``; the launch is ``quad_config``).

- ``quad_cuda``: the kernel on edge-major ``[E, dim]`` float32 legs in
  ``_MODE_LEGS[mode]`` order; counts its launches in
  ``_cuda.LAUNCHES['cg_quad']`` and, per mode, in ``MODE_LAUNCHES``.
- ``quad_plain``: the plain PyTorch version (``cg_modes``).
- ``quad``: the kernel for CUDA tensors, the plain version for CPU
  tensors; ``fused_conv.CGQuad`` calls it.
"""

from __future__ import annotations

import dataclasses
import functools
from collections import Counter
from typing import Dict, Optional

import torch

from . import _cuda
from .cg_tables import (QUAD_MODES, QUAD_SMEM_MAX, QuadConfig,
                        quad_max_dim, quad_plan, quad_smem)
from .fused_conv import _MODE_LEGS, _MODE_OUT, CGLayout, cg_modes

# launches of the kernel per mode (the wrapper adds to it where it adds
# to _cuda.LAUNCHES['cg_quad'])
MODE_LAUNCHES: Counter = Counter()

# cg_quad.cu's launch per mode, measured on an H100 at SevenNet-0's
# layouts (tools/quad_sweep.py: every tile, stage count and warp count
# that fits, by time): two stages always ran fastest (small blocks,
# several an SM); the fastest tiles held about QUAD_RULE[mode][0] bytes
# of leg rows a stage, with QUAD_RULE[mode][1] warps a block.  The msg, x
# and w modes run at the card's copy rate; sh, the latency-bound one,
# takes tiles of one edge at the interior block (edge pairs there would
# halve the blocks an SM holds), whose 21 items keep
# QUAD_SH_ONE_EDGE_WARPS warps busy (0.391 against 0.434 ms with 8), and
# tiles of 4-8 edges at blocks 0 and 4
QUAD_STAGES = 2
QUAD_RULE = {'msg': (20 * 1024, 16), 'x': (20 * 1024, 8),
             'sh': (32 * 1024, 8), 'w': (36 * 1024, 16)}
QUAD_SH_ONE_EDGE_WARPS = 4


def quad_plain(mode: str, a, b, c, layout: CGLayout) -> torch.Tensor:
    return cg_modes(mode, a, b, c, layout)


def edge_bytes(layout: CGLayout, mode: str) -> int:
    """Bytes of one edge's rows of the mode's three legs."""
    return 4 * sum(layout.mode_dims[leg] for leg in _MODE_LEGS[mode])


@functools.lru_cache(maxsize=None)
def quad_config(layout: CGLayout, mode: str) -> QuadConfig:
    """The launch of cg_quad.cu at a layout and mode: tiles of as many
    edges as fill the mode's stage bytes (``QUAD_RULE``; at least one),
    ``QUAD_STAGES`` stages, the mode's warps (``QUAD_SH_ONE_EDGE_WARPS``
    for sh tiles of one edge); the tile shrinks until the block fits the
    card's shared memory."""
    stage_bytes, warps = QUAD_RULE[mode]
    tile = max(1, stage_bytes // edge_bytes(layout, mode))
    if mode == 'sh' and tile == 1:
        warps = QUAD_SH_ONE_EDGE_WARPS
    cfg = QuadConfig(tile=tile, stages=QUAD_STAGES, warps=warps)
    while quad_smem(layout, mode, cfg, quad_plan(
            layout, mode, cfg.tile, cfg.warps)).nbytes > QUAD_SMEM_MAX:
        if cfg.tile == 1:
            raise ValueError(f'cg_quad {mode}: a tile of one edge does not '
                             'fit')
        cfg = dataclasses.replace(cfg, tile=cfg.tile // 2)
    return cfg


# per (layout object, mode, cfg, device): the layout, the plan on the
# device and the launch's host arrays; keyed by the layout's id, so a
# call hashes no layout
_LAUNCH: Dict[tuple, tuple] = {}


def _quad_launch(layout: CGLayout, mode: str, cfg: Optional[QuadConfig],
                 device: torch.device):
    key = (id(layout), mode, cfg, device)
    hit = _LAUNCH.get(key)
    if hit is not None and hit[0] is layout:
        return hit[1:]
    use = cfg or quad_config(layout, mode)
    plan = quad_plan(layout, mode, use.tile, use.warps)
    flat, meta = plan.packed()
    sm = quad_smem(layout, mode, use, plan)
    _LAUNCH[key] = (layout, torch.as_tensor(flat).to(device), (
        _cuda.host_ints(meta),
        _cuda.host_ints((use.tile, use.stages, use.warps,
                         quad_max_dim(layout))),
        _cuda.host_ints((*sm.caps, sm.stage, sm.b_base, sm.red_base,
                         plan.b_row, sm.red_row, sm.coef_base, sm.total))))
    return _LAUNCH[key][1:]


def quad_cuda(mode: str, a, b, c, layout: CGLayout,
              cfg: Optional[QuadConfig] = None) -> torch.Tensor:
    """The CUDA kernel: a, b, c [E, dim] f32 -> [E, out_dim]; ``cfg``
    overrides ``quad_config`` (tools/quad_sweep.py)."""
    E = a.shape[0]
    dims = layout.mode_dims
    legs = _MODE_LEGS[mode]
    for leg, t in zip(legs, (a, b, c)):
        _cuda.require(t, leg, torch.float32, (E, dims[leg]))
    plan, c_args = _quad_launch(layout, mode, cfg, a.device)
    a, b, c = (_cuda.aligned16(t) for t in (a, b, c))
    d_out = dims[_MODE_OUT[mode]]
    out = torch.empty((E, d_out), dtype=a.dtype, device=a.device)
    fn = _cuda.kernel('cg_quad')
    if E:
        _cuda.LAUNCHES['cg_quad'] += 1
        MODE_LAUNCHES[mode] += 1
    _cuda.check('cg_quad', fn(
        QUAD_MODES.index(mode), a.data_ptr(), b.data_ptr(), c.data_ptr(),
        plan.data_ptr(), *c_args, out.data_ptr(), E,
        *(dims[leg] for leg in legs), d_out, _cuda.stream_ptr(a.device)))
    return out


def quad(mode: str, a, b, c, layout: CGLayout) -> torch.Tensor:
    if a.is_cuda:
        return quad_cuda(mode, a.contiguous(), b.contiguous(),
                         c.contiguous(), layout)
    return quad_plain(mode, a, b, c, layout)
