"""The per-edge quadrilinear family on the card: ``csrc/cg_quad.cu``.

Port of ``sevennet_finetuning_tpu/ops/fused_conv_kernel.py`` (one Pallas
kernel per mode of ``ops.fused_conv``: msg / x / sh / w over edge tiles).
Here one CUDA kernel serves all four modes: the host builds each mode's
term table (``cg_tables.quad_table``) and the kernel walks it for a tile
of staged edges.

- ``quad_cuda``: the kernel on edge-major ``[E, dim]`` float32 legs in
  ``_MODE_LEGS[mode]`` order; counts its launches in
  ``_cuda.LAUNCHES['cg_quad']`` and, per mode, in ``MODE_LAUNCHES``.
- ``quad_plain``: the plain PyTorch version (``cg_modes``).
- ``quad``: the kernel for CUDA tensors, the plain version for CPU
  tensors; ``fused_conv.CGQuad`` calls it.
"""

from __future__ import annotations

from collections import Counter

import torch

from . import _cuda
from .cg_tables import on_device, quad_table
from .fused_conv import _MODE_LEGS, _MODE_OUT, CGLayout, cg_modes

# launches of the kernel per mode (the wrapper adds to it where it adds
# to _cuda.LAUNCHES['cg_quad'])
MODE_LAUNCHES: Counter = Counter()
# edges staged per block: at most the kernel's register sums per item
MAX_TILE = 8


def quad_plain(mode: str, a, b, c, layout: CGLayout) -> torch.Tensor:
    return cg_modes(mode, a, b, c, layout)


def quad_tile_edges(layout: CGLayout, mode: str) -> int:
    """Edges per block: as many rows (three legs and the sh mode's
    partial sums) as fit in 96 KB, so two blocks share an SM."""
    row = (sum(layout.mode_dims[leg] for leg in _MODE_LEGS[mode])
           + quad_table(layout, mode).n_part)
    return max(1, min(MAX_TILE, (96 * 1024 // 4) // row))


def quad_cuda(mode: str, a, b, c, layout: CGLayout) -> torch.Tensor:
    """The CUDA kernel: a, b, c [E, dim] f32 -> [E, out_dim]."""
    E = a.shape[0]
    dims = layout.mode_dims
    legs = _MODE_LEGS[mode]
    for leg, t in zip(legs, (a, b, c)):
        _cuda.require(t, leg, torch.float32, (E, dims[leg]))
    tab = quad_table(layout, mode)
    item_start, item_out, terms, red_start, red_out = on_device(
        ('quad', layout, mode),
        (tab.item_start, tab.item_out, tab.terms, tab.red_start,
         tab.red_out), a.device)
    d_out = dims[_MODE_OUT[mode]]
    out = torch.empty((E, d_out), dtype=a.dtype, device=a.device)
    fn = _cuda.kernel('cg_quad')
    _cuda.LAUNCHES['cg_quad'] += 1
    MODE_LAUNCHES[mode] += 1
    _cuda.check('cg_quad', fn(
        a.data_ptr(), b.data_ptr(), c.data_ptr(), *(dims[leg] for leg in legs),
        item_start.data_ptr(), item_out.data_ptr(), terms.data_ptr(),
        len(tab.item_out), red_start.data_ptr(), red_out.data_ptr(),
        len(tab.red_start) - 1, tab.n_part, out.data_ptr(), d_out, E,
        quad_tile_edges(layout, mode), _cuda.stream_ptr(a.device)))
    return out


def quad(mode: str, a, b, c, layout: CGLayout) -> torch.Tensor:
    if a.is_cuda:
        return quad_cuda(mode, a.contiguous(), b.contiguous(),
                         c.contiguous(), layout)
    return quad_plain(mode, a, b, c, layout)
