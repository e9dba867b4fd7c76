"""Fused uvu CG tensor-product convolution: static layout + plain math.

Port of the layout half of ``sevennet_finetuning_tpu/ops/fused_conv.py``.
The convolution message function is, per edge ``e``,

    msg[e, (k,kappa,u)] = sum_{i,j} C[i,j,k] * x[e, (i1,i,u)]
                          * sh[e, (i2,j)] * w[e, (path,u)]

-- trilinear in (x, sh, w).  With a cotangent ``g`` the scalar
S = sum_e <msg(x, sh, w)[e], g[e]> is quadrilinear, and its four partial
contractions are the modes:

    'msg' = dS/dg  : (x, sh, w) -> [E, dim_msg]
    'x'   = dS/dx  : (g, sh, w) -> [E, dim_x]
    'sh'  = dS/dsh : (g, x, w)  -> [E, dim_sh]
    'w'   = dS/dw  : (g, x, sh) -> [E, dim_w]

Layout: within the feature axis, irrep chunks use the STRIDE layout
``[d, mul]`` (i-major, multiplicity fastest), not e3nn's ``[mul, d]``;
``stride_to_e3nn`` converts at the node-sized boundaries.  ``w`` keeps the
flat per-instruction layout (offset = TPInstruction.weight_offset).

``cg_modes`` is the plain PyTorch version of the four modes, a port of
the JAX package's XLA composition (``_xla_impl``), edge-major.  It is the
CPU path and the reference the CUDA kernels are held against; the
kernels themselves read the term tables of ``ops/cg_tables.py``.

``CGQuad`` is the family as an autograd Function (the JAX primitive
``cg_quadlinear`` with its ``_transpose``): its forward is one mode, the
CUDA kernel ``csrc/cg_quad.cu`` on CUDA tensors and ``cg_modes`` on CPU
tensors (``ops/fused_conv_kernel.py``), and its backward gives each input
that needs a gradient the mode of that input's leg, with the cotangent
standing in for the output leg -- by calling ``CGQuad`` again, so the
family is closed under autograd to any order.  ``cg_apply`` and
``conv_messages_T`` keep the JAX package's feature-major ``[dim, E]``
layout; ``cg_apply_edge`` and ``conv_messages`` are the edge-major
``[E, dim]`` entries the model and the kernel use.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from ..irreps import Irreps
from .wigner import wigner_3j


@dataclass(frozen=True)
class CGPath:
    """One uvu instruction: all nonzero CG couplings into one output
    irrep chunk, with its per-multiplicity weight slice."""

    msg_off: int            # offset of the [d_out, mul] chunk in msg
    d_out: int
    w_off: int              # offset of the [mul] weight slice in w
    # (k, i, j, c): msg[k] += c * x[i] * sh[j] * w  (c = coeff * w3j)
    nnz: Tuple[Tuple[int, int, int, float], ...]


@dataclass(frozen=True)
class CGGroup:
    """All paths sharing one (input-irrep, filter-irrep) pair."""

    x_off: int              # offset of the [d1, mul] chunk in x
    d1: int
    mul: int
    sh_off: int             # offset of the [d2] chunk in sh
    d2: int
    paths: Tuple[CGPath, ...]


@dataclass(frozen=True)
class CGLayout:
    dim_x: int
    dim_sh: int
    dim_w: int
    dim_msg: int
    groups: Tuple[CGGroup, ...]

    @property
    def mode_dims(self) -> Dict[str, int]:
        return {'g': self.dim_msg, 'x': self.dim_x,
                'sh': self.dim_sh, 'w': self.dim_w}


@functools.lru_cache(maxsize=None)
def layout_from_spec(spec) -> CGLayout:
    """Build the static CG layout from a uvu TensorProductSpec.

    Stride-layout offsets coincide with the e3nn flat offsets (chunk
    sizes are equal; only the within-chunk order differs), so the spec's
    slices/weight offsets are reused as-is.
    """
    sl1 = spec.irreps_in1.slices()
    sl2 = spec.irreps_in2.slices()
    slo = spec.irreps_out.slices()
    groups: Dict[Tuple[int, int], list] = {}
    for ins in spec.instructions:
        if ins.mode != 'uvu':
            raise ValueError('fused conv covers uvu instructions only')
        if spec.irreps_in2[ins.i_in2].mul != 1:
            raise NotImplementedError('uvu with filter mul > 1')
        groups.setdefault((ins.i_in1, ins.i_in2), []).append(ins)
    out_groups = []
    for (i1, i2), inss in sorted(groups.items()):
        mi1 = spec.irreps_in1[i1]
        mi2 = spec.irreps_in2[i2]
        paths = []
        for ins in inss:
            mo = spec.irreps_out[ins.i_out]
            C = wigner_3j(mi1.ir.l, mi2.ir.l, mo.ir.l) * ins.coeff
            nnz = tuple(
                (int(k), int(i), int(j), float(C[i, j, k]))
                for i in range(mi1.ir.dim)
                for j in range(mi2.ir.dim)
                for k in range(mo.ir.dim)
                if abs(C[i, j, k]) > 1e-12
            )
            paths.append(CGPath(
                msg_off=slo[ins.i_out].start,
                d_out=mo.ir.dim,
                w_off=ins.weight_offset,
                nnz=nnz,
            ))
        out_groups.append(CGGroup(
            x_off=sl1[i1].start, d1=mi1.ir.dim, mul=mi1.mul,
            sh_off=sl2[i2].start, d2=mi2.ir.dim,
            paths=tuple(paths),
        ))
    return CGLayout(
        dim_x=spec.irreps_in1.dim,
        dim_sh=spec.irreps_in2.dim,
        dim_w=spec.weight_numel,
        dim_msg=spec.irreps_out.dim,
        groups=tuple(out_groups),
    )


@dataclass(frozen=True, eq=False)
class ConvFamily:
    """What a block family gives ``fused_conv_agg.convolve``: its coupling
    ``layout``, ``weights`` (radial MLP weights -> the MLP giving the
    layout's [E, dim_w]), ``to_e3nn`` (node sums [N, dim_msg] -> e3nn
    features) and ``span`` ((name, attributes) of its span, or None)."""

    layout: CGLayout
    act_radial: str
    weights: Callable
    to_e3nn: Callable
    span: Optional[Tuple[str, Dict]] = None


def _identity(v):
    return v


def cg_family(spec, act_radial: str) -> ConvFamily:
    """The CG convolution of a uvu TensorProductSpec: the MLP's weights as
    they are, the stride layout's permutation to e3nn's."""
    return ConvFamily(layout_from_spec(spec), act_radial, _identity,
                      functools.partial(stride_to_e3nn, spec.irreps_out))


# ---------------------------------------------------------------------------
# layout conversion (node-sized boundaries; cheap)
# ---------------------------------------------------------------------------

def stride_to_e3nn(irreps: Irreps, arr: torch.Tensor) -> torch.Tensor:
    """[..., dim] stride layout ([d, mul] per chunk) -> e3nn ([mul, d])."""
    out = []
    for mi, sl in zip(irreps, irreps.slices()):
        chunk = arr[..., sl].reshape(arr.shape[:-1] + (mi.ir.dim, mi.mul))
        out.append(chunk.transpose(-1, -2).reshape(
            arr.shape[:-1] + (mi.dim,)))
    return torch.cat(out, dim=-1)


def e3nn_to_stride(irreps: Irreps, arr: torch.Tensor) -> torch.Tensor:
    """[..., dim] e3nn layout -> stride layout (inverse of the above)."""
    out = []
    for mi, sl in zip(irreps, irreps.slices()):
        chunk = arr[..., sl].reshape(arr.shape[:-1] + (mi.mul, mi.ir.dim))
        out.append(chunk.transpose(-1, -2).reshape(
            arr.shape[:-1] + (mi.dim,)))
    return torch.cat(out, dim=-1)


# ---------------------------------------------------------------------------
# plain PyTorch modes (CPU path + kernel reference); edge-major [E, dim]
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _group_ccat(group: CGGroup) -> np.ndarray:
    """Dense [d1, d2, K] coefficient block, K = concat of path k axes, in
    float64: ``cg_modes`` casts it to its legs' dtype (float32 rounds
    each coefficient once, as the kernels' tables do)."""
    K = sum(p.d_out for p in group.paths)
    C = np.zeros((group.d1, group.d2, K), np.float64)
    k0 = 0
    for p in group.paths:
        for (k, i, j, c) in p.nnz:
            C[i, j, k0 + k] = c
        k0 += p.d_out
    return C


_MODE_OUT = {'msg': 'g', 'x': 'x', 'sh': 'sh', 'w': 'w'}


def cg_modes(mode: str, a, b, c, layout: CGLayout) -> torch.Tensor:
    """One mode of the quadrilinear family; args in the order
    msg: (x, sh, w), x: (g, sh, w), sh: (g, x, w), w: (g, x, sh)."""
    E = a.shape[0]
    if mode == 'msg':
        x, sh, w = a, b, c
    elif mode == 'x':
        g, sh, w = a, b, c
    elif mode == 'sh':
        g, x, w = a, b, c
    elif mode == 'w':
        g, x, sh = a, b, c
    else:
        raise ValueError(mode)

    out_dim = layout.mode_dims[_MODE_OUT[mode]]
    pieces = []  # (offset, [E, d]) pairs

    for grp in layout.groups:
        Ccat = torch.as_tensor(_group_ccat(grp), dtype=a.dtype,
                               device=a.device)
        mul = grp.mul
        if mode != 'sh':
            shg = sh[:, grp.sh_off:grp.sh_off + grp.d2]              # [E, d2]
        if mode in ('msg', 'w', 'sh'):
            xg = x[:, grp.x_off:grp.x_off + grp.d1 * mul]
            xg = xg.reshape(E, grp.d1, mul)                          # [E, i, u]
        if mode in ('x', 'sh', 'w'):
            gs, ws = [], []
            for p in grp.paths:
                gp = g[:, p.msg_off:p.msg_off + p.d_out * mul]
                gs.append(gp.reshape(E, p.d_out, mul))
                if mode != 'w':
                    ws.append(w[:, p.w_off:p.w_off + mul])
            gcat = torch.cat(gs, dim=1)                              # [E, K, u]

        if mode == 'msg':
            m0 = torch.einsum('eiu,ej,ijk->eku', xg, shg, Ccat)
            k0 = 0
            for p in grp.paths:
                wp = w[:, p.w_off:p.w_off + mul]                     # [E, u]
                mp = m0[:, k0:k0 + p.d_out] * wp[:, None]
                k0 += p.d_out
                pieces.append((p.msg_off, mp.reshape(E, p.d_out * mul)))
        elif mode in ('x', 'sh'):
            gw = gcat * torch.cat(
                [wp[:, None].expand(E, p.d_out, mul)
                 for p, wp in zip(grp.paths, ws)], dim=1)
            if mode == 'x':
                dx = torch.einsum('eku,ej,ijk->eiu', gw, shg, Ccat)
                pieces.append((grp.x_off, dx.reshape(E, grp.d1 * mul)))
            else:
                dsh = torch.einsum('eku,eiu,ijk->ej', gw, xg, Ccat)
                pieces.append((grp.sh_off, dsh))
        else:  # 'w'
            m0 = torch.einsum('eiu,ej,ijk->eku', xg, shg, Ccat)
            k0 = 0
            for p in grp.paths:
                dw = torch.einsum('eku,eku->eu', m0[:, k0:k0 + p.d_out],
                                  gcat[:, k0:k0 + p.d_out])
                k0 += p.d_out
                pieces.append((p.w_off, dw))

    # assemble output by offsets (accumulating overlaps -- the sh mode
    # writes the same [d2] chunk once per group sharing that filter)
    acc: Dict[int, torch.Tensor] = {}
    for off, arr in pieces:
        acc[off] = acc[off] + arr if off in acc else arr
    parts = []
    pos = 0
    for off in sorted(acc):
        if off > pos:
            parts.append(a.new_zeros((E, off - pos)))
        elif off < pos:
            raise AssertionError('overlapping CG layout chunks')
        parts.append(acc[off])
        pos = off + acc[off].shape[1]
    if pos < out_dim:
        parts.append(a.new_zeros((E, out_dim - pos)))
    return torch.cat(parts, dim=1)


# ---------------------------------------------------------------------------
# the family as an autograd Function
# ---------------------------------------------------------------------------

# each mode outputs one leg of S and consumes the other three in this order
_MODE_LEGS = {
    'msg': ('x', 'sh', 'w'),
    'x': ('g', 'sh', 'w'),
    'sh': ('g', 'x', 'w'),
    'w': ('g', 'x', 'sh'),
}
_LEG_MODE = {'g': 'msg', 'x': 'x', 'sh': 'sh', 'w': 'w'}


class CGQuad(torch.autograd.Function):
    """One mode of the family, edge-major; ``a, b, c`` follow
    ``_MODE_LEGS[mode]``."""

    @staticmethod
    def forward(ctx, mode, layout, a, b, c):
        from .fused_conv_kernel import quad

        ctx.set_materialize_grads(False)
        ctx.save_for_backward(a, b, c)
        ctx.mode, ctx.layout = mode, layout
        return quad(mode, a, b, c, layout)

    @staticmethod
    def backward(ctx, ct):
        """_transpose: input leg l gets mode _LEG_MODE[l] of the other two
        inputs and the cotangent (at this mode's output leg)."""
        if ct is None:
            return (None,) * 5
        legs = _MODE_LEGS[ctx.mode]
        known = dict(zip(legs, ctx.saved_tensors))
        known[_MODE_OUT[ctx.mode]] = ct
        grads = []
        for leg, need in zip(legs, ctx.needs_input_grad[2:]):
            mode = _LEG_MODE[leg]
            grads.append(CGQuad.apply(mode, ctx.layout, *(
                known[l] for l in _MODE_LEGS[mode])) if need else None)
        return (None, None, *grads)


def cg_apply_edge(mode: str, a, b, c, layout: CGLayout) -> torch.Tensor:
    """One mode of the family on edge-major ``[E, dim]`` legs (in the
    order of ``_MODE_LEGS[mode]``) -> ``[E, out_dim]``."""
    dims = layout.mode_dims
    want = [dims[leg] for leg in _MODE_LEGS[mode]]
    E = a.shape[0]
    if ([v.shape[1] for v in (a, b, c)] != want
            or any(v.ndim != 2 or v.shape[0] != E for v in (a, b, c))):
        raise ValueError(f'cg_quadlinear[{mode}]: arg shapes '
                         f'{[tuple(v.shape) for v in (a, b, c)]} do not '
                         f'match E x layout dims {want}')
    return CGQuad.apply(mode, layout, a, b, c)


def cg_apply(mode: str, a, b, c, layout: CGLayout) -> torch.Tensor:
    """JAX ``cg_apply``: legs feature-major ``[dim, E]`` -> ``[out_dim, E]``."""
    return cg_apply_edge(mode, a.T, b.T, c.T, layout).T


def conv_messages(layout: CGLayout, x_src, sh, w) -> torch.Tensor:
    """Per-edge messages ``[E, dim_msg]`` from edge-major stride-layout
    legs (the model's entry: no transposes)."""
    return cg_apply_edge('msg', x_src, sh, w, layout)


def conv_messages_T(layout: CGLayout, x_src_T, sh_T, w_T) -> torch.Tensor:
    """JAX ``conv_messages_T``: msg_T ``[dim_msg, E]`` from feature-major
    legs."""
    return cg_apply('msg', x_src_T, sh_T, w_T, layout)
