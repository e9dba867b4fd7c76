"""The 'equiformer_v2' family: EquiformerV2 (Liao, Wood, Das, Smidt,
arXiv:2306.12059) on the port's serving path.

``build_model_spec`` gives an ``EqV2Spec`` and ``build_model`` the
module ``EquiformerV2``, which holds the parameters under the groups of
``param_shapes`` and brings ``energy_network`` to ``apply_model``, so the
energy, the forces (-dE/dr through the edge vectors) and the virial take
the path of every family.  Node features x are [N, (lmax+1)^2, C]
real coefficients in e3nn's basis; edge j -> i carries a message to i.

- Embedding: x = the element embedding (by atomic number) in l = 0; each
  edge's 856 scalars are 600 Gaussians of its length on [0, cutoff] (the
  count fairchem's backbone builds, whatever ``num_distance_basis`` says)
  and a source and a target element embedding of 128 (a pair in each
  block and in the edge-degree embedding).  The edge-degree embedding: a
  radial MLP gives the m = 0 coefficients in the edge frame, rotated back
  and summed at i over the average degree.
- Each block: x += Attn(LN(x)), then x += FFN(LN(x)).  Attn: the source's
  and target's coefficients rotated into the edge frame (|m| <= mmax),
  times the radial weights, SO(2) convolution 1 (m = 0 also gives the
  attention logits and the gate scalars), the separable S2 activation,
  SO(2) convolution 2, each head times its softmax weight over the edges
  into i, rotated back, summed at i, an SO(3) linear.  FFN: SO(3) linear,
  three linears on the S2 grid with SiLU between them, l = 0 replaced by
  the scalar MLP of the input's scalars, SO(3) linear.
- Head: a final LN, the FFN to one scalar a node, summed and divided by
  the average node count.

LN is ``layer_norm_sh``: LayerNorm over the channels for l = 0; for l > 0
one root mean square over degrees weighted equally and channels, then an
affine weight a (l, channel).  The edge frame, the SO(2) maps and the grid
are ``ops/so2``.  Padded edges (mask 0) get a unit vector, so their frame
is finite; their sums drop at the sentinel destination.  Spans (``tracing``):
``eqv2.edge_embed`` (the frames, the Gaussians, the edge-degree
embedding), ``eqv2.attn`` and ``eqv2.ffn`` per block, ``eqv2.head``.
Training, TorchScript export and MD refuse the family at their entry
points (``Trainer``, ``init_params``, the exports: the spec is not a
``ModelSpec``; the device MD loops: ``max_neighbors``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .. import keys as K
from .. import tracing
from ..ops.radial import gaussian_basis
from ..ops.scatter import segment_softmax, segment_sum_sorted
from .nequip import EDGE_SRC_INV_PERM, apply_model
from ..ops.so2 import (degree_index, edge_rotation, grid_matrices, m_sizes,
                       node_grid_matrices, rescale_rows, rotate_back,
                       rotate_in, s2_act, so2_linear)


@dataclass(frozen=True)
class EqV2Spec:
    num_species: int = 0
    type_map: Tuple[Tuple[int, int], ...] = ()
    # each destination keeps its nearest sources within the cutoff
    max_neighbors: Optional[int] = None
    num_layers: int = 8
    lmax: int = 4
    mmax: int = 2
    channels: int = 128
    num_heads: int = 8
    attn_hidden: int = 64
    attn_alpha: int = 64
    attn_value: int = 16
    ffn_hidden: int = 128
    edge_channels: int = 128
    # fairchem's GaussianSmearing(0, cutoff, 600, 2.0): not a config key
    num_gaussians: int = 600
    grid_resolution: int = 18
    max_elements: int = 90
    cutoff: float = 12.0
    avg_degree: float = 23.395238876342773
    avg_num_nodes: float = 77.81317
    alpha_slope: float = 0.2
    eps: float = 1e-5

    @property
    def dim(self) -> int:
        return (self.lmax + 1) ** 2

    @property
    def sizes(self) -> Tuple[int, ...]:
        return m_sizes(self.lmax, self.mmax)

    @property
    def n_rad(self) -> int:
        return self.num_gaussians + 2 * self.edge_channels


def eqv2_spec(config: Dict) -> EqV2Spec:
    """The family's spec from a flat config: the type map, the neighbour
    cap and the widths (fairchem's key names)."""
    names = {'num_layers': 'num_layers', 'lmax': 'lmax_list',
             'mmax': 'mmax_list', 'channels': 'sphere_channels',
             'num_heads': 'num_heads', 'attn_hidden': 'attn_hidden_channels',
             'attn_alpha': 'attn_alpha_channels',
             'attn_value': 'attn_value_channels',
             'ffn_hidden': 'ffn_hidden_channels',
             'edge_channels': 'edge_channels',
             'grid_resolution': 'grid_resolution',
             'max_elements': 'max_num_elements', 'cutoff': 'cutoff',
             'avg_degree': 'avg_degree', 'avg_num_nodes': 'avg_num_nodes'}
    kw = {}
    for field, key in names.items():
        if key in config:
            v = config[key]
            kw[field] = v[0] if isinstance(v, (list, tuple)) else v
    k = config.get(K.MAX_NEIGHBORS)
    return EqV2Spec(num_species=config[K.NUM_SPECIES],
                    type_map=tuple(sorted(config[K.TYPE_MAP].items())),
                    max_neighbors=None if k is None else int(k), **kw)


# -- parameters ---------------------------------------------------------------

def _radial_shapes(prefix: str, hs) -> Dict[str, Tuple[int, ...]]:
    out = {}
    for i, (a, b) in enumerate(zip(hs[:-1], hs[1:])):
        out[f'{prefix}w{i}'] = (a, b)
        out[f'{prefix}b{i}'] = (b,)
        if i < len(hs) - 2:
            out[f'{prefix}ln{i}_w'] = (b,)
            out[f'{prefix}ln{i}_b'] = (b,)
    return out


def _norm_shapes(prefix: str, s: EqV2Spec) -> Dict[str, Tuple[int, ...]]:
    return {f'{prefix}l0_w': (s.channels,), f'{prefix}l0_b': (s.channels,),
            f'{prefix}affine': (s.lmax, s.channels)}


def _ffn_shapes(s: EqV2Spec, c_out: int) -> Dict[str, Tuple[int, ...]]:
    c, h, L = s.channels, s.ffn_hidden, s.lmax + 1
    return {'lin1_w': (L, c, h), 'lin1_b': (h,), 'scalar_w': (c, h),
            'scalar_b': (h,), 'grid_w0': (h, h), 'grid_w1': (h, h),
            'grid_w2': (h, h), 'lin2_w': (L, h, c_out), 'lin2_b': (c_out,)}


def param_shapes(s: EqV2Spec) -> Dict[str, Dict[str, Tuple[int, ...]]]:
    """Group -> leaf -> shape; linear weights are [in, out], SO(3) linears
    [lmax + 1, in, out], the SO(2) maps' m > 0 weights [in, W_r | W_i]."""
    c, E = s.channels, s.edge_channels
    n0 = s.sizes[0]
    emb = {'sphere': (s.max_elements, c),
           'source': (s.max_elements, E), 'target': (s.max_elements, E)}
    emb.update(_radial_shapes('rad_', (s.n_rad, E, E, n0 * c)))
    out = {'eqv2_embedding': emb}
    c2, hid, heads = 2 * c, s.attn_hidden, s.num_heads
    extra = heads * s.attn_alpha + hid
    v = heads * s.attn_value
    for t in range(s.num_layers):
        a = _norm_shapes('norm_', s)
        a.update({'source': (s.max_elements, E), 'target': (s.max_elements, E)})
        a.update(_radial_shapes('rad_', (s.n_rad, E, E,
                                         sum(s.sizes) * c2)))
        a.update({'conv1_w0': (n0 * c2, extra + n0 * hid),
                  'conv1_b0': (extra + n0 * hid,),
                  'alpha_ln_w': (s.attn_alpha,), 'alpha_ln_b': (s.attn_alpha,),
                  'alpha_dot': (heads, s.attn_alpha),
                  'conv2_w0': (n0 * hid, n0 * v), 'conv2_b0': (n0 * v,),
                  'proj_w': (s.lmax + 1, v, c), 'proj_b': (c,)})
        for m, n in enumerate(s.sizes[1:], start=1):
            a[f'conv1_w{m}'] = (n * c2, 2 * n * hid)
            a[f'conv2_w{m}'] = (n * hid, 2 * n * v)
        out[f'{t}_eqv2_attention'] = a
        f = _norm_shapes('norm_', s)
        f.update(_ffn_shapes(s, c))
        out[f'{t}_eqv2_ffn'] = f
    head = _norm_shapes('norm_', s)
    head.update(_ffn_shapes(s, 1))
    out['eqv2_head'] = head
    return out


class EquiformerV2(nn.Module):
    """Parameters of one ``EqV2Spec``; ``forward`` is ``apply_model``."""

    def __init__(self, spec: EqV2Spec):
        super().__init__()
        self.spec = spec
        self.params = nn.ModuleDict({
            group: nn.ParameterDict({
                name: nn.Parameter(torch.zeros(shape))
                for name, shape in names.items()})
            for group, names in param_shapes(spec).items()})

    def forward(self, data: Dict[str, torch.Tensor]):
        return apply_model(self, data)

    def energy_network(self, data, edge_vec, remat=False):
        """``energy_network`` (no rematerialisation: serving only)."""
        return energy_network(self, data, edge_vec)


# -- layers -------------------------------------------------------------------

def layer_norm_sh(x: torch.Tensor, p: Dict, prefix: str, lmax: int,
                  eps: float) -> torch.Tensor:
    """l = 0: LayerNorm over channels; l > 0: over the root of the mean
    square, each degree weighted equally (1 / ((2l + 1) lmax) a row), then
    the mean over channels; an affine weight a (l, channel)."""
    c = x.shape[-1]
    x0, v = x.split([1, x.shape[1] - 1], 1)
    s = F.layer_norm(x0[:, 0], (c,), p[prefix + 'l0_w'], p[prefix + 'l0_b'],
                     eps)
    deg = degree_index(lmax, x.device)[1:]
    bal = 1.0 / ((2 * deg + 1) * lmax).to(x.dtype)
    ms = torch.einsum('nic,i->nc', v * v, bal).mean(-1)
    scale = torch.rsqrt(ms + eps)[:, None, None] * p[prefix + 'affine'][deg - 1]
    return torch.cat([s[:, None], v * scale], 1)


def so3_linear(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
               lmax: int) -> torch.Tensor:
    """One [in, out] map per degree (``w`` [lmax + 1, in, out]), the bias on
    l = 0: x [N, (lmax+1)^2, in] -> [N, (lmax+1)^2, out]."""
    wd = w[degree_index(lmax, x.device)]
    o0, o1 = torch.bmm(x.transpose(0, 1), wd).transpose(0, 1).split(
        [1, x.shape[1] - 1], 1)
    return torch.cat([o0 + b, o1], 1)


def radial_mlp(x: torch.Tensor, p: Dict, prefix: str,
               n_layers: int) -> torch.Tensor:
    """Linear, then LayerNorm and SiLU after each but the last."""
    for i in range(n_layers):
        x = torch.addmm(p[f'{prefix}b{i}'], x, p[f'{prefix}w{i}'])
        if i < n_layers - 1:
            x = F.silu(F.layer_norm(x, (x.shape[-1],), p[f'{prefix}ln{i}_w'],
                                    p[f'{prefix}ln{i}_b'], 1e-5))
    return x


def smooth_leaky_relu(x: torch.Tensor, a: float) -> torch.Tensor:
    return 0.5 * (1 + a) * x + 0.5 * (1 - a) * x * (2 * torch.sigmoid(x) - 1)


def _ffn(s: EqV2Spec, p: Dict, x: torch.Tensor, grid) -> torch.Tensor:
    """The grid FFN; the grid's rows are (point, node), so each projection
    and each grid linear is one GEMM."""
    to, frm = grid
    n, d, _ = x.shape
    x0, _ = x.split([1, d - 1], 1)
    gate = F.silu(torch.addmm(p['scalar_b'], x0[:, 0], p['scalar_w']))
    h = so3_linear(x, p['lin1_w'], p['lin1_b'], s.lmax)
    hid = h.shape[-1]
    g = (to @ h.transpose(0, 1).reshape(d, n * hid)).view(-1, hid)
    g = F.silu(g @ p['grid_w0'])
    g = F.silu(g @ p['grid_w1'])
    g = g @ p['grid_w2']
    h = (frm @ g.view(to.shape[0], n * hid)).view(d, n, hid).transpose(0, 1)
    h = torch.cat([gate[:, None], h.split([1, d - 1], 1)[1]], 1)
    return so3_linear(h, p['lin2_w'], p['lin2_b'], s.lmax)


class _Edges:
    """Per-request edge data shared by the blocks."""

    def __init__(self, s: EqV2Spec, data, edge_vec):
        idx = data[K.EDGE_IDX]
        self.n = data[K.POS].shape[0]
        self.dst, self.src = idx[0], idx[1]
        self.perm = data[K.EDGE_SRC_PERM]
        self.inv = data[EDGE_SRC_INV_PERM]
        z = data[K.ATOMIC_NUMBERS].long()
        self.z_src = z[self.src.clamp(max=self.n - 1).long()]
        self.z_dst = z[self.dst.clamp(max=self.n - 1).long()]
        live = data[K.EDGE_MASK] > 0
        unit = torch.zeros_like(edge_vec)
        unit[:, 0] = 1.0
        vec = torch.where(live[:, None], edge_vec, unit)
        r = torch.sqrt((vec * vec).sum(-1))
        self.gauss = gaussian_basis(r, s.cutoff, s.num_gaussians)
        self.rot = edge_rotation(vec, s.lmax, s.mmax)           # [E, K, d]
        # the back-rotation, truncated degrees rescaled
        self.rot_back = self.rot * rescale_rows(s.lmax, s.mmax, vec.device,
                                                vec.dtype)[:, None]
        self.E = vec.shape[0]

    def radial_in(self, p: Dict) -> torch.Tensor:
        return torch.cat([self.gauss, p['source'][self.z_src],
                          p['target'][self.z_dst]], 1)

    def rotate(self, x: torch.Tensor) -> torch.Tensor:
        """Source and target coefficients in the edge frame [E, K, 2C]."""
        return rotate_in(self.rot, x, self.src, self.dst, self.perm,
                         self.inv)

    def reduce(self, msg: torch.Tensor, rows: int = None) -> torch.Tensor:
        """Rotate edge-frame rows [E, K, C] (the first ``rows``) back and
        sum them at i."""
        D = self.rot_back if rows is None else self.rot_back[:, :rows]
        out = rotate_back(D, msg)
        return segment_sum_sorted(out.reshape(self.E, -1), self.dst,
                                  self.n).reshape(self.n, -1, msg.shape[-1])


def _attention(s: EqV2Spec, p: Dict, x: torch.Tensor, e: _Edges,
               grid) -> torch.Tensor:
    msg = e.rotate(x)                                          # [E, K, 2C]
    w = radial_mlp(e.radial_in(p), p, 'rad_', 3)
    n_m = len(s.sizes)
    extra = s.num_heads * s.attn_alpha + s.attn_hidden
    y, ex = so2_linear(msg, p['conv1_w0'], p['conv1_b0'],
                       [p[f'conv1_w{m}'] for m in range(1, n_m)], s.sizes,
                       radial=w, extra=extra)
    a_in, gate = ex.split([s.num_heads * s.attn_alpha, s.attn_hidden], 1)
    a_in = a_in.reshape(-1, s.num_heads, s.attn_alpha)
    a_in = smooth_leaky_relu(F.layer_norm(a_in, (s.attn_alpha,),
                                          p['alpha_ln_w'], p['alpha_ln_b'],
                                          1e-5), s.alpha_slope)
    logits = torch.einsum('ehk,hk->eh', a_in, p['alpha_dot'])
    alpha = segment_softmax(logits, e.dst, e.n)
    y = s2_act(y, *grid).split([1, y.shape[1] - 1], 1)[1]
    y = torch.cat([F.silu(gate)[:, None], y], 1)
    y, _ = so2_linear(y, p['conv2_w0'], p['conv2_b0'],
                      [p[f'conv2_w{m}'] for m in range(1, n_m)], s.sizes)
    k = y.shape[1]
    y = (y.reshape(e.E, k, s.num_heads, s.attn_value)
         * alpha[:, None, :, None]).reshape(e.E, k, -1)
    return so3_linear(e.reduce(y), p['proj_w'], p['proj_b'], s.lmax)


def energy_network(model, data: Dict[str, torch.Tensor],
                   edge_vec: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Edge vectors + graph -> atomic and total energies."""
    s, P = model.spec, model.params
    out = dict(data)
    dev, dt = edge_vec.device, edge_vec.dtype
    attn_grid = grid_matrices(s.lmax, s.mmax, s.grid_resolution, dev, dt)
    ffn_grid = node_grid_matrices(s.lmax, s.grid_resolution, dev, dt)
    z = data[K.ATOMIC_NUMBERS].long()
    n = data[K.POS].shape[0]
    with tracing.span('eqv2.edge_embed', edges=int(edge_vec.shape[0])):
        e = _Edges(s, data, edge_vec)
        pe = P['eqv2_embedding']
        m0 = radial_mlp(e.radial_in(pe), pe, 'rad_', 3).reshape(
            e.E, s.sizes[0], s.channels)
        x0, x1 = (e.reduce(m0, s.sizes[0]) / s.avg_degree).split(
            [1, s.dim - 1], 1)
        x = torch.cat([x0 + pe['sphere'][z][:, None], x1], 1)
    for t in range(s.num_layers):
        pa, pf = P[f'{t}_eqv2_attention'], P[f'{t}_eqv2_ffn']
        with tracing.span('eqv2.attn', edges=e.E, block=t):
            x = x + _attention(s, pa, layer_norm_sh(x, pa, 'norm_', s.lmax,
                                                    s.eps), e, attn_grid)
        with tracing.span('eqv2.ffn', nodes=n, block=t):
            x = x + _ffn(s, pf, layer_norm_sh(x, pf, 'norm_', s.lmax, s.eps),
                         ffn_grid)
    with tracing.span('eqv2.head', nodes=n):
        ph = P['eqv2_head']
        h = _ffn(s, ph, layer_norm_sh(x, ph, 'norm_', s.lmax, s.eps),
                 ffn_grid)
        atomic = h[:, 0, 0] / s.avg_num_nodes * data[K.NODE_MASK]
    out[K.NODE_FEATURE] = x
    out[K.SCALED_ATOMIC_ENERGY] = atomic
    out[K.ATOMIC_ENERGY] = atomic
    n_graph = data[K.CELL].shape[0]
    batch = torch.where(data[K.NODE_MASK] > 0, data[K.BATCH],
                        torch.full_like(data[K.BATCH], n_graph))
    out[K.PRED_TOTAL_ENERGY] = segment_sum_sorted(atomic[:, None], batch,
                                                  n_graph)[:, 0]
    return out
