"""Plain-PyTorch reference of the 'equiformer_v2' family (EquiformerV2,
Liao, Wood, Das, Smidt, arXiv:2306.12059; fairchem's layers as written
there), float32.

Built apart from the program's construction:

- the edge frame: D(R) = exp(-beta L_x) exp(-alpha L_y), block diagonal
  over l, by ``torch.linalg.matrix_exp`` of the real so(3) generators L_k,
  which are fitted from this package's harmonics (the derivative of Y(n)
  along the rotation field G_k n equals L_k Y(n)); alpha = atan2(x, z),
  beta = atan2(rho, y): R takes the edge's direction onto +y, the roll 0;
- coefficients stay in l-major order (the 19 of |m| <= 2 among the 25);
  each SO(2) map is one dense block matrix on (coefficient, channel),
  its entries read from the port's named weights;
- the S2 grid is sampled explicitly, beta_b = (b + 1/2) pi / R, alpha_a =
  2 pi a / R, with quadrature weights solved from int P_l(cos b) sin b db
  for l < R; the harmonics are 'component' normalised, as fairchem's
  EquiformerV2 builds its SO3_Grid (e3nn's ToS2Grid factor sqrt(4 pi) /
  sqrt((2l + 1)(lmax + 1)) on degree l's samples, FromS2Grid's reciprocal
  on its projection); degrees l > mmax are rescaled by sqrt((2l + 1) /
  (2 mmax + 1)) where fairchem rescales them;
- each destination's nearest ``max_neighbors`` sources within the cutoff,
  by (distance of the float32 positions in float64, source, image), from
  the reference's own brute-force graph.

``chunk``: the attention's per-edge work runs over slices of that many
edges under ``torch.utils.checkpoint``.  ``init_weights`` draws the
weights on the device from the seed under the port's names and shapes.
"""

from __future__ import annotations

import math
from functools import lru_cache
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from .graph import neighbor_edges
from .model import Reference
from .spherical import spherical_harmonics


class Spec:
    """Widths of a configuration (fairchem's key names)."""

    def __init__(self, cfg: Dict):
        def get(key, default):
            v = cfg.get(key, default)
            return v[0] if isinstance(v, (list, tuple)) else v

        self.layers = int(get('num_layers', 8))
        self.lmax = int(get('lmax_list', 4))
        self.mmax = int(get('mmax_list', 2))
        self.c = int(get('sphere_channels', 128))
        self.heads = int(get('num_heads', 8))
        self.hid = int(get('attn_hidden_channels', 64))
        self.alpha = int(get('attn_alpha_channels', 64))
        self.value = int(get('attn_value_channels', 16))
        self.ffn = int(get('ffn_hidden_channels', 128))
        self.edge = int(get('edge_channels', 128))
        # fairchem builds GaussianSmearing(0, cutoff, 600, 2.0) whatever
        # num_distance_basis holds
        self.gauss = 600
        self.res = int(get('grid_resolution', 18))
        self.elements = int(get('max_num_elements', 90))
        self.cutoff = float(get('cutoff', 12.0))
        self.avg_degree = float(get('avg_degree', 23.395238876342773))
        self.avg_nodes = float(get('avg_num_nodes', 77.81317))
        # the kept coefficients (l, m), l-major
        self.lm = [(l, m) for l in range(self.lmax + 1)
                   for m in range(-l, l + 1) if abs(m) <= self.mmax]
        self.kept = [l * l + l + m for l, m in self.lm]


def param_shapes(sp: Spec) -> Dict[str, Dict[str, Tuple[int, ...]]]:
    """Group -> leaf -> shape under the port's names."""
    L, c, E, g = sp.lmax + 1, sp.c, sp.edge, sp.elements
    n_m = [sp.lmax + 1 - m for m in range(sp.mmax + 1)]

    def radial(out):
        r = {}
        hs = (sp.gauss + 2 * E, E, E, out)
        for i in range(3):
            r[f'rad_w{i}'] = (hs[i], hs[i + 1])
            r[f'rad_b{i}'] = (hs[i + 1],)
            if i < 2:
                r[f'rad_ln{i}_w'] = (hs[i + 1],)
                r[f'rad_ln{i}_b'] = (hs[i + 1],)
        return r

    def norm():
        return {'norm_l0_w': (c,), 'norm_l0_b': (c,),
                'norm_affine': (sp.lmax, c)}

    def ffn(c_out):
        h = sp.ffn
        return {'lin1_w': (L, c, h), 'lin1_b': (h,), 'scalar_w': (c, h),
                'scalar_b': (h,), 'grid_w0': (h, h), 'grid_w1': (h, h),
                'grid_w2': (h, h), 'lin2_w': (L, h, c_out),
                'lin2_b': (c_out,)}

    out = {'eqv2_embedding': {'sphere': (g, c), 'source': (g, E),
                              'target': (g, E), **radial(n_m[0] * c)}}
    extra = sp.heads * sp.alpha + sp.hid
    v = sp.heads * sp.value
    for t in range(sp.layers):
        a = {**norm(), 'source': (g, E), 'target': (g, E),
             **radial(sum(n_m) * 2 * c),
             'conv1_w0': (n_m[0] * 2 * c, extra + n_m[0] * sp.hid),
             'conv1_b0': (extra + n_m[0] * sp.hid,),
             'alpha_ln_w': (sp.alpha,), 'alpha_ln_b': (sp.alpha,),
             'alpha_dot': (sp.heads, sp.alpha),
             'conv2_w0': (n_m[0] * sp.hid, n_m[0] * v),
             'conv2_b0': (n_m[0] * v,), 'proj_w': (L, v, c),
             'proj_b': (c,)}
        for m in range(1, sp.mmax + 1):
            a[f'conv1_w{m}'] = (n_m[m] * 2 * c, 2 * n_m[m] * sp.hid)
            a[f'conv2_w{m}'] = (n_m[m] * sp.hid, 2 * n_m[m] * v)
        out[f'{t}_eqv2_attention'] = a
        out[f'{t}_eqv2_ffn'] = {**norm(), **ffn(c)}
    out['eqv2_head'] = {**norm(), **ffn(1)}
    return out


def init_weights(cfg: Dict, seed: int, device):
    """Random weights from ``seed``, drawn on ``device`` in one call
    (uniform in [-1, 1)): weights over sqrt(fan in) (the SO(2) maps' m > 0
    ones over sqrt 2 more, ``alpha_dot`` over its channels), biases and the
    edges' element tables times 0.1, norm weights 1 + 0.1 u, the element
    embedding 1.7 u (unit variance)."""
    shapes = param_shapes(Spec(cfg))
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (2 ** 63))
    names = [(g, n, s) for g, ns in shapes.items() for n, s in ns.items()]
    total = sum(int(np.prod(s)) for _, _, s in names)
    flat = (2 * torch.rand(total, generator=gen, device=device) - 1) \
        .cpu().numpy()
    out: Dict[str, Dict[str, np.ndarray]] = {}
    off = 0
    for g, n, s in names:
        k = int(np.prod(s))
        u = flat[off:off + k].reshape(s).astype(np.float64)
        off += k
        if n == 'sphere':
            v = math.sqrt(3.0) * u
        elif n in ('source', 'target'):
            v = 0.1 * u
        elif n.endswith('_w') and ('ln' in n or 'l0' in n) \
                or n == 'norm_affine':
            v = 1.0 + 0.1 * u
        elif len(s) == 1:
            v = 0.1 * u
        else:
            v = u / math.sqrt(s[-1] if n == 'alpha_dot' else s[-2])
            if n.startswith('conv') and not n.endswith('0'):
                v = v / math.sqrt(2.0)
        out.setdefault(g, {})[n] = v.astype(np.float32)
    return out


# -- the sphere -----------------------------------------------------------------

@lru_cache(maxsize=None)
def generators(lmax: int) -> np.ndarray:
    """[3, d, d] real generators L_k (k = x, y, z), block diagonal: for R =
    exp(t G_k), Y(R n) = exp(t L_k) Y(n)."""
    d = (lmax + 1) ** 2
    n = torch.as_tensor(np.random.default_rng(1).normal(size=(200, 3)))
    n = n / n.norm(dim=1, keepdim=True)
    G = np.zeros((3, 3, 3))
    G[0][2, 1], G[0][1, 2] = 1.0, -1.0          # about x
    G[1][0, 2], G[1][2, 0] = 1.0, -1.0          # about y
    G[2][1, 0], G[2][0, 1] = 1.0, -1.0          # about z
    sh = spherical_harmonics(lmax)
    Y = sh(n).numpy()
    jac = torch.autograd.functional.jacobian(
        lambda v: sh(v).sum(0), n).numpy()       # [d, P, 3]
    out = np.zeros((3, d, d))
    for k in range(3):
        field = n.numpy() @ G[k].T               # G_k n
        T = np.einsum('ipc,pc->pi', jac, field)  # [P, d]
        Lt = np.linalg.lstsq(Y, T, rcond=None)[0]
        L = Lt.T
        for l in range(lmax + 1):
            s = slice(l * l, (l + 1) ** 2)
            out[k, s, s] = L[s, s]
    return out


def edge_wigner(vec: torch.Tensor, lmax: int) -> torch.Tensor:
    """[E, d, d]: D(Rx(-beta) Ry(-alpha)) of each edge vector."""
    Lg = torch.as_tensor(generators(lmax), dtype=vec.dtype,
                         device=vec.device)
    x, y, z = vec[:, 0], vec[:, 1], vec[:, 2]
    alpha = torch.atan2(x, z)
    beta = torch.atan2(torch.sqrt(x * x + z * z), y)
    dx = torch.linalg.matrix_exp(-beta[:, None, None] * Lg[0])
    dy = torch.linalg.matrix_exp(-alpha[:, None, None] * Lg[1])
    return dx @ dy


@lru_cache(maxsize=None)
def beta_weights(res: int) -> np.ndarray:
    """w_b with sum_b w_b P_l(cos beta_b) = int_0^pi P_l(cos b) sin b db
    (2 for l = 0, else 0), l < res."""
    beta = (np.arange(res) + 0.5) * math.pi / res
    A = np.stack([np.polynomial.legendre.Legendre.basis(l)(np.cos(beta))
                  for l in range(res)])
    rhs = np.zeros(res)
    rhs[0] = 2.0
    return np.linalg.solve(A, rhs)


@lru_cache(maxsize=None)
def sphere_grid(lmax: int, res: int) -> Tuple[np.ndarray, np.ndarray]:
    """(to [P, d], from [d, P]) with 'component' normalisation: the
    'integral' harmonics Y at the grid times e3nn's ToS2Grid factor of
    their degree, and (Y Omega)^T, Omega the points' solid angles, times
    FromS2Grid's sqrt((2l + 1)(lmax + 1) / (4 pi)))."""
    pts, om = [], []
    wb = beta_weights(res)
    for b in range(res):
        beta = (b + 0.5) * math.pi / res
        for a in range(res):
            alpha = 2 * math.pi * a / res
            pts.append((math.sin(beta) * math.sin(alpha), math.cos(beta),
                        math.sin(beta) * math.cos(alpha)))
            om.append(wb[b] * 2 * math.pi / res)
    Y = spherical_harmonics(lmax, normalization='integral')(
        torch.as_tensor(np.array(pts))).numpy()
    deg = np.array([l for l in range(lmax + 1) for _ in range(2 * l + 1)])
    to_n = np.sqrt(4 * math.pi) / np.sqrt((2 * deg + 1) * (lmax + 1))
    from_n = np.sqrt((2 * deg + 1) * (lmax + 1)) / np.sqrt(4 * math.pi)
    return Y * to_n, (Y * np.array(om)[:, None] * from_n).T


# -- the model --------------------------------------------------------------------

class EqV2Reference(Reference):
    """The reference potential of an 'equiformer_v2' configuration:
    ``evaluate`` (energy, forces, stress) as ``model.Reference``'s, on
    ``capped_graph``'s nearest-neighbour graph.  After it, ``energy_scale``
    holds each graph's sum of |per-atom energy|: the scale of a total
    energy's gap, which, unlike |E|, a sum of random signs cannot bring
    near zero."""

    energy_scale = None

    def __init__(self, cfg: Dict, params, device,
                 chunk: Optional[int] = None):
        self.spec = sp = Spec(cfg)
        self.device = torch.device(device)
        self.chunk = chunk
        self.p = {g: {n: torch.tensor(np.asarray(v, np.float32),
                                      device=self.device)
                      for n, v in names.items()}
                  for g, names in params.items()}
        dt, dev = torch.float32, self.device
        self.deg = [l for l in range(sp.lmax + 1) for _ in range(2 * l + 1)]
        kdeg = [l for l, _ in sp.lm]
        self.rescale = torch.tensor(
            [math.sqrt((2 * l + 1) / (2 * sp.mmax + 1)) if l > sp.mmax
             else 1.0 for l in kdeg], dtype=dt, device=dev)
        to, frm = sphere_grid(sp.lmax, sp.res)
        self.to_full = torch.tensor(to, dtype=dt, device=dev)
        self.from_full = torch.tensor(frm, dtype=dt, device=dev)
        kept = sp.kept
        self.to_kept = self.to_full[:, kept] * self.rescale
        self.from_kept = self.from_full[kept] * self.rescale[:, None]
        self.m0 = [k for k, (l, m) in enumerate(sp.lm) if m == 0]
        self.blocks = [self._dense(t) for t in range(sp.layers)]

    # -- the SO(2) maps as dense matrices ------------------------------------
    def _so2_dense(self, p, name, c_in, c_out, extra):
        """(M [K c_in, extra + K c_out], bias) of SO(2) map ``name``."""
        sp = self.spec
        K = len(sp.lm)
        M = torch.zeros(K * c_in, extra + K * c_out, device=self.device)
        bias = torch.zeros(extra + K * c_out, device=self.device)
        w0 = p[f'{name}_w0']
        bias[:extra] = p[f'{name}_b0'][:extra]
        for ki, (li, mi) in enumerate(sp.lm):
            rows = slice(ki * c_in, (ki + 1) * c_in)
            for ko, (lo, mo) in enumerate(sp.lm):
                cols = slice(extra + ko * c_out, extra + (ko + 1) * c_out)
                if mi == 0 and mo == 0:
                    M[rows, cols] = w0[li * c_in:(li + 1) * c_in,
                                       extra + lo * c_out:
                                       extra + (lo + 1) * c_out]
                elif mi != 0 and abs(mi) == abs(mo):
                    m = abs(mi)
                    w = p[f'{name}_w{m}']
                    n = sp.lmax + 1 - m
                    a, b = li - m, lo - m
                    wr = w[a * c_in:(a + 1) * c_in, b * c_out:(b + 1) * c_out]
                    wi = w[a * c_in:(a + 1) * c_in,
                           n * c_out + b * c_out:n * c_out + (b + 1) * c_out]
                    # y+ = Wr x+ - Wi x-, y- = Wr x- + Wi x+
                    if mi == mo:
                        M[rows, cols] = wr
                    elif mo < 0:                       # x+ -> y-
                        M[rows, cols] = wi
                    else:                              # x- -> y+
                        M[rows, cols] = -wi
        for ko, (lo, mo) in enumerate(sp.lm):
            if mo == 0:
                bias[extra + ko * c_out:extra + (ko + 1) * c_out] = \
                    p[f'{name}_b0'][extra + lo * c_out:
                                    extra + (lo + 1) * c_out]
        # the m = 0 inputs also feed the extra scalars
        for ki, (li, mi) in enumerate(sp.lm):
            if mi == 0:
                M[ki * c_in:(ki + 1) * c_in, :extra] = \
                    w0[li * c_in:(li + 1) * c_in, :extra]
        return M, bias

    def _dense(self, t):
        sp = self.spec
        p = self.p[f'{t}_eqv2_attention']
        extra = sp.heads * sp.alpha + sp.hid
        m1 = self._so2_dense(p, 'conv1', 2 * sp.c, sp.hid, extra)
        m2 = self._so2_dense(p, 'conv2', sp.hid, sp.heads * sp.value, 0)
        # radial weight index of each (coefficient, channel) input
        c2 = 2 * sp.c
        offs = [0]
        for m in range(1, sp.mmax + 1):
            offs.append(offs[-1] + (sp.lmax + 2 - m) * c2)
        idx = [offs[abs(m)] + (l - abs(m)) * c2 + ch
               for l, m in sp.lm for ch in range(c2)]
        return m1, m2, torch.tensor(idx, device=self.device)

    # -- layers ---------------------------------------------------------------
    def _ln(self, x, p):
        sp = self.spec
        out = [F.layer_norm(x[:, 0], (sp.c,), p['norm_l0_w'],
                            p['norm_l0_b'], 1e-5)[:, None]]
        acc = 0.0
        for l in range(1, sp.lmax + 1):
            blk = x[:, l * l:(l + 1) ** 2]
            acc = acc + (blk * blk).mean(1) / sp.lmax
        inv = (acc.mean(-1, keepdim=True) + 1e-5) ** -0.5          # [N, 1]
        for l in range(1, sp.lmax + 1):
            blk = x[:, l * l:(l + 1) ** 2]
            out.append(blk * inv[:, None, :] * p['norm_affine'][l - 1])
        return torch.cat(out, 1)

    def _so3(self, x, w, b):
        outs = []
        for l in range(self.spec.lmax + 1):
            o = x[:, l * l:(l + 1) ** 2] @ w[l]
            if l == 0:
                o = o + b
            outs.append(o)
        return torch.cat(outs, 1)

    @staticmethod
    def _radial(x, p):
        for i in range(3):
            x = x @ p[f'rad_w{i}'] + p[f'rad_b{i}']
            if i < 2:
                x = F.silu(F.layer_norm(x, (x.shape[-1],),
                                        p[f'rad_ln{i}_w'],
                                        p[f'rad_ln{i}_b'], 1e-5))
        return x

    def _ffn(self, x, p):
        g = F.silu(x[:, 0] @ p['scalar_w'] + p['scalar_b'])
        h = self._so3(x, p['lin1_w'], p['lin1_b'])
        grid = torch.einsum('pi,nic->npc', self.to_full, h)
        grid = F.silu(grid @ p['grid_w0'])
        grid = F.silu(grid @ p['grid_w1'])
        grid = grid @ p['grid_w2']
        h = torch.einsum('ip,npc->nic', self.from_full, grid)
        h = torch.cat([g[:, None], h[:, 1:]], 1)
        return self._so3(h, p['lin2_w'], p['lin2_b'])

    def _edge_part(self, t, xs, xt, D, rad_in):
        """Per-edge values [e, K, heads value] and logits [e, heads]."""
        sp = self.spec
        p = self.p[f'{t}_eqv2_attention']
        (M1, b1), (M2, b2), ridx = self.blocks[t]
        e = xs.shape[0]
        K = len(sp.lm)
        Dk = D[:, sp.kept]                                   # [e, K, d]
        msg = Dk @ torch.cat([xs, xt], -1)                   # [e, K, 2C]
        w = self._radial(rad_in, p)
        y = (msg.reshape(e, -1) * w[:, ridx]) @ M1 + b1
        extra = sp.heads * sp.alpha + sp.hid
        ex, y = y[:, :extra], y[:, extra:].reshape(e, K, sp.hid)
        a = ex[:, :sp.heads * sp.alpha].reshape(e, sp.heads, sp.alpha)
        a = F.layer_norm(a, (sp.alpha,), p['alpha_ln_w'], p['alpha_ln_b'],
                         1e-5)
        a = 0.6 * a + 0.4 * a * (2 * torch.sigmoid(a) - 1)
        logits = (a * p['alpha_dot']).sum(-1)
        gate = F.silu(ex[:, sp.heads * sp.alpha:])
        grid = F.silu(torch.einsum('pk,ekc->epc', self.to_kept, y))
        y = torch.einsum('kp,epc->ekc', self.from_kept, grid)
        y = torch.cat([gate[:, None], y[:, 1:]], 1)
        y = (y.reshape(e, -1) @ M2 + b2).reshape(e, K, -1)
        return y, logits

    def _back(self, y, D, dst, n):
        Dk = D[:, self.spec.kept] * self.rescale[None, :, None]
        out = Dk.transpose(1, 2) @ y                         # [e, d, C]
        return y.new_zeros((n,) + out.shape[1:]).index_add(0, dst, out)

    def _chunks(self, fn, *args):
        E = args[0].shape[0]
        if self.chunk is None or E <= self.chunk:
            return [fn(*args)]
        return [checkpoint(fn, *(a[lo:lo + self.chunk] for a in args),
                           use_reentrant=False)
                for lo in range(0, E, self.chunk)]

    def atomic_energy(self, g: Dict[str, torch.Tensor],
                      vec: torch.Tensor) -> torch.Tensor:
        sp, P = self.spec, self.p
        z = g['numbers']
        n = z.shape[0]
        src, dst = g['src'], g['dst']
        r = torch.sqrt((vec * vec).sum(-1))
        mu = torch.linspace(0.0, sp.cutoff, sp.gauss, device=vec.device)
        step = sp.cutoff / (sp.gauss - 1)
        gauss = torch.exp(-((r[:, None] - mu) ** 2) / (2 * (2.0 * step) ** 2))
        D = edge_wigner(vec, sp.lmax)                        # [E, d, d]
        pe = P['eqv2_embedding']
        rad = torch.cat([gauss, pe['source'][z[src]], pe['target'][z[dst]]],
                        1)
        m0 = self._radial(rad, pe).reshape(-1, sp.lmax + 1, sp.c)
        y = vec.new_zeros((vec.shape[0], len(sp.lm), sp.c))
        y[:, self.m0] = m0
        x = self._back(y, D, dst, n) / sp.avg_degree
        x = torch.cat([x[:, :1] + pe['sphere'][z][:, None], x[:, 1:]], 1)
        for t in range(sp.layers):
            p = P[f'{t}_eqv2_attention']
            h = self._ln(x, p)
            rad = torch.cat([gauss, p['source'][z[src]], p['target'][z[dst]]],
                            1)
            # t and h bound now: checkpoint recomputes in the backward
            parts = self._chunks(
                lambda s_, d_, D_, r_, t=t, h=h: self._edge_part(
                    t, h[s_], h[d_], D_, r_),
                src, dst, D, rad)
            y = torch.cat([a for a, _ in parts])
            logits = torch.cat([b for _, b in parts])
            top = logits.new_full((n, sp.heads), -torch.inf).scatter_reduce(
                0, dst[:, None].expand_as(logits), logits.detach(), 'amax')
            ex = torch.exp(logits - top[dst])
            tot = ex.new_zeros((n, sp.heads)).index_add(0, dst, ex)
            alpha = ex / (tot[dst] + 1e-16)
            y = (y.reshape(y.shape[0], y.shape[1], sp.heads, sp.value)
                 * alpha[:, None, :, None]).reshape(y.shape)
            agg = sum(self._chunks(lambda y_, D_, d_: self._back(y_, D_, d_, n),
                                   y, D, dst))
            x = x + self._so3(agg, p['proj_w'], p['proj_b'])
            pf = P[f'{t}_eqv2_ffn']
            x = x + self._ffn(self._ln(x, pf), pf)
        ph = P['eqv2_head']
        e = self._ffn(self._ln(x, ph), ph)[:, 0, 0] / sp.avg_nodes
        mag = e.detach().abs()
        self.energy_scale = mag.new_zeros(g['n_graph']).index_add(
            0, g['batch'], mag)
        return e


def capped_graph(s: Dict, cutoff: float, k: Optional[int], device,
                 dtype=torch.float32) -> Dict[str, torch.Tensor]:
    """One structure's graph for ``EqV2Reference.evaluate``: the pairs
    within ``cutoff`` (``graph.neighbor_edges``), each destination keeping
    its ``k`` nearest by (distance, source, image), the distance from the
    float32 positions in float64."""
    pos = np.asarray(s['pos'], np.float64)
    cell = np.asarray(s['cell'], np.float64)
    dst, src, shift = neighbor_edges(pos, cell, s['pbc'], cutoff, device)
    if k is not None:
        d, j = dst.cpu().numpy(), src.cpu().numpy()
        sh = shift.cpu().numpy()
        p32 = pos.astype(np.float32).astype(np.float64)
        v = p32[j] + sh - p32[d]
        d2 = (v * v).sum(1)
        img = np.rint(sh @ np.linalg.inv(cell)).astype(np.int64)
        order = np.lexsort((img[:, 2], img[:, 1], img[:, 0], j, d2, d))
        ds = d[order]
        first = np.concatenate([[0], np.flatnonzero(ds[1:] != ds[:-1]) + 1])
        rank = np.arange(len(ds)) - np.repeat(first, np.diff(
            np.concatenate([first, [len(ds)]])))
        keep = torch.as_tensor(order[rank < k], device=device)
        dst, src, shift = dst[keep], src[keep], shift[keep]
    n = len(s['numbers'])
    return {'pos': torch.as_tensor(pos, device=device).to(dtype),
            'numbers': torch.as_tensor(np.asarray(s['numbers'], np.int64),
                                       device=device),
            'batch': torch.zeros(n, dtype=torch.long, device=device),
            'src': src, 'dst': dst, 'shift': shift.to(dtype),
            'volume': torch.tensor([abs(float(np.linalg.det(cell)))],
                                   dtype=dtype, device=device),
            'n_graph': 1}
