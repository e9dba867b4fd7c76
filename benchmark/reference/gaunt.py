"""Plain-PyTorch reference of the 'gaunt' family (MACE's trunk with Gaunt
products: the reference fork's ``sevenn/nn/interaction_blocks.py``
reading of Luo et al., arXiv:2401.10216).

A layer whose input is scalar only keeps the Clebsch-Gordan convolution
(``model.uvu_conv``).  Every other layer forms its messages as products of
functions on the sphere: per edge and channel, f_x(r) = sum_lm x[lm]
Y_lm(r) (the gathered source features) times f_sh(r) = sum_lm sh[lm]
Y_lm(r) (the edge's harmonics), projected back onto the real spherical
harmonics up to the layer's output l, each l weighted by the radial MLP,
sqrt(2l+1) and the Gaunt/w3j ratio.  Both layers replace MACE's symmetric
contraction by the Gaunt self-product basis: per node and channel, f_0 +
f_0 f_1 + f_0 f_1 f_2 with f_i the features weighted per (channel, l) by
the i-th weight, projected likewise, each l weighted by sqrt(2l+1) and the
ratios of the successive products.  There is no gate; the self-connection
is a linear map of the block's input.

Products are evaluated at the nodes of a product quadrature on the sphere
(Gauss-Legendre in cos(theta), uniform in phi) that is exact for the
degree of every integrand, and projected back by the same quadrature:
with 'component' harmonics, c_lm = (1 / 4 pi) int g Y_lm.  Nothing here
uses a torus grid or an FFT.  The Gaunt/w3j ratio is recomputed from its
definition: for each output l, one over the norm, over the paths (l1 <=
L1, l2 <= L2) that reach l, of sqrt((2 l1 + 1)(2 l2 + 1)(2 l + 1) / 4 pi)
times the Wigner 3j symbol (l1 l2 l; 0 0 0), from Racah's closed form.

Float32, with the spherical harmonics, the radial basis, the MLP, the
linears and the readout of the reference's other modules.  ``chunk``
evaluates each convolution over slices of that many edges under
``torch.utils.checkpoint``, as ``model.Reference`` does.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from functools import lru_cache
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from .irreps import Irreps, tp_out_irreps
from .linear import apply_linear, linear_spec
from .mlp import mlp_apply
from .model import Reference, _ws, uvu_conv
from .radial import bessel_basis, poly_cutoff, xplor_cutoff
from .spherical import spherical_harmonics
from .tensor_product import uvu_tp_spec
from .util import safe_norm


# -- the sphere ---------------------------------------------------------------

@lru_cache(maxsize=None)
def quadrature(degree: int) -> Tuple[np.ndarray, np.ndarray]:
    """(unit vectors [Q, 3], weights [Q] summing to 4 pi) of a product rule
    exact for every polynomial of ``degree`` on the sphere: n = degree // 2
    + 1 Gauss-Legendre nodes in cos(theta) (exact to 2n - 1) times degree +
    1 uniform nodes in phi (exact to that trigonometric degree)."""
    n_t = degree // 2 + 1
    n_p = degree + 1
    ct, wt = np.polynomial.legendre.leggauss(n_t)
    st = np.sqrt(1.0 - ct * ct)
    phi = 2 * np.pi * np.arange(n_p) / n_p
    dirs = np.stack([st[:, None] * np.cos(phi)[None, :],
                     st[:, None] * np.sin(phi)[None, :],
                     np.broadcast_to(ct[:, None], (n_t, n_p))], -1)
    w = np.broadcast_to(wt[:, None] * (2 * np.pi / n_p), (n_t, n_p))
    return dirs.reshape(-1, 3), np.ascontiguousarray(w).reshape(-1)


@lru_cache(maxsize=None)
def _sh_at(lmax: int, degree: int) -> np.ndarray:
    """The 'component' harmonics up to ``lmax`` at the nodes of
    ``quadrature(degree)``: [Q, (lmax + 1)^2], float64."""
    dirs, _ = quadrature(degree)
    return spherical_harmonics(lmax)(torch.as_tensor(dirs)).numpy()


def evaluate_at(lmax: int, degree: int, dtype, device) -> torch.Tensor:
    """[(lmax + 1)^2, Q]: coefficients -> values at the nodes."""
    return torch.as_tensor(_sh_at(lmax, degree).T, dtype=dtype,
                           device=device)


def project_from(lmax: int, degree: int, dtype, device) -> torch.Tensor:
    """[Q, (lmax + 1)^2]: values at the nodes -> (1 / 4 pi) int g Y_lm."""
    _, w = quadrature(degree)
    P = _sh_at(lmax, degree) * (w / (4 * np.pi))[:, None]
    return torch.as_tensor(P, dtype=dtype, device=device)


def wigner_3j_000(l1: int, l2: int, l3: int) -> float:
    """(l1 l2 l3; 0 0 0) by Racah's closed form."""
    J = l1 + l2 + l3
    if J % 2 or l3 < abs(l1 - l2) or l3 > l1 + l2:
        return 0.0
    g = J // 2
    f = math.factorial
    mag = math.sqrt(f(J - 2 * l1) * f(J - 2 * l2) * f(J - 2 * l3)
                    / f(J + 1)) * f(g) / (f(g - l1) * f(g - l2) * f(g - l3))
    return (-1) ** g * mag


@lru_cache(maxsize=None)
def gaunt_ratio(L1: int, L2: int) -> Tuple[float, ...]:
    """Per output l <= L1 + L2: one over the norm of the Gaunt
    coefficients sqrt((2l1+1)(2l2+1)(2l+1) / 4 pi) (l1 l2 l; 0 0 0) over
    the paths l1 <= L1, l2 <= L2 that reach l (1 where none does)."""
    out = []
    for lo in range(L1 + L2 + 1):
        vals = [math.sqrt((2 * l1 + 1) * (2 * l2 + 1) * (2 * lo + 1)
                          / (4 * math.pi)) * wigner_3j_000(l1, l2, lo)
                for l1 in range(L1 + 1) for l2 in range(L2 + 1)
                if abs(l1 - l2) <= lo <= l1 + l2]
        out.append(1.0 / math.sqrt(sum(v * v for v in vals)) if vals
                   else 1.0)
    return tuple(out)


def per_l(lmax: int, values) -> np.ndarray:
    """One value an l spread over its 2l + 1 components."""
    return np.array([values[l] for l in range(lmax + 1)
                     for _ in range(2 * l + 1)])


def to_coeffs(x: torch.Tensor, irreps: Irreps) -> torch.Tensor:
    """Flat features of ``irreps`` (one multiplicity, l = 0..lmax each
    once) -> [N, mul, (lmax + 1)^2], the harmonics' coefficients of one
    function a channel."""
    mul = irreps[0].mul
    return torch.cat([x[:, s].reshape(x.shape[0], mul, mi.ir.dim)
                      for s, mi in zip(irreps.slices(), irreps)], dim=-1)


def from_coeffs(c: torch.Tensor, irreps: Irreps) -> torch.Tensor:
    out, off = [], 0
    for mi in irreps:
        out.append(c[:, :, off:off + mi.ir.dim].reshape(c.shape[0], -1))
        off += mi.ir.dim
    return torch.cat(out, dim=-1)


def sphere_product(a: torch.Tensor, La: int, b: torch.Tensor, Lb: int,
                   Lo: int) -> torch.Tensor:
    """Coefficients (l <= Lo) of the product of the functions with
    coefficients ``a`` [..., (La + 1)^2] and ``b`` [..., (Lb + 1)^2]."""
    deg = La + Lb + Lo
    ea = a @ evaluate_at(La, deg, a.dtype, a.device)
    eb = b @ evaluate_at(Lb, deg, b.dtype, b.device)
    return (ea * eb) @ project_from(Lo, deg, a.dtype, a.device)


# -- the spec -----------------------------------------------------------------

@dataclass(frozen=True)
class GauntBlock:
    t: int
    irreps_x: Irreps
    irreps_mid: Irreps         # the convolution's and the residual's
    irreps_out: Irreps
    sc: object                 # linear x -> mid
    si1: object
    tp: object                 # the CG convolution (scalar-only input)
    radial: Tuple[int, ...]
    si2: object
    correlation: int

    @property
    def cg(self) -> bool:
        return self.tp is not None

    @property
    def mul(self) -> int:
        return self.irreps_mid[0].mul


@dataclass(frozen=True)
class GauntSpec:
    num_species: int
    cutoff: float
    bessel_num: int
    cutoff_fn: str
    poly_p: int
    cutoff_on: Optional[float]
    lmax_edge: int
    act_radial: str
    embed: object
    blocks: Tuple[GauntBlock, ...]
    lin1: object
    lin2: object


def build_spec(cfg: Dict) -> GauntSpec:
    """The layers of a 'gaunt' configuration: each layer's convolution
    output keeps l <= lmax_node of the harmonics' parity (128 channels
    each), the last layer's block output is scalars only."""
    if cfg.get('interaction_type') != 'gaunt':
        raise ValueError('the Gaunt reference takes interaction_type gaunt')
    n_sp = cfg['_number_of_species']
    channel = cfg.get('channel', 32)
    lmax = cfg.get('lmax', 1)
    lmax_edge = cfg.get('lmax_edge', -1)
    lmax_node = cfg.get('lmax_node', -1)
    lmax_edge = lmax_edge if lmax_edge > 0 else lmax
    lmax_node = lmax_node if lmax_node > 0 else lmax
    parity = -1 if cfg.get('is_parity', True) else 1
    n_layer = cfg.get('num_convolution_layer', 3)
    biases = cfg.get('use_bias_in_linear', False)
    rb = cfg.get('radial_basis', {})
    cf = cfg.get('cutoff_function', {'cutoff_function_name': 'poly_cut'})
    hidden = tuple(cfg.get('weight_nn_hidden_neurons', [64, 64]))
    bessel = rb.get('bessel_basis_num', 8)
    filt = Irreps.spherical_harmonics(lmax_edge, parity)
    x = Irreps(f'{channel}x0e')
    embed = linear_spec(Irreps(f'{n_sp}x0e'), x, biases=biases)
    blocks = []
    for t in range(n_layer):
        mid = tp_out_irreps(x, filt, lmax_node, 'sph',
                            fix_multiplicity=channel)
        last = t == n_layer - 1 and cfg.get('_restrict_last_layer', True)
        out = (tp_out_irreps(x, filt, 0, 'even', fix_multiplicity=channel)
               if last else mid)
        cg = x.lmax == 0 or mid.lmax == 0
        tp = uvu_tp_spec(x, filt, mid) if cg else None
        n_w = tp.weight_numel if cg else channel * len(mid)
        conv_out = tp.irreps_out.simplify() if cg else mid
        blocks.append(GauntBlock(
            t, x, mid, out, linear_spec(x, mid, biases=False),
            linear_spec(x, x, biases=biases), tp, (bessel,) + hidden + (n_w,),
            linear_spec(conv_out, mid, biases=biases),
            cfg.get('correlation', 3)))
        x = out
    half = Irreps(f'{channel // 2}x0e')
    return GauntSpec(
        num_species=n_sp, cutoff=float(cfg.get('cutoff', 4.5)),
        bessel_num=bessel,
        cutoff_fn=cf.get('cutoff_function_name', 'poly_cut'),
        poly_p=cf.get('poly_cut_p_value', 6), cutoff_on=cf.get('cutoff_on'),
        lmax_edge=lmax_edge, act_radial=cfg.get('act_radial', 'silu'),
        embed=embed, blocks=tuple(blocks),
        lin1=linear_spec(x, half, biases=biases),
        lin2=linear_spec(half, Irreps('1x0e'), biases=biases))


def param_shapes(spec: GauntSpec) -> Dict[str, Dict[str, Tuple[int, ...]]]:
    """Group -> leaf -> shape under the port's names."""
    def lin(s):
        return {f'w{i}': tuple(ins.weight_shape)
                for i, ins in enumerate(s.instructions)}

    out = {'edge_embedding': {'bessel_coeffs': (spec.bessel_num,)},
           'onehot_to_feature_x': lin(spec.embed)}
    for b in spec.blocks:
        t = b.t
        out[f'{t}_self_connection_intro'] = lin(b.sc)
        out[f'{t}_self_interaction_1'] = lin(b.si1)
        conv = {f'weight_nn_w{i}': (a, c) for i, (a, c)
                in enumerate(zip(b.radial[:-1], b.radial[1:]))}
        conv['denominator'] = (1,)
        out[f'{t}_convolution'] = conv
        out[f'{t}_self_interaction_2'] = lin(b.si2)
        out[f'{t}_gaunt_product_basis'] = {
            f'w{i}': (b.mul, b.irreps_mid.lmax + 1)
            for i in range(b.correlation)}
    out['reduce_input_to_hidden'] = lin(spec.lin1)
    out['reduce_hidden_to_energy'] = lin(spec.lin2)
    out['rescale_atomic_energy'] = {'shift': (1,), 'scale': (1,)}
    return out


def init_weights(cfg: Dict, seed: int, device):
    """Random weights of the configuration from ``seed``, as
    ``model.init_weights`` draws them."""
    from .model import init_weights as draw

    return draw(cfg, param_shapes(build_spec(cfg)), seed, device)


# -- the layers ---------------------------------------------------------------

def gaunt_conv(blk: GauntBlock, L_f: int, x: torch.Tensor,
               sh: torch.Tensor, w: torch.Tensor, src: torch.Tensor,
               dst: torch.Tensor, n_node: int) -> torch.Tensor:
    """sum over edges into dst of the projected products of the source
    features' functions and the edge's harmonics, weighted per l."""
    Lx, L = blk.irreps_x.lmax, blk.irreps_mid.lmax
    c = sphere_product(to_coeffs(x, blk.irreps_x)[src], Lx, sh[:, None, :],
                       L_f, L)
    ratio = gaunt_ratio(Lx, L_f)
    path = per_l(L, [math.sqrt(2 * l + 1) * ratio[l] for l in range(L + 1)])
    comp = per_l(L, list(range(L + 1)))
    wc = w.reshape(w.shape[0], blk.mul, L + 1)[:, :, comp] \
        * torch.as_tensor(path, dtype=w.dtype, device=w.device)
    msg = from_coeffs(c * wc, blk.irreps_mid)
    return msg.new_zeros((n_node, msg.shape[1])).index_add(0, dst, msg)


def product_basis(blk: GauntBlock, weights, x: torch.Tensor) -> torch.Tensor:
    """sum over nu <= correlation of f_0 ... f_{nu-1}, f_i = the features
    weighted per (channel, l) by ``w{i}``, projected onto l <= the block
    output's lmax and weighted per l."""
    Lx, Lo = blk.irreps_mid.lmax, blk.irreps_out.lmax
    nu = blk.correlation
    deg = nu * Lx + Lo
    E = evaluate_at(Lx, deg, x.dtype, x.device)
    c = to_coeffs(x, blk.irreps_mid)
    comp = per_l(Lx, list(range(Lx + 1)))
    prod = total = None
    for i in range(nu):
        fi = (c * weights[f'w{i}'][:, comp]) @ E
        prod = fi if prod is None else prod * fi
        total = prod if total is None else total + prod
    y = total @ project_from(Lo, deg, x.dtype, x.device)
    ratio = np.ones(Lo + 1)
    for k in range(1, nu):
        r = gaunt_ratio(k * Lx, Lx)
        ratio *= np.array([r[l] if l < len(r) else 1.0
                           for l in range(Lo + 1)])
    path = per_l(Lo, [math.sqrt(2 * l + 1) * ratio[l]
                      for l in range(Lo + 1)])
    y = y * torch.as_tensor(path, dtype=y.dtype, device=y.device)
    return from_coeffs(y, blk.irreps_out)


class GauntReference(Reference):
    """The reference potential of a 'gaunt' configuration: ``evaluate``
    (energy, forces, stress) as ``model.Reference``'s."""

    def __init__(self, cfg: Dict, params, device,
                 chunk: Optional[int] = None):
        self.spec = build_spec(cfg)
        self.device = torch.device(device)
        self.chunk = chunk
        self.p = {g: {n: torch.tensor(np.asarray(v, np.float32),
                                      device=self.device)
                      for n, v in names.items()}
                  for g, names in params.items()}

    def _gaunt(self, blk, x, sh, w, src, dst, n_node):
        L_f = self.spec.lmax_edge
        if blk.cg:
            def conv(xx, a, b, c, d):
                return uvu_conv(blk.tp, xx[c], a, b, d, n_node)
        else:
            def conv(xx, a, b, c, d):
                return gaunt_conv(blk, L_f, xx, a, b, c, d, n_node)
        if self.chunk is None or src.shape[0] <= self.chunk:
            return conv(x, sh, w, src, dst)
        out = None
        for lo in range(0, src.shape[0], self.chunk):
            s = slice(lo, lo + self.chunk)
            part = checkpoint(conv, x, sh[s], w[s], src[s], dst[s],
                              use_reentrant=False)
            out = part if out is None else out + part
        return out

    def atomic_energy(self, g: Dict[str, torch.Tensor],
                      vec: torch.Tensor) -> torch.Tensor:
        sp, p = self.spec, self.p
        r = safe_norm(vec)
        emb = bessel_basis(r, p['edge_embedding']['bessel_coeffs'],
                           sp.cutoff)
        if sp.cutoff_fn == 'poly_cut':
            env = poly_cutoff(r, sp.cutoff, sp.poly_p)
        else:
            env = xplor_cutoff(r, sp.cutoff, sp.cutoff_on)
        emb = emb * env[:, None]
        sh = spherical_harmonics(sp.lmax_edge)(vec)
        types = g['types']
        n_node = types.shape[0]
        onehot = F.one_hot(types, sp.num_species).to(vec.dtype)
        x = apply_linear(sp.embed, _ws(p['onehot_to_feature_x']), onehot)
        for blk in sp.blocks:
            t = blk.t
            sc = apply_linear(blk.sc, _ws(p[f'{t}_self_connection_intro']),
                              x)
            x = apply_linear(blk.si1, _ws(p[f'{t}_self_interaction_1']), x)
            cp = p[f'{t}_convolution']
            w = mlp_apply([cp[f'weight_nn_w{i}']
                           for i in range(len(blk.radial) - 1)],
                          emb, sp.act_radial)
            x = self._gaunt(blk, x, sh, w, g['src'], g['dst'], n_node) \
                / cp['denominator']
            x = apply_linear(blk.si2, _ws(p[f'{t}_self_interaction_2']), x)
            x = product_basis(blk, p[f'{t}_gaunt_product_basis'], x + sc)
        h = apply_linear(sp.lin1, _ws(p['reduce_input_to_hidden']), x)
        e = apply_linear(sp.lin2, _ws(p['reduce_hidden_to_energy']), h)[:, 0]
        rs = p['rescale_atomic_energy']
        return e * rs['scale'][0] + rs['shift'][0]
