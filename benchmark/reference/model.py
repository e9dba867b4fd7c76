"""Plain-PyTorch reference of the two model families the benchmark runs.

SevenNet-0 ('nequip' interaction) and the MACE family ('mace'), float32,
with every product written out: the spherical harmonics, the Bessel basis
and its cutoff, the radial MLP, the per-edge 'uvu' Clebsch-Gordan product
of each convolution (sh x CG first, then a batched product with the
gathered source features, weighted per edge), its sum over destinations
with ``index_add_``, the equivariant linears, the gate or the symmetric
contraction, the readout and the rescale.  Forces and the virial stress
come from one ``torch.autograd.grad`` of the total energy over the edge
vectors.  It builds its own spec from the configuration dict (the
layer-by-layer irreps rules of the model builder) and takes the weights as
a dict of numpy arrays under the JAX package's names.  The small modules
beside this file are frozen copies of the port's plain irreps algebra.

``chunk`` evaluates each convolution over slices of that many edges under
``torch.utils.checkpoint``, so a force evaluation of a large structure
holds one slice's per-edge products at a time.  Leave it None where the
graph is differentiated twice (a train step).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from .gate import apply_gate, gate_spec
from .irreps import Irreps, tp_out_irreps
from .linear import apply_linear, linear_spec
from .mlp import mlp_apply
from .radial import bessel_basis, poly_cutoff, xplor_cutoff
from .spherical import spherical_harmonics
from .symmetric_contraction import (apply_sym_contraction,
                                    sym_contraction_spec)
from .tensor_product import apply_tp, fctp_spec, uvu_tp_spec
from .util import safe_norm
from .wigner import wigner_3j


@dataclass(frozen=True)
class Block:
    t: int
    kind: str                  # 'nequip' | 'mace'
    sc_kind: str               # 'nequip' (FCTP) | 'linear' | 'none'
    sc: object
    si1: object
    tp: object                 # the convolution's uvu TensorProductSpec
    radial: Tuple[int, ...]    # the radial MLP's widths
    si2: object
    gate: object = None
    pb: object = None          # the symmetric contraction (mace)
    si3: object = None


@dataclass(frozen=True)
class Spec:
    num_species: int
    cutoff: float
    bessel_num: int
    cutoff_fn: str
    poly_p: int
    cutoff_on: Optional[float]
    lmax_edge: int
    normalize_sph: bool
    act_radial: str
    radial_shift: float
    radial_scale: float
    embed: object
    blocks: Tuple[Block, ...]
    lin1: object
    lin2: object


def build_spec(cfg: Dict) -> Spec:
    """The layer-by-layer irreps of a 'nequip' or 'mace' configuration
    (channel, lmax / lmax_edge / lmax_node, parity, irreps_manual, the
    last layer restricted to scalars)."""
    kind = cfg.get('interaction_type', 'nequip')
    if kind not in ('nequip', 'mace'):
        raise ValueError(f'the reference has no {kind!r} interaction')
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
    sc_kind = cfg.get('self_connection_type', 'nequip')
    act_s = cfg.get('act_scalar', {'e': 'silu', 'o': 'tanh'})
    act_g = cfg.get('act_gate', {'e': 'silu', 'o': 'tanh'})
    manual = cfg.get('irreps_manual', False)
    manual = [Irreps(s) for s in manual] if manual else None
    restrict = cfg.get('_restrict_last_layer', True)
    filt = Irreps.spherical_harmonics(lmax_edge, parity)
    onehot_irreps = Irreps(f'{n_sp}x0e')

    irreps_x = manual[0] if manual else Irreps(f'{channel}x0e')
    embed = linear_spec(onehot_irreps, irreps_x, biases=biases)
    blocks = []
    cur = lmax_node
    for t in range(n_layer):
        last = t == n_layer - 1 and restrict
        if kind == 'mace':
            out_tp = tp_out_irreps(irreps_x, filt, lmax_edge, 'sph')
            mode = 'sph'
        else:
            mode = 'full'
            if last:
                cur, mode = 0, 'even'
            out_tp = tp_out_irreps(irreps_x, filt, cur, mode)
        if kind == 'mace' and last:
            cur, mode = 0, 'even'
        out = (manual[t + 1] if manual else
               tp_out_irreps(irreps_x, filt, cur, mode,
                             fix_multiplicity=channel))
        tp = uvu_tp_spec(irreps_x, filt, out_tp)
        si1 = linear_spec(irreps_x, irreps_x, biases=biases)
        if kind == 'mace':
            target = out
        else:
            gate = gate_spec(out, act_s, act_g)
            target = gate.irreps_in
        if sc_kind == 'nequip':
            sc = fctp_spec(irreps_x, onehot_irreps, target)
        elif sc_kind == 'linear':
            sc = linear_spec(irreps_x, target, biases=False)
        else:
            sc = None
        radial = (bessel,) + hidden + (tp.weight_numel,)
        if kind == 'mace':
            mul = out[0].mul
            si2_out = Irreps([(mul, mi.ir) for mi in out_tp])
            si2 = linear_spec(tp.irreps_out.simplify(), si2_out,
                              biases=biases)
            pb = sym_contraction_spec(si2_out, out,
                                      cfg.get('correlation', 3), n_sp)
            blocks.append(Block(t, kind, sc_kind, sc, si1, tp, radial, si2,
                                pb=pb, si3=linear_spec(out, out,
                                                       biases=biases)))
            irreps_x = out
        else:
            si2 = linear_spec(tp.irreps_out.simplify(), target,
                              biases=biases)
            blocks.append(Block(t, kind, sc_kind, sc, si1, tp, radial, si2,
                                gate=gate))
            irreps_x = gate.irreps_out
    mid = manual[-1].num_irreps if manual else channel
    hidden_irreps = Irreps(f'{mid // 2}x0e')
    return Spec(
        num_species=n_sp, cutoff=float(cfg.get('cutoff', 4.5)),
        bessel_num=bessel,
        cutoff_fn=cf.get('cutoff_function_name', 'poly_cut'),
        poly_p=cf.get('poly_cut_p_value', 6),
        cutoff_on=cf.get('cutoff_on'), lmax_edge=lmax_edge,
        normalize_sph=cfg.get('_normalize_sph', True),
        act_radial=cfg.get('act_radial', 'silu'),
        radial_shift=float(cfg.get('_radial_weight_shift', 0.0)),
        radial_scale=float(cfg.get('_radial_weight_scale', 1.0)),
        embed=embed, blocks=tuple(blocks),
        lin1=linear_spec(irreps_x, hidden_irreps, biases=biases),
        lin2=linear_spec(hidden_irreps, Irreps('1x0e'), biases=biases))


def _ws(group: Dict[str, torch.Tensor]) -> List[torch.Tensor]:
    return [group[f'w{i}'] for i in range(len(group))]


def uvu_conv(tp, x_src: torch.Tensor, sh: torch.Tensor, w: torch.Tensor,
             dst: torch.Tensor, n_node: int) -> torch.Tensor:
    """sum over edges into dst of the 'uvu' product: for each path
    (l1, l2 -> l_out) of ``tp``, coeff * w[e, u] * sum_ij x[e, u, i]
    sh[e, j] C[i, j, k], laid out as ``tp.irreps_out`` (e3nn order)."""
    sl1 = tp.irreps_in1.slices()
    sl2 = tp.irreps_in2.slices()
    E = x_src.shape[0]
    chunks: List[Optional[torch.Tensor]] = [None] * len(tp.irreps_out)
    for ins in tp.instructions:
        m1 = tp.irreps_in1[ins.i_in1]
        m2 = tp.irreps_in2[ins.i_in2]
        mo = tp.irreps_out[ins.i_out]
        a = x_src[:, sl1[ins.i_in1]].reshape(E, m1.mul, m1.ir.dim)
        b = sh[:, sl2[ins.i_in2]]
        C = torch.as_tensor(wigner_3j(m1.ir.l, m2.ir.l, mo.ir.l),
                            dtype=x_src.dtype, device=x_src.device)
        bc = torch.einsum('ej,ijk->eik', b, C)
        y = torch.bmm(a, bc)                                   # [E, u, k]
        wi = w[:, ins.weight_offset:ins.weight_offset + m1.mul]
        y = (ins.coeff * wi)[:, :, None] * y
        y = y.reshape(E, mo.dim)
        chunks[ins.i_out] = y if chunks[ins.i_out] is None \
            else chunks[ins.i_out] + y
    msg = torch.cat(chunks, dim=-1)
    out = msg.new_zeros((n_node, msg.shape[1]))
    return out.index_add(0, dst, msg)


class Reference:
    """The reference potential: ``spec`` from the configuration, the
    weights as float32 tensors on ``device``."""

    def __init__(self, cfg: Dict, params: Dict[str, Dict[str, np.ndarray]],
                 device, chunk: Optional[int] = None):
        self.spec = build_spec(cfg)
        self.device = torch.device(device)
        self.chunk = chunk
        self.p = {g: {n: torch.tensor(np.asarray(v, np.float32),
                                      device=self.device)
                      for n, v in names.items()}
                  for g, names in params.items()}

    def leaves(self):
        return [(g, n, v) for g, names in self.p.items()
                for n, v in names.items()]

    # -- the energy -------------------------------------------------------
    def _conv(self, blk, x, sh, w, src, dst, n_node):
        if self.chunk is None or src.shape[0] <= self.chunk:
            return uvu_conv(blk.tp, x[src], sh, w, dst, n_node)
        out = None
        for lo in range(0, src.shape[0], self.chunk):
            s = slice(lo, lo + self.chunk)
            part = checkpoint(
                lambda xx, a, b, c, d: uvu_conv(blk.tp, xx[c], a, b, d,
                                                n_node),
                x, sh[s], w[s], src[s], dst[s], use_reentrant=False)
            out = part if out is None else out + part
        return out

    def atomic_energy(self, g: Dict[str, torch.Tensor],
                      vec: torch.Tensor) -> torch.Tensor:
        """Per-atom energies of the graph ``g`` (types, src, dst) at edge
        vectors ``vec`` (pos[src] - pos[dst] + shift)."""
        sp, p = self.spec, self.p
        r = safe_norm(vec)
        emb = bessel_basis(r, p['edge_embedding']['bessel_coeffs'],
                           sp.cutoff)
        if sp.cutoff_fn == 'poly_cut':
            env = poly_cutoff(r, sp.cutoff, sp.poly_p)
        else:
            env = xplor_cutoff(r, sp.cutoff, sp.cutoff_on)
        emb = emb * env[:, None]
        if sp.radial_shift != 0.0 or sp.radial_scale != 1.0:
            emb = (emb - sp.radial_shift) * sp.radial_scale
        sh = spherical_harmonics(sp.lmax_edge,
                                 normalize=sp.normalize_sph)(vec)
        types = g['types']
        n_node = types.shape[0]
        onehot = F.one_hot(types, sp.num_species).to(vec.dtype)
        x = apply_linear(sp.embed, _ws(p['onehot_to_feature_x']), onehot)
        src, dst = g['src'], g['dst']
        for blk in sp.blocks:
            t = blk.t
            sc = None
            if blk.sc_kind == 'nequip':
                sc = apply_tp(blk.sc, x, onehot,
                              _ws(p[f'{t}_self_connection_intro']))
            elif blk.sc_kind == 'linear':
                sc = apply_linear(blk.sc,
                                  _ws(p[f'{t}_self_connection_intro']), x)
            x = apply_linear(blk.si1, _ws(p[f'{t}_self_interaction_1']), x)
            cp = p[f'{t}_convolution']
            w = mlp_apply([cp[f'weight_nn_w{i}']
                           for i in range(len(blk.radial) - 1)],
                          emb, sp.act_radial)
            x = self._conv(blk, x, sh, w, src, dst, n_node) \
                / cp['denominator']
            x = apply_linear(blk.si2, _ws(p[f'{t}_self_interaction_2']), x)
            if blk.kind == 'mace':
                x = apply_sym_contraction(
                    blk.pb, p[f'{t}_equivariant_product_basis'], x, onehot)
                x = apply_linear(blk.si3,
                                 _ws(p[f'{t}_self_interaction_3']), x)
                if sc is not None:
                    x = x + sc
            else:
                if sc is not None:
                    x = x + sc
                x = apply_gate(blk.gate, x)
        h = apply_linear(sp.lin1, _ws(p['reduce_input_to_hidden']), x)
        e = apply_linear(sp.lin2, _ws(p['reduce_hidden_to_energy']), h)[:, 0]
        rs = p['rescale_atomic_energy']
        if rs['scale'].shape[0] > 1:
            return e * rs['scale'][types] + rs['shift'][types]
        return e * rs['scale'][0] + rs['shift'][0]

    def evaluate(self, g: Dict[str, torch.Tensor], create_graph=False):
        """Energy per graph, forces [N, 3] and the stress per graph
        (Voigt xx yy zz xy yz zx, eV/A^3, negated virial over the
        volume) of the graph ``g`` (``graph.batch_graphs``)."""
        pos = g['pos']
        src, dst = g['src'], g['dst']
        with torch.enable_grad():
            vec = (pos[src] - pos[dst] + g['shift'])
            if not create_graph:
                vec = vec.detach()
            vec.requires_grad_(True)
            e_atom = self.atomic_energy(g, vec)
            energy = e_atom.new_zeros(g['n_graph']).index_add(
                0, g['batch'], e_atom)
            fij, = torch.autograd.grad(energy.sum(), vec,
                                       create_graph=create_graph)
        n = pos.shape[0]
        forces = (fij.new_zeros((n, 3)).index_add(0, dst, fij)
                  - fij.new_zeros((n, 3)).index_add(0, src, fij))
        voigt = torch.stack([vec[:, 0] * fij[:, 0], vec[:, 1] * fij[:, 1],
                             vec[:, 2] * fij[:, 2], vec[:, 0] * fij[:, 1],
                             vec[:, 1] * fij[:, 2], vec[:, 2] * fij[:, 0]],
                            dim=-1)
        virial = voigt.new_zeros((g['n_graph'], 6)).index_add(
            0, g['batch'][dst], voigt)
        stress = -virial / g['volume'][:, None]
        if not create_graph:
            energy, forces, stress = (energy.detach(), forces.detach(),
                                      stress.detach())
        return energy, forces, stress


def init_weights(cfg: Dict, shapes: Dict[str, Dict[str, Tuple[int, ...]]],
                 seed: int, device) -> Dict[str, Dict[str, np.ndarray]]:
    """Random weights for ``shapes`` from ``seed``, drawn on ``device`` in
    one call: standard normal (the e3nn initialization the layers'
    1/sqrt(fan_in) normalizations assume; the symmetric contraction's
    divided by its paths), the Bessel frequencies n pi / r_c, the
    denominators, shift and scale from ``cfg``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (2 ** 63))
    names = [(g, n, s) for g, ns in shapes.items() for n, s in ns.items()]
    total = sum(int(np.prod(s)) for _, _, s in names)
    flat = torch.randn(total, generator=gen, device=device).cpu().numpy()
    out: Dict[str, Dict[str, np.ndarray]] = {}
    off = 0
    n_layer = cfg.get('num_convolution_layer', 3)
    denom = cfg.get('conv_denominator', 1.0)
    if not isinstance(denom, (list, tuple)):
        denom = [denom] * n_layer
    for g, n, s in names:
        k = int(np.prod(s))
        v = flat[off:off + k].reshape(s).astype(np.float32)
        off += k
        if g.endswith('_equivariant_product_basis'):
            v = v / max(s[1], 1)
        out.setdefault(g, {})[n] = v
    cut = float(cfg['cutoff'])
    nb = cfg.get('radial_basis', {}).get('bessel_basis_num', 8)
    out['edge_embedding']['bessel_coeffs'] = (
        np.arange(1, nb + 1) * math.pi / cut).astype(np.float32)
    for t in range(n_layer):
        out[f'{t}_convolution']['denominator'] = np.array(
            [denom[t]], np.float32)
    out['rescale_atomic_energy'] = {
        'shift': np.array([cfg['shift']], np.float32).reshape(-1),
        'scale': np.array([cfg['scale']], np.float32).reshape(-1)}
    return out


def param_shapes(spec: Spec) -> Dict[str, Dict[str, Tuple[int, ...]]]:
    """Group -> leaf -> shape under the JAX package's names."""
    def lin(s):
        return {f'w{i}': tuple(ins.weight_shape)
                for i, ins in enumerate(s.instructions)}

    out = {'edge_embedding': {'bessel_coeffs': (spec.bessel_num,)},
           'onehot_to_feature_x': lin(spec.embed)}
    for b in spec.blocks:
        t = b.t
        if b.sc is not None:
            out[f'{t}_self_connection_intro'] = lin(b.sc)
        out[f'{t}_self_interaction_1'] = lin(b.si1)
        conv = {f'weight_nn_w{i}': (a, c) for i, (a, c)
                in enumerate(zip(b.radial[:-1], b.radial[1:]))}
        conv['denominator'] = (1,)
        out[f'{t}_convolution'] = conv
        out[f'{t}_self_interaction_2'] = lin(b.si2)
        if b.kind == 'mace':
            from .symmetric_contraction import sym_contraction_shapes
            out[f'{t}_equivariant_product_basis'] = sym_contraction_shapes(
                b.pb)
            out[f'{t}_self_interaction_3'] = lin(b.si3)
    out['reduce_input_to_hidden'] = lin(spec.lin1)
    out['reduce_hidden_to_energy'] = lin(spec.lin2)
    out['rescale_atomic_energy'] = {'shift': (1,), 'scale': (1,)}
    return out
