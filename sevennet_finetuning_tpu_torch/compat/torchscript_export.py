"""Export a trained model as a reference-compatible TorchScript file.

The inverse of ``compat.torchscript_import``: a model fine-tuned here can
be dropped into ANY existing LAMMPS setup built for the reference -- the
artifact mirrors the reference's serial deploy contract exactly
(reference: sevenn/scripts/deploy.py:15-51):

- input:  the dict the C++ pair style builds (reference:
  pair_e3gnn/pair_e3gnn.cpp:205-215): ``x`` (type indices), ``pos``
  (requires_grad, float32), ``edge_index`` [2, E], ``pbc_shift`` [E, 3]
  fractional, ``cell_lattice_vectors`` [3, 3], ``cell_volume``,
  ``num_atoms``;
- output: ``inferred_total_energy``, ``inferred_force`` (-dE/dpos),
  ``inferred_stress`` (-strain grad / volume, Voigt xx yy zz xy yz xz),
  ``atomic_energy`` [N, 1] (read back at pair_e3gnn.cpp:231-266);
- metadata ``_extra_files`` with the keys ``coeff`` parses
  (pair_e3gnn.cpp:307-331): chemical_symbols_to_index, cutoff,
  num_species, model_type, version, dtype, time.

Strategy: the structural math is EXTRACTED from the model's ops rather
than re-derived -- every linear piece (equivariant linears, one-hot embed,
self-connection FCTP per species) is materialized as a dense matrix by
pushing a basis through the op; spherical harmonics become an exactly
fitted monomial table; the CG convolution reuses the grouped
coefficient blocks of ops.fused_conv.  The exported graph is plain
torch (scripted + frozen), no e3nn dependency.

Supported: the NequIP/SevenNet-0 block family (cg conv + gate +
nequip/linear/none self-connection), linear or FCN readout, bessel x
poly/XPLOR edge embedding, scalar or species-wise rescale.  MACE /
Gaunt blocks have no TorchScript deploy target in the reference and
raise.

Port of ``sevennet_finetuning_tpu/compat/torchscript_export.py``: the
basis is pushed through this package's ``apply_linear`` / ``apply_tp`` /
``spherical_harmonics`` on CPU tensors in float32 under
``torch.no_grad()``, and the artifact is the same plain TorchScript (the
format LAMMPS ``pair_e3gnn`` loads, which cannot load this package's CUDA
kernels), saved from the CPU so it loads on any device.
"""

import functools
import math
from datetime import datetime
from typing import Dict, List, Tuple

import numpy as np
import torch

from ..data.elements import z_to_symbol
from ..irreps import Irreps
from ..model.nequip import ModelSpec, _linear_w
from ..ops.activations import moment2_const
from ..ops.fused_conv import _group_ccat, layout_from_spec
from ..ops.linear import apply_linear
from ..ops.spherical import spherical_harmonics
from ..ops.tensor_product import apply_tp

_ACT_CODE = {'silu': 0, 'ssp': 1, 'tanh': 2, 'abs': 3, 'relu': 4}


def _act_name_of(fn) -> str:
    """Recover the activation name from a cached get_activation result."""
    from ..ops.activations import get_activation

    for name in _ACT_CODE:
        if fn is get_activation(name, normalized=True) \
                or fn is get_activation(name, normalized=False):
            return name
    raise ValueError('unrecognized activation callable')


def _cpu32(a) -> torch.Tensor:
    """A weight (numpy array or tensor) as a float32 CPU tensor."""
    if isinstance(a, torch.Tensor):
        return a.detach().to('cpu', torch.float32)
    return torch.as_tensor(np.asarray(a, np.float32))


def _dense_linear(ls, weights) -> tuple:
    """[dim_in, dim_out] matrix (+bias) extracted by pushing a basis."""
    dim_in = ls.irreps_in.dim
    w = [_cpu32(v) for v in weights]
    with torch.no_grad():
        out = apply_linear(ls, w, torch.eye(dim_in)).numpy()
        bias = apply_linear(ls, w, torch.zeros(1, dim_in)).numpy()[0]
    return (out - bias[None]).astype(np.float32), bias.astype(np.float32)


def _dense_fctp_species(tp_spec, weights, num_species) -> np.ndarray:
    """Self-connection FCTP with one-hot node_attr -> per-species dense
    maps [S, dim_in, dim_out]."""
    dim_in = tp_spec.irreps_in1.dim
    eye = torch.eye(dim_in)
    w = [_cpu32(v) for v in weights]
    mats = []
    with torch.no_grad():
        for s in range(num_species):
            onehot = torch.zeros(dim_in, num_species)
            onehot[:, s] = 1.0
            mats.append(apply_tp(tp_spec, eye, onehot, w).numpy())
    return np.stack(mats).astype(np.float32)


def _sh_monomial_table(lmax: int) -> List[np.ndarray]:
    """Per-l monomial coefficient tables: SH_l(v) for |v|=1 equals
    monomials_l(v) @ T_l, with monomials x^a y^b z^c, a+b+c=l, in
    lexicographic (a, b, c) order.  Fitted exactly (the components are
    homogeneous degree-l polynomials; the fit residual is ~1e-13)."""
    sh = spherical_harmonics(lmax, normalize=False)
    rng = np.random.default_rng(0)
    tables = []
    for l in range(lmax + 1):
        monos = [(a, b, l - a - b)
                 for a in range(l + 1) for b in range(l - a + 1)]
        n = len(monos)
        pts = rng.standard_normal((max(4 * n, 32), 3))
        A = np.stack([
            np.prod(pts ** np.array(m, float), axis=1) for m in monos
        ], axis=1)
        with torch.no_grad():
            Y = sh(torch.as_tensor(pts.astype(np.float32))).numpy()
        Y = Y.astype(np.float64)
        off = l * l
        Yl = Y[:, off:off + 2 * l + 1]
        T, *_ = np.linalg.lstsq(A, Yl, rcond=None)
        resid = np.abs(A @ T - Yl).max()
        assert resid < 1e-4, f'SH fit failed at l={l}: {resid}'
        tables.append(T.astype(np.float32))
    return tables


@functools.lru_cache(maxsize=None)
def _tmods():
    """Torch building-block modules shared by the serial and parallel
    exporters."""
    import torch.nn as nn

    class ShiftedSoftplus(nn.Module):
        def forward(self, x):
            return torch.nn.functional.softplus(x) - math.log(2.0)

    class NormAct(nn.Module):
        """Second-moment-normalized activation (e3nn normalize2mom)."""

        def __init__(self, name):
            super().__init__()
            self.code = _ACT_CODE[name]
            self.c = float(moment2_const(name))

        def forward(self, x):
            if self.code == 0:
                y = torch.nn.functional.silu(x)
            elif self.code == 1:
                y = torch.nn.functional.softplus(x) - 0.6931471805599453
            elif self.code == 2:
                y = torch.tanh(x)
            elif self.code == 3:
                y = torch.abs(x)
            else:
                y = torch.relu(x)
            return y * self.c

    class DenseLinear(nn.Module):
        def __init__(self, ls, weights):
            super().__init__()
            M, b = _dense_linear(ls, weights)
            self.register_buffer('M', torch.from_numpy(M))
            self.register_buffer('b', torch.from_numpy(b))

        def forward(self, x):
            return x @ self.M + self.b

    class RadialMLP(nn.Module):
        def __init__(self, hs, weights, act_name):
            super().__init__()
            self.acts = nn.ModuleList()
            layers = []
            for i, w in enumerate(weights):
                lin = nn.Linear(w.shape[0], w.shape[1], bias=False)
                with torch.no_grad():
                    lin.weight.copy_(torch.from_numpy(
                        np.asarray(w).T / math.sqrt(w.shape[0])))
                layers.append(lin)
            self.layers = nn.ModuleList(layers)
            self.act = NormAct(act_name)

        def forward(self, x):
            n = len(self.layers)
            i = 0
            for lin in self.layers:
                x = lin(x)
                if i < n - 1:
                    x = self.act(x)
                i += 1
            return x

    class ConvGroup(nn.Module):
        msg_offs: List[int]
        d_outs: List[int]
        w_offs: List[int]

        def __init__(self, grp):
            super().__init__()
            self.x_off = int(grp.x_off)
            self.d1 = int(grp.d1)
            self.mul = int(grp.mul)
            self.sh_off = int(grp.sh_off)
            self.d2 = int(grp.d2)
            self.register_buffer(
                'ccat', torch.from_numpy(_group_ccat(grp).copy()))
            self.msg_offs = [int(p.msg_off) for p in grp.paths]
            self.d_outs = [int(p.d_out) for p in grp.paths]
            self.w_offs = [int(p.w_off) for p in grp.paths]

        def forward(self, x_src, sh, w, msg):
            xg = x_src[:, self.x_off:self.x_off + self.mul * self.d1]
            xg = xg.reshape(-1, self.mul, self.d1)
            shg = sh[:, self.sh_off:self.sh_off + self.d2]
            m0 = torch.einsum('eui,ej,ijk->euk', xg, shg, self.ccat)
            k0 = 0
            for p in range(len(self.msg_offs)):
                d = self.d_outs[p]
                wp = w[:, self.w_offs[p]:self.w_offs[p] + self.mul]
                mp = m0[:, :, k0:k0 + d] * wp.unsqueeze(-1)
                k0 += d
                off = self.msg_offs[p]
                msg[:, off:off + self.mul * d] = mp.reshape(
                    -1, self.mul * d)
            return msg

    class Gate(nn.Module):
        scalar_slices: List[Tuple[int, int]]
        gate_slices: List[Tuple[int, int]]
        gated_muls: List[int]
        gated_dims: List[int]

        def __init__(self, gs):
            super().__init__()
            self.register_buffer(
                'perm', torch.tensor(list(gs.perm), dtype=torch.long))
            self.n_scalars = gs.irreps_scalars.dim
            self.n_gates = gs.irreps_gates.dim
            self.scalar_slices = []
            off = 0
            acts_s = []
            for mi, fn in zip(gs.irreps_scalars, gs.act_scalars):
                self.scalar_slices.append((off, mi.dim))
                acts_s.append(NormAct(_act_name_of(fn)))
                off += mi.dim
            self.acts_s = nn.ModuleList(acts_s)
            self.gate_slices = []
            off = 0
            acts_g = []
            for mi, fn in zip(gs.irreps_gates, gs.act_gates):
                self.gate_slices.append((off, mi.dim))
                acts_g.append(NormAct(_act_name_of(fn)))
                off += mi.dim
            self.acts_g = nn.ModuleList(acts_g)
            # gated chunk layout: [mul, d] per entry; gates are one
            # scalar per mul, broadcast over d
            self.gated_muls = [int(mi.mul) for mi in gs.irreps_gated]
            self.gated_dims = [int(mi.ir.dim) for mi in gs.irreps_gated]

        def forward(self, x):
            x = x[:, self.perm]
            scalars = x[:, :self.n_scalars]
            gates = x[:, self.n_scalars:self.n_scalars + self.n_gates]
            gated = x[:, self.n_scalars + self.n_gates:]
            s_out = torch.zeros_like(scalars)
            i = 0
            for act in self.acts_s:
                off, dim = self.scalar_slices[i]
                s_out[:, off:off + dim] = act(scalars[:, off:off + dim])
                i += 1
            g_act = torch.zeros_like(gates)
            i = 0
            for act in self.acts_g:
                off, dim = self.gate_slices[i]
                g_act[:, off:off + dim] = act(gates[:, off:off + dim])
                i += 1
            outs = [s_out]
            goff = 0
            xoff = 0
            for i in range(len(self.gated_muls)):
                mul = self.gated_muls[i]
                d = self.gated_dims[i]
                chunk = gated[:, xoff:xoff + mul * d].reshape(-1, mul, d)
                g = g_act[:, goff:goff + mul].unsqueeze(-1)
                outs.append((chunk * g).reshape(-1, mul * d))
                goff += mul
                xoff += mul * d
            return torch.cat(outs, dim=1)

    import types as _types

    return _types.SimpleNamespace(
        torch=torch, nn=nn, ShiftedSoftplus=ShiftedSoftplus,
        NormAct=NormAct, DenseLinear=DenseLinear, RadialMLP=RadialMLP,
        ConvGroup=ConvGroup, Gate=Gate,
    )


def build_torch_model(spec: ModelSpec, params):
    """Assemble the plain-torch deploy module (host-side, CPU)."""
    import torch.nn as nn

    for blk in spec.blocks:
        if blk.block_type != 'nequip' or blk.conv_kind != 'cg':
            raise NotImplementedError(
                'TorchScript export covers the NequIP/SevenNet-0 block '
                f'family; got block type {blk.block_type!r} '
                f'(conv {blk.conv_kind!r})'
            )

    es = spec.edge
    lmax = es.lmax_edge
    sh_tables = _sh_monomial_table(lmax)

    from ..ops.linear import linear_spec

    one_hot_irreps = Irreps(f'{spec.num_species}x0e')
    embed_ls = linear_spec(one_hot_irreps, spec.blocks[0].irreps_x,
                           biases=spec.use_bias_in_linear)

    def P(name):
        return {k: np.asarray(v) for k, v in params[name].items()}

    T = _tmods()
    NormAct = T.NormAct
    DenseLinear = T.DenseLinear
    RadialMLP = T.RadialMLP
    ConvGroup = T.ConvGroup
    Gate = T.Gate

    class Block(nn.Module):
        def __init__(self, blk):
            super().__init__()
            t = blk.t
            self.sc_kind = {'nequip': 0, 'linear': 1,
                            'none': 2}[blk.self_connection]
            if self.sc_kind == 0:
                mats = _dense_fctp_species(
                    blk.sc_spec,
                    _linear_w(params[f'{t}_self_connection_intro']),
                    spec.num_species,
                )
                self.register_buffer('sc_mats', torch.from_numpy(mats))
            elif self.sc_kind == 1:
                M, b = _dense_linear(
                    blk.sc_spec,
                    _linear_w(params[f'{t}_self_connection_intro']))
                self.register_buffer('sc_mats', torch.from_numpy(
                    M[None]))
            else:
                self.register_buffer('sc_mats', torch.zeros(1, 1, 1))
            self.si1 = DenseLinear(
                blk.si1, _linear_w(params[f'{t}_self_interaction_1']))
            conv_p = params[f'{t}_convolution']
            n_w = len(blk.radial_hs) - 1
            self.radial = RadialMLP(
                blk.radial_hs,
                [np.asarray(conv_p[f'weight_nn_w{i}'])
                 for i in range(n_w)],
                blk.act_radial,
            )
            layout = layout_from_spec(blk.conv_tp)
            self.groups = nn.ModuleList(
                [ConvGroup(g) for g in layout.groups])
            self.dim_msg = int(layout.dim_msg)
            self.denominator = float(np.asarray(conv_p['denominator'])[0])
            self.si2 = DenseLinear(
                blk.si2, _linear_w(params[f'{t}_self_interaction_2']))
            self.gate = Gate(blk.gate)

        def forward(self, x, onehot_idx, emb, sh, edge_src, edge_dst):
            if self.sc_kind == 0:
                sc = torch.bmm(
                    x.unsqueeze(1), self.sc_mats[onehot_idx]
                ).squeeze(1)
            elif self.sc_kind == 1:
                sc = x @ self.sc_mats[0]
            else:
                sc = torch.zeros(1)
            x = self.si1(x)
            w = self.radial(emb)
            x_src = x[edge_src]
            msg = torch.zeros(
                (x_src.shape[0], self.dim_msg),
                dtype=x.dtype, device=x.device,
            )
            for grp in self.groups:
                msg = grp(x_src, sh, w, msg)
            agg = torch.zeros(
                (x.shape[0], self.dim_msg), dtype=x.dtype,
                device=x.device,
            )
            idx = edge_dst.unsqueeze(-1).expand(-1, self.dim_msg)
            agg.scatter_reduce_(0, idx, msg, reduce='sum')
            x = agg / self.denominator
            x = self.si2(x)
            if self.sc_kind != 2:
                x = x + sc
            return self.gate(x)

    class Exported(nn.Module):
        def __init__(self):
            super().__init__()
            ep = P('edge_embedding')
            self.register_buffer(
                'bessel_coeffs',
                torch.from_numpy(ep['bessel_coeffs'].astype(np.float32)))
            self.cutoff = float(es.cutoff)
            self.poly_p = float(es.poly_cut_p)
            self.use_xplor = es.cutoff_function == 'XPLOR'
            self.cutoff_on = float(es.cutoff_on or 0.0)
            self.w_shift = float(es.weight_shift)
            self.w_scale = float(es.weight_scale)
            self.lmax = int(lmax)
            assert lmax <= 3, 'SH monomial export table covers lmax<=3'
            for l in range(4):
                # all four attributes must exist: TorchScript compiles
                # every branch of _spherical even for smaller lmax
                T = sh_tables[l] if l <= lmax else np.zeros(
                    (1, 1), np.float32)
                self.register_buffer(f'sh_t{l}', torch.from_numpy(T))
            self.num_species = int(spec.num_species)
            self.embed = DenseLinear(
                embed_ls, _linear_w(params['onehot_to_feature_x']))
            self.blocks = nn.ModuleList(
                [Block(b) for b in spec.blocks])
            self.as_fcn = bool(spec.readout.as_fcn)
            if self.as_fcn:
                ro = params['readout_FCN']
                n_w = len(spec.readout.fcn_hs) - 1
                self.fcn = RadialMLP(
                    spec.readout.fcn_hs,
                    [np.asarray(ro[f'w{i}']) for i in range(n_w)],
                    spec.readout.fcn_act,
                )
                self.ro1 = nn.Identity()
                self.ro2 = nn.Identity()
            else:
                self.fcn = nn.Identity()
                self.ro1 = DenseLinear(
                    spec.readout.lin1,
                    _linear_w(params['reduce_input_to_hidden']))
                self.ro2 = DenseLinear(
                    spec.readout.lin2,
                    _linear_w(params['reduce_hidden_to_energy']))
            rp = P('rescale_atomic_energy')
            self.register_buffer(
                'shift', torch.from_numpy(rp['shift'].astype(np.float32)))
            self.register_buffer(
                'scale', torch.from_numpy(rp['scale'].astype(np.float32)))

        def _spherical(self, v):
            vn = v / torch.clamp(
                torch.linalg.norm(v, dim=-1, keepdim=True), min=1e-12)
            x = vn[:, 0:1]
            y = vn[:, 1:2]
            z = vn[:, 2:3]
            outs: List[torch.Tensor] = []
            for l in range(self.lmax + 1):
                monos: List[torch.Tensor] = []
                for a in range(l + 1):
                    for b in range(l - a + 1):
                        c = l - a - b
                        monos.append((x ** a) * (y ** b) * (z ** c))
                M = torch.cat(monos, dim=1)
                if l == 0:
                    outs.append(M @ self.sh_t0)
                elif l == 1:
                    outs.append(M @ self.sh_t1)
                elif l == 2:
                    outs.append(M @ self.sh_t2)
                else:
                    outs.append(M @ self.sh_t3)
            return torch.cat(outs, dim=1)

        def forward(self, data: Dict[str, torch.Tensor]
                    ) -> Dict[str, torch.Tensor]:
            pos = data['pos']
            cell = data['cell_lattice_vectors'].view(3, 3)
            cell_shift = data['pbc_shift']
            edge_index = data['edge_index']
            types = data['x']
            volume = data['cell_volume']

            # strain injection (reference:
            # sevenn/nn/edge_embedding.py:49-59, non-batch path)
            strain = torch.zeros(
                (3, 3), dtype=pos.dtype, device=pos.device)
            strain.requires_grad_(True)
            sym = 0.5 * (strain + strain.transpose(0, 1))
            posx = pos + torch.mm(pos, sym)
            cellx = cell + torch.mm(cell, sym)

            idx0 = edge_index[0]
            idx1 = edge_index[1]
            edge_vec = posx[idx1] - posx[idx0] \
                + torch.mm(cell_shift, cellx)
            r = torch.linalg.norm(edge_vec, dim=-1)

            # bessel x cutoff radial embedding (ops/radial.py semantics:
            # prefactor 2/r_c, trainable frequencies multiply r directly)
            rr = torch.clamp(r, min=1e-6).unsqueeze(-1)
            basis = (2.0 / self.cutoff) \
                * torch.sin(self.bessel_coeffs * rr) / rr
            if self.use_xplor:
                r_on = self.cutoff_on
                r_off = self.cutoff
                num = (r_off * r_off - r * r)
                env = (num * num
                       * (r_off * r_off + 2.0 * r * r
                          - 3.0 * r_on * r_on)
                       / (r_off * r_off - r_on * r_on) ** 3)
                env = torch.where(r < r_on, torch.ones_like(env), env)
                env = torch.where(r > r_off, torch.zeros_like(env), env)
            else:
                p = self.poly_p
                u = r / self.cutoff
                env = (1.0
                       - (p + 1.0) * (p + 2.0) / 2.0 * u ** p
                       + p * (p + 2.0) * u ** (p + 1.0)
                       - p * (p + 1.0) / 2.0 * u ** (p + 2.0))
                env = torch.where(
                    u < 1.0, env, torch.zeros_like(env))
            emb = basis * env.unsqueeze(-1)
            emb = (emb - self.w_shift) * self.w_scale
            sh = self._spherical(edge_vec)

            onehot = torch.nn.functional.one_hot(
                types, self.num_species).to(pos.dtype)
            x = self.embed(onehot)
            # messages flow edge_index[1] -> edge_index[0]
            # (reference: sevenn/nn/convolution.py:112-117)
            for blk in self.blocks:
                x = blk(x, types, emb, sh, idx1, idx0)

            if self.as_fcn:
                atomic_e = self.fcn(x)
            else:
                atomic_e = self.ro2(self.ro1(x))
            if self.scale.numel() > 1:
                atomic_e = atomic_e * self.scale[types].unsqueeze(-1) \
                    + self.shift[types].unsqueeze(-1)
            else:
                atomic_e = atomic_e * self.scale[0] + self.shift[0]

            energy = atomic_e.sum()
            grads = torch.autograd.grad(
                [energy], [pos, strain],
                create_graph=self.training, allow_unused=True,
            )
            g0 = grads[0]
            force = -g0 if g0 is not None else torch.zeros_like(pos)
            g1 = grads[1]
            vol = torch.clamp(volume, min=1e-3)
            if g1 is not None:
                st = -g1 / vol
            else:
                st = torch.zeros(3, 3, dtype=pos.dtype, device=pos.device)
            voigt = torch.stack([
                st[0, 0], st[1, 1], st[2, 2],
                st[0, 1], st[1, 2], st[0, 2],
            ])
            out: Dict[str, torch.Tensor] = {
                'inferred_total_energy': energy,
                'inferred_force': force,
                'inferred_stress': voigt,
                'atomic_energy': atomic_e,
            }
            return out

    return Exported()


def export_serial(spec: ModelSpec, params, out_path: str,
                  version: str = 'sevennet_finetuning_tpu_torch-0.1.0'):
    """Build, script, freeze and save the deploy artifact + metadata."""
    model = build_torch_model(spec, params)
    model.eval()
    scripted = torch.jit.script(model)
    scripted = torch.jit.freeze(
        scripted, preserved_attrs=[])

    chem = ' '.join(
        z_to_symbol(z) for z, _ in sorted(spec.type_map,
                                          key=lambda kv: kv[1]))
    meta = {
        'chemical_symbols_to_index': chem,
        'cutoff': str(spec.cutoff),
        'num_species': str(spec.num_species),
        'model_type': 'E3_equivariant_model',
        'version': version,
        'dtype': 'single',
        'time': datetime.now().strftime('%Y-%m-%d'),
    }
    if not out_path.endswith('.pt'):
        out_path += '.pt'
    torch.jit.save(scripted, out_path, _extra_files=meta)
    return out_path
