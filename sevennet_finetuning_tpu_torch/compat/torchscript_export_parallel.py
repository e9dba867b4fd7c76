"""Export a trained model as the reference's PARALLEL TorchScript
segment chain.

The reference's multi-GPU LAMMPS consumes L segment files
``deployed_parallel_{i}.pt`` produced by sevenn/scripts/deploy.py:55-117
from a model sliced at every ``{i}_self_interaction_1``
(sevenn/model_build.py:103-182), with ghost one-hot/embedding twin
layers weight-tied to the local ones, and runs them with a halo exchange
between segments (pair_e3gnn_parallel.cpp:207-541):

  seg 0:   edge-embed, local+GHOST species embedding (twins: ghost
           features at layer 0 are species embeddings, computable
           locally -- no comm needed), 0_sc_intro, 0_si1 (+ghost twin),
           0_conv, 0_si2, 0_sc_outro, 0_gate, 1_sc_intro, 1_si1
  seg i:   (ghost features arrive via forward_comm into 'x_ghost')
           edge-embed, i_conv over cat(x, x_ghost), i_si2, i_sc_outro,
           i_gate, (i+1)_sc_intro, (i+1)_si1
  seg L-1: last conv + readout + rescale + atom-reduce
           -> 'inferred_total_energy' (forces are computed by the C++
           from accumulated dE/d(edge_vec) per segment; no stress)

Dict contract per segment (keys read by the C++):
  in:  x [nl] / [nl, d], x_ghost, edge_index [2, E] (row 1 = src,
       possibly ghost; row 0 = dst, local -- convolution.py:110-117),
       edge_vec [E, 3] (requires_grad set by caller), nlocal
  out: x (post-si1 local features -- the comm payload of the NEXT
       segment), self_cont_tmp (chained for the manual backward,
       pair_e3gnn_parallel.cpp:404-454), passthrough of the rest

Each segment recomputes emb/SH from its own (cloned-by-the-C++)
edge_vec so per-segment autograd.grad w.r.t. edge_vec accumulates the
full dE/dr (mirrors the re-inserted edge_embedding,
model_build.py:178-180).  comm_size metadata = max conv input dim
(deploy.py:94-97).

Math blocks are shared with the serial exporter (compat/
torchscript_export._tmods); weights are extracted from the params the
same way, so a chain run of the segments must match the model's
energy_network closely.

Port of ``sevennet_finetuning_tpu/compat/torchscript_export_parallel.py``
(tests/test_torch_compat.py holds the chain against the JAX package's
export and its ``apply_model``).
"""

from datetime import datetime
import os
from typing import Dict, List

import numpy as np
import torch

from ..data.elements import z_to_symbol
from ..irreps import Irreps
from ..model.nequip import ModelSpec, _linear_w, require_model_spec
from ..ops.fused_conv import layout_from_spec
from .torchscript_export import (
    _dense_fctp_species,
    _dense_linear,
    _sh_monomial_table,
    _tmods,
)


def build_torch_segments(spec: ModelSpec, params):
    """L plain-torch segment modules (host-side, CPU)."""
    import torch.nn as nn

    for blk in spec.blocks:
        if blk.block_type != 'nequip' or blk.conv_kind != 'cg':
            raise NotImplementedError(
                'parallel TorchScript export covers the NequIP/'
                f'SevenNet-0 block family; got {blk.block_type!r} '
                f'(conv {blk.conv_kind!r})'
            )
        if blk.self_connection == 'none':
            raise NotImplementedError(
                "parallel export requires a self connection: the C++ "
                "backward chains grad through 'self_cont_tmp' "
                '(pair_e3gnn_parallel.cpp:424-447)'
            )

    T = _tmods()
    es = spec.edge
    lmax = es.lmax_edge
    sh_tables = _sh_monomial_table(lmax)

    from ..ops.linear import linear_spec

    one_hot_irreps = Irreps(f'{spec.num_species}x0e')
    embed_ls = linear_spec(one_hot_irreps, spec.blocks[0].irreps_x,
                           biases=spec.use_bias_in_linear)

    def P(name):
        return {k: np.asarray(v) for k, v in params[name].items()}

    class EdgeFeat(nn.Module):
        """emb (radial x cutoff, standardized) + SH from edge_vec;
        recomputed per segment (see module docstring)."""

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
            assert lmax <= 3, 'SH monomial table covers lmax<=3'
            for l in range(4):
                Tt = sh_tables[l] if l <= lmax else np.zeros(
                    (1, 1), np.float32)
                self.register_buffer(f'sh_t{l}', torch.from_numpy(Tt))

        def forward(self, edge_vec):
            r = torch.linalg.norm(edge_vec, dim=-1)
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
                env = torch.where(u < 1.0, env, torch.zeros_like(env))
            emb = basis * env.unsqueeze(-1)
            emb = (emb - self.w_shift) * self.w_scale

            vn = edge_vec / torch.clamp(
                torch.linalg.norm(edge_vec, dim=-1, keepdim=True),
                min=1e-12)
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
            sh = torch.cat(outs, dim=1)
            return emb, sh

    class BlockHead(nn.Module):
        """{t}_self_connection_intro (-> tmp) + {t}_self_interaction_1."""

        def __init__(self, blk):
            super().__init__()
            t = blk.t
            self.sc_kind = {'nequip': 0, 'linear': 1}[blk.self_connection]
            if self.sc_kind == 0:
                mats = _dense_fctp_species(
                    blk.sc_spec,
                    _linear_w(params[f'{t}_self_connection_intro']),
                    spec.num_species)
                self.register_buffer('sc_mats', torch.from_numpy(mats))
            else:
                M, _b = _dense_linear(
                    blk.sc_spec,
                    _linear_w(params[f'{t}_self_connection_intro']))
                self.register_buffer('sc_mats',
                                     torch.from_numpy(M[None]))
            self.si1 = T.DenseLinear(
                blk.si1, _linear_w(params[f'{t}_self_interaction_1']))

        def forward(self, x, types):
            if self.sc_kind == 0:
                tmp = torch.bmm(
                    x.unsqueeze(1), self.sc_mats[types]).squeeze(1)
            else:
                tmp = x @ self.sc_mats[0]
            return self.si1(x), tmp

    class BlockTail(nn.Module):
        """{t}_convolution (parallel: cat local+ghost sources) +
        {t}_self_interaction_2 + sc_outro + {t}_equivariant_gate."""

        def __init__(self, blk):
            super().__init__()
            t = blk.t
            conv_p = params[f'{t}_convolution']
            n_w = len(blk.radial_hs) - 1
            self.radial = T.RadialMLP(
                blk.radial_hs,
                [np.asarray(conv_p[f'weight_nn_w{i}'])
                 for i in range(n_w)],
                blk.act_radial)
            layout = layout_from_spec(blk.conv_tp)
            self.groups = nn.ModuleList(
                [T.ConvGroup(g) for g in layout.groups])
            self.dim_msg = int(layout.dim_msg)
            self.denominator = float(
                np.asarray(conv_p['denominator'])[0])
            self.si2 = T.DenseLinear(
                blk.si2, _linear_w(params[f'{t}_self_interaction_2']))
            self.gate = T.Gate(blk.gate)

        def forward(self, x, x_ghost, tmp, emb, sh, edge_src, edge_dst):
            nlocal = x.shape[0]
            x_cat = torch.cat([x, x_ghost], dim=0)
            w = self.radial(emb)
            x_src = x_cat[edge_src]
            msg = torch.zeros((x_src.shape[0], self.dim_msg),
                              dtype=x.dtype, device=x.device)
            for grp in self.groups:
                msg = grp(x_src, sh, w, msg)
            agg = torch.zeros((nlocal, self.dim_msg), dtype=x.dtype,
                              device=x.device)
            idx = edge_dst.unsqueeze(-1).expand(-1, self.dim_msg)
            agg.scatter_reduce_(0, idx, msg, reduce='sum')
            x = agg / self.denominator
            x = self.si2(x)
            x = x + tmp
            return self.gate(x)

    class Seg0(nn.Module):
        def __init__(self):
            super().__init__()
            self.edge_feat = EdgeFeat()
            self.num_species = int(spec.num_species)
            # ghost embedding/si1 twins are weight-TIED to the local
            # layers (reference deploy.py:57-75 copies the state dict)
            self.embed = T.DenseLinear(
                embed_ls, _linear_w(params['onehot_to_feature_x']))
            self.head0 = BlockHead(spec.blocks[0])
            self.ghost_si1 = T.DenseLinear(
                spec.blocks[0].si1,
                _linear_w(params['0_self_interaction_1']))
            self.tail0 = BlockTail(spec.blocks[0])
            self.head1 = BlockHead(spec.blocks[1])

        def forward(self, data: Dict[str, torch.Tensor]
                    ) -> Dict[str, torch.Tensor]:
            types = data['x'].to(torch.long)
            types_ghost = data['x_ghost'].to(torch.long)
            edge_vec = data['edge_vec']
            edge_src = data['edge_index'][1]
            edge_dst = data['edge_index'][0]
            emb, sh = self.edge_feat(edge_vec)

            onehot = torch.nn.functional.one_hot(
                types, self.num_species).to(edge_vec.dtype)
            x = self.embed(onehot)
            oh_g = torch.nn.functional.one_hot(
                types_ghost, self.num_species).to(edge_vec.dtype)
            xg = self.embed(oh_g)

            x, tmp0 = self.head0(x, types)
            xg = self.ghost_si1(xg)
            x = self.tail0(x, xg, tmp0, emb, sh, edge_src, edge_dst)
            x, tmp1 = self.head1(x, types)

            out: Dict[str, torch.Tensor] = {
                'x': x,
                'x_ghost': xg,
                'self_cont_tmp': tmp1,
                'edge_vec': edge_vec,
                'edge_index': data['edge_index'],
                'nlocal': data['nlocal'],
                'node_types': types,
            }
            if 'num_atoms' in data:
                out['num_atoms'] = data['num_atoms']
            return out

    class SegMid(nn.Module):
        def __init__(self, t):
            super().__init__()
            self.edge_feat = EdgeFeat()
            self.tail = BlockTail(spec.blocks[t])
            self.head = BlockHead(spec.blocks[t + 1])

        def forward(self, data: Dict[str, torch.Tensor]
                    ) -> Dict[str, torch.Tensor]:
            edge_vec = data['edge_vec']
            edge_src = data['edge_index'][1]
            edge_dst = data['edge_index'][0]
            emb, sh = self.edge_feat(edge_vec)
            types = data['node_types'].to(torch.long)
            x = self.tail(data['x'], data['x_ghost'],
                          data['self_cont_tmp'], emb, sh,
                          edge_src, edge_dst)
            x, tmp = self.head(x, types)
            out: Dict[str, torch.Tensor] = {
                'x': x,
                'x_ghost': data['x_ghost'],
                'self_cont_tmp': tmp,
                'edge_vec': edge_vec,
                'edge_index': data['edge_index'],
                'nlocal': data['nlocal'],
                'node_types': data['node_types'],
            }
            if 'num_atoms' in data:
                out['num_atoms'] = data['num_atoms']
            return out

    class SegLast(nn.Module):
        def __init__(self):
            super().__init__()
            self.edge_feat = EdgeFeat()
            self.tail = BlockTail(spec.blocks[-1])
            self.as_fcn = bool(spec.readout.as_fcn)
            if self.as_fcn:
                ro = params['readout_FCN']
                n_w = len(spec.readout.fcn_hs) - 1
                self.fcn = T.RadialMLP(
                    spec.readout.fcn_hs,
                    [np.asarray(ro[f'w{i}']) for i in range(n_w)],
                    spec.readout.fcn_act)
                self.ro1 = nn.Identity()
                self.ro2 = nn.Identity()
            else:
                self.fcn = nn.Identity()
                self.ro1 = T.DenseLinear(
                    spec.readout.lin1,
                    _linear_w(params['reduce_input_to_hidden']))
                self.ro2 = T.DenseLinear(
                    spec.readout.lin2,
                    _linear_w(params['reduce_hidden_to_energy']))
            rp = P('rescale_atomic_energy')
            self.register_buffer(
                'shift',
                torch.from_numpy(rp['shift'].astype(np.float32)))
            self.register_buffer(
                'scale',
                torch.from_numpy(rp['scale'].astype(np.float32)))

        def forward(self, data: Dict[str, torch.Tensor]
                    ) -> Dict[str, torch.Tensor]:
            edge_vec = data['edge_vec']
            edge_src = data['edge_index'][1]
            edge_dst = data['edge_index'][0]
            emb, sh = self.edge_feat(edge_vec)
            types = data['node_types'].to(torch.long)
            x = self.tail(data['x'], data['x_ghost'],
                          data['self_cont_tmp'], emb, sh,
                          edge_src, edge_dst)
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
            out: Dict[str, torch.Tensor] = {
                'inferred_total_energy': energy.reshape(1),
                'atomic_energy': atomic_e,
                'edge_vec': edge_vec,
            }
            return out

    L = len(spec.blocks)
    segs: List[nn.Module] = [Seg0()]
    for t in range(1, L - 1):
        segs.append(SegMid(t))
    segs.append(SegLast())
    return segs


def comm_size_of(spec: ModelSpec) -> int:
    """Halo payload floats/atom = max conv input dim (deploy.py:94-97)."""
    return max(blk.conv_tp.irreps_in1.dim for blk in spec.blocks)


def export_parallel(spec: ModelSpec, params, out_dir: str,
                    version: str = 'sevennet_finetuning_tpu_torch-0.1.0'):
    """Script, freeze and save deployed_parallel_{i}.pt + metadata."""
    require_model_spec(spec, 'TorchScript export')
    segs = build_torch_segments(spec, params)
    chem = ' '.join(
        z_to_symbol(z) for z, _ in sorted(spec.type_map,
                                          key=lambda kv: kv[1]))
    meta = {
        'chemical_symbols_to_index': chem,
        'cutoff': str(spec.cutoff),
        'num_species': str(spec.num_species),
        'comm_size': str(comm_size_of(spec)),
        'model_type': 'E3_equivariant_model',
        'version': version,
        'dtype': 'single',
        'time': datetime.now().strftime('%Y-%m-%d'),
    }
    os.makedirs(out_dir, exist_ok=True)
    paths = []
    for i, seg in enumerate(segs):
        seg.eval()
        scripted = torch.jit.freeze(torch.jit.script(seg))
        path = os.path.join(out_dir, f'deployed_parallel_{i}.pt')
        torch.jit.save(scripted, path, _extra_files=dict(meta))
        paths.append(path)
    return paths
