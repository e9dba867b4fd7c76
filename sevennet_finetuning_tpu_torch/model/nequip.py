"""The NequIP-style equivariant GNN potential: spec, module, apply.

Port of ``sevennet_finetuning_tpu/model/nequip.py`` for the serving path:

- a frozen ``ModelSpec`` carries every static decision (irreps per
  layer, TP instructions, activation names, cutoff function...);
- ``NequIP`` is an ``nn.Module`` holding the parameters under the JAX
  package's names (``model.params['0_convolution']['weight_nn_w0']``),
  so ``load_jax_params`` copies a JAX parameter dict across one to one;
- ``energy_network`` computes atomic/total energies from edge vectors;
  ``apply_model`` adds forces and the per-graph virial/stress through one
  ``torch.autograd.grad`` of the total energy over the edge vectors, and
  returns detached results (serving); ``apply_model_train`` keeps the
  graph (``create_graph=True``), so a loss on the forces can be
  differentiated once more for the parameter gradient (training).

``run_blocks`` runs the interaction blocks with the JAX package's
signature.  With ``edges_sorted=True`` (``energy_network``; collate
batches are dst-sorted) each convolution is the scatter-fused branch:
gather by source, then ``conv_aggregate``.  With ``edges_sorted=False``
(a caller whose graph is not dst-sorted) it is the per-edge branch:
gather by source, per-edge messages (the ``cg_quad`` kernel), then
``aggregate_messages`` over a stable device sort of dst.  The
self-connection is a linear map of x ('linear') or the fully connected
TP of x with the one-hot species embedding ('nequip', plain PyTorch as
in the JAX package).  Other interaction types, halo exchange and remat
wait for later slices and raise ``NotImplementedError``.
Batches are the padded dicts of ``model.graph`` as tensors
(``batch_to_torch``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .. import keys as K
from ..irreps import Irreps
from ..ops.fused_conv import conv_messages, layout_from_spec, stride_to_e3nn
from ..ops.fused_conv_agg import conv_aggregate
from ..ops.gate import GateSpec, apply_gate, gate_spec
from ..ops.linear import (LinearSpec, apply_linear, init_linear_weights,
                          linear_spec)
from ..ops.mlp import mlp_apply, mlp_init
from ..ops.radial import bessel_basis, bessel_init, poly_cutoff, xplor_cutoff
from ..ops.scatter import (aggregate_messages, gather_rows, inverse_perm,
                           scatter_rows, segment_sum_sorted, sort_perm)
from ..ops.spherical import spherical_harmonics
from ..ops.tensor_product import (TensorProductSpec, apply_tp, fctp_spec,
                                  init_tp_weights, uvu_tp_spec)
from ..ops.util import safe_norm


@dataclass(frozen=True)
class EdgeEmbedSpec:
    cutoff: float
    bessel_num: int = 8
    bessel_trainable: bool = True
    cutoff_function: str = 'poly_cut'      # 'poly_cut' | 'XPLOR'
    poly_cut_p: int = 6
    cutoff_on: Optional[float] = None      # for XPLOR
    lmax_edge: int = 1
    parity: int = -1                       # -1: E(3) (odd SH), +1: SE(3)
    normalize_sph: bool = True
    # radial-embedding standardization: emb -> (emb - shift) * scale,
    # applied inside the edge mask
    weight_shift: float = 0.0
    weight_scale: float = 1.0


@dataclass(frozen=True)
class BlockSpec:
    t: int
    irreps_x: Irreps
    irreps_out: Irreps
    self_connection: str                   # 'nequip' | 'linear' | 'none'
    sc_spec: object                        # TensorProductSpec | LinearSpec
    si1: LinearSpec
    conv_tp: TensorProductSpec
    radial_hs: Tuple[int, ...]
    act_radial: str
    si2: LinearSpec
    gate: GateSpec
    train_denominator: bool = False
    # the convolution denominator a fresh model starts from (init_params)
    denominator: float = 1.0
    # the JAX BlockSpec's kind fields: only nequip blocks with the CG
    # convolution are ported ('mace', 'gaunt' and 'custom' blocks and the
    # gaunt convolution are ROADMAP A.9)
    block_type: str = 'nequip'
    conv_kind: str = 'cg'


@dataclass(frozen=True)
class ReadoutSpec:
    as_fcn: bool
    lin1: Optional[LinearSpec] = None
    lin2: Optional[LinearSpec] = None
    fcn_hs: Tuple[int, ...] = ()
    fcn_act: str = 'relu'


@dataclass(frozen=True)
class ModelSpec:
    num_species: int
    type_map: Tuple[Tuple[int, int], ...]  # (Z, onehot idx) pairs
    edge: EdgeEmbedSpec
    blocks: Tuple[BlockSpec, ...]
    readout: ReadoutSpec
    shift: Tuple[float, ...]               # len 1 or num_species
    scale: Tuple[float, ...]
    train_shift_scale: bool = False
    use_bias_in_linear: bool = False

    @property
    def cutoff(self) -> float:
        return self.edge.cutoff


def build_nequip_block(
    t: int,
    irreps_x: Irreps,
    irreps_filter: Irreps,
    irreps_out_tp: Irreps,
    irreps_out: Irreps,
    num_species: int,
    radial_hidden: Tuple[int, ...],
    bessel_num: int,
    act_radial: str,
    act_scalar: Dict[str, str],
    act_gate: Dict[str, str],
    self_connection: str,
    biases: bool,
    train_denominator: bool = False,
    denominator: float = 1.0,
) -> BlockSpec:
    """Assemble one interaction block (reference:
    sevenn/nn/interaction_blocks.py:22-86)."""
    gate = gate_spec(irreps_out, act_scalar, act_gate)
    irreps_gate_in = gate.irreps_in
    node_attr_irreps = Irreps(f'{num_species}x0e')
    if self_connection == 'nequip':
        sc = fctp_spec(irreps_x, node_attr_irreps, irreps_gate_in)
    elif self_connection == 'linear':
        sc = linear_spec(irreps_x, irreps_gate_in, biases=False)
    elif self_connection == 'none':
        sc = None
    else:
        raise ValueError(self_connection)

    si1 = linear_spec(irreps_x, irreps_x, biases=biases)
    conv_tp = uvu_tp_spec(irreps_x, irreps_filter, irreps_out_tp)
    si2 = linear_spec(conv_tp.irreps_out.simplify(), irreps_gate_in,
                      biases=biases)
    return BlockSpec(
        t=t,
        irreps_x=irreps_x,
        irreps_out=gate.irreps_out,
        self_connection=self_connection,
        sc_spec=sc,
        si1=si1,
        conv_tp=conv_tp,
        radial_hs=(bessel_num,) + tuple(radial_hidden)
        + (conv_tp.weight_numel,),
        act_radial=act_radial,
        si2=si2,
        gate=gate,
        train_denominator=train_denominator,
        denominator=denominator,
    )


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------

def _linear_shapes(s) -> Dict[str, Tuple[int, ...]]:
    """Weight shapes of a LinearSpec or of a TensorProductSpec."""
    return {f'w{i}': tuple(ins.weight_shape)
            for i, ins in enumerate(s.instructions)}


def _embed_spec(spec: ModelSpec) -> LinearSpec:
    return linear_spec(Irreps(f'{spec.num_species}x0e'),
                       spec.blocks[0].irreps_x,
                       biases=spec.use_bias_in_linear)


def param_shapes(spec: ModelSpec) -> Dict[str, Dict[str, Tuple[int, ...]]]:
    """Group -> name -> shape, with the JAX package's names."""
    p = {'edge_embedding': {'bessel_coeffs': (spec.edge.bessel_num,)},
         'onehot_to_feature_x': _linear_shapes(_embed_spec(spec))}
    for blk in spec.blocks:
        t = blk.t
        if blk.self_connection in ('nequip', 'linear'):
            p[f'{t}_self_connection_intro'] = _linear_shapes(blk.sc_spec)
        p[f'{t}_self_interaction_1'] = _linear_shapes(blk.si1)
        conv = {f'weight_nn_w{i}': (h_in, h_out) for i, (h_in, h_out)
                in enumerate(zip(blk.radial_hs[:-1], blk.radial_hs[1:]))}
        conv['denominator'] = (1,)
        p[f'{t}_convolution'] = conv
        p[f'{t}_self_interaction_2'] = _linear_shapes(blk.si2)
    if spec.readout.as_fcn:
        hs = spec.readout.fcn_hs
        p['readout_FCN'] = {f'w{i}': (a, b)
                            for i, (a, b) in enumerate(zip(hs[:-1], hs[1:]))}
    else:
        p['reduce_input_to_hidden'] = _linear_shapes(spec.readout.lin1)
        p['reduce_hidden_to_energy'] = _linear_shapes(spec.readout.lin2)
    p['rescale_atomic_energy'] = {'shift': (len(spec.shift),),
                                  'scale': (len(spec.scale),)}
    return p


def init_params(spec: ModelSpec, seed: int = 0
                ) -> Dict[str, Dict[str, np.ndarray]]:
    """Fresh parameters for a from-scratch run: the JAX package's
    ``init_params``, numpy draws from ``np.random.default_rng(seed)`` in
    its order, so the same spec and seed give the same arrays bit for
    bit.  Load them with ``load_jax_params``."""
    rng = np.random.default_rng(seed)
    p: Dict[str, Dict[str, np.ndarray]] = {
        'edge_embedding': {'bessel_coeffs': bessel_init(
            spec.edge.cutoff, spec.edge.bessel_num).astype(np.float32)},
        'onehot_to_feature_x': _linear_params(_embed_spec(spec), rng),
    }
    for blk in spec.blocks:
        t = blk.t
        if blk.self_connection == 'nequip':
            p[f'{t}_self_connection_intro'] = {
                f'w{i}': w
                for i, w in enumerate(init_tp_weights(blk.sc_spec, rng))}
        elif blk.self_connection == 'linear':
            p[f'{t}_self_connection_intro'] = _linear_params(blk.sc_spec, rng)
        p[f'{t}_self_interaction_1'] = _linear_params(blk.si1, rng)
        conv = {f'weight_nn_w{i}': w
                for i, w in enumerate(mlp_init(blk.radial_hs, rng))}
        conv['denominator'] = np.array([blk.denominator], np.float32)
        p[f'{t}_convolution'] = conv
        p[f'{t}_self_interaction_2'] = _linear_params(blk.si2, rng)
    if spec.readout.as_fcn:
        p['readout_FCN'] = {f'w{i}': w for i, w in
                            enumerate(mlp_init(spec.readout.fcn_hs, rng))}
    else:
        p['reduce_input_to_hidden'] = _linear_params(spec.readout.lin1, rng)
        p['reduce_hidden_to_energy'] = _linear_params(spec.readout.lin2, rng)
    p['rescale_atomic_energy'] = {
        'shift': np.asarray(spec.shift, np.float32),
        'scale': np.asarray(spec.scale, np.float32),
    }
    return p


def _linear_params(s: LinearSpec, rng) -> Dict[str, np.ndarray]:
    return {f'w{i}': w for i, w in enumerate(init_linear_weights(s, rng))}


class NequIP(nn.Module):
    """Parameters of one ModelSpec; ``forward`` is ``apply_model``."""

    def __init__(self, spec: ModelSpec):
        super().__init__()
        self.spec = spec
        self.params = nn.ModuleDict({
            group: nn.ParameterDict({
                name: nn.Parameter(torch.zeros(shape))
                for name, shape in names.items()})
            for group, names in param_shapes(spec).items()})

    def forward(self, data: Dict[str, torch.Tensor]):
        return apply_model(self, data)


def load_jax_params(model: NequIP, params_np) -> NequIP:
    """Copy a JAX parameter dict ({'0_convolution': {'weight_nn_w0': ...},
    ...}, numpy arrays) onto the model; every group, name and shape must
    match exactly."""
    want = param_shapes(model.spec)
    if set(params_np) != set(want):
        raise KeyError(f'parameter groups differ: missing '
                       f'{sorted(set(want) - set(params_np))}, extra '
                       f'{sorted(set(params_np) - set(want))}')
    with torch.no_grad():
        for group, names in want.items():
            if set(params_np[group]) != set(names):
                raise KeyError(f'{group}: parameters {sorted(names)} '
                               f'expected, got {sorted(params_np[group])}')
            for name, shape in names.items():
                arr = np.asarray(params_np[group][name], np.float32)
                if arr.shape != shape:
                    raise ValueError(f'{group}/{name}: shape {arr.shape},'
                                     f' expected {shape}')
                model.params[group][name].copy_(torch.tensor(arr))
    return model


def trainable_mask(spec: ModelSpec) -> Dict[str, Dict[str, bool]]:
    """Group -> name -> whether the leaf receives optimizer updates (JAX
    ``trainable_mask``): the Bessel coefficients, the convolution
    denominators and the atomic-energy shift/scale follow the spec's
    flags; every other leaf trains."""
    mask = {group: dict.fromkeys(names, True)
            for group, names in param_shapes(spec).items()}
    mask['edge_embedding']['bessel_coeffs'] = spec.edge.bessel_trainable
    for blk in spec.blocks:
        mask[f'{blk.t}_convolution']['denominator'] = blk.train_denominator
    mask['rescale_atomic_energy']['shift'] = spec.train_shift_scale
    mask['rescale_atomic_energy']['scale'] = spec.train_shift_scale
    return mask


def _linear_w(p) -> list:
    return [p[f'w{i}'] for i in range(len(p))]


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------

# the inverse of EDGE_SRC_PERM, built once per batch by batch_to_torch
EDGE_SRC_INV_PERM = '_edge_src_inv_perm'


def batch_to_torch(batch: Dict[str, np.ndarray],
                   device) -> Dict[str, torch.Tensor]:
    """A collate batch as tensors on ``device`` (host-only keys dropped),
    with the inverse of the src-sort permutation added; per-graph data
    weights (``K.DATA_WEIGHT``) stay a dict of tensors."""
    out = {k: torch.as_tensor(v, device=device) for k, v in batch.items()
           if k not in (K.INFO, K.USER_LABEL, K.DATA_WEIGHT)}
    if K.DATA_WEIGHT in batch:
        out[K.DATA_WEIGHT] = {k: torch.as_tensor(v, device=device)
                              for k, v in batch[K.DATA_WEIGHT].items()}
    perm = np.asarray(batch[K.EDGE_SRC_PERM])
    out[EDGE_SRC_INV_PERM] = torch.as_tensor(
        np.argsort(perm, kind='stable').astype(perm.dtype), device=device)
    return out


def _clamp(idx: torch.Tensor, n: int) -> torch.Tensor:
    # a JAX gather clamps out-of-range indices; torch indexing raises
    return idx.clamp(max=n - 1).long()


def compute_edge_vec(data: Dict[str, torch.Tensor]) -> torch.Tensor:
    """edge_vec = pos[j] - pos[i] + shift . cell (batched PBC)."""
    idx = data[K.EDGE_IDX]
    pos = data[K.POS]
    n = pos.shape[0]
    i, j = _clamp(idx[0], n), _clamp(idx[1], n)
    cell_of_edge = data[K.CELL][data[K.BATCH][i].long()]
    return (pos[j] - pos[i]
            + torch.einsum('ei,eij->ej', data[K.CELL_SHIFT], cell_of_edge))


def run_blocks(spec: ModelSpec, params, x: torch.Tensor,
               onehot: torch.Tensor, emb: torch.Tensor,
               edge_attr: torch.Tensor, edge_src: torch.Tensor,
               edge_dst: torch.Tensor, n_node: int, cap=None,
               exchange_fn=None, remat=False, edges_sorted: bool = False,
               src_perm=None, halo_split=None, src_inv=None) -> torch.Tensor:
    """All interaction blocks (JAX ``run_blocks``): node features ``x``
    [N, dim] -> [N, dim_out].

    ``edges_sorted`` asserts that ``edge_dst`` is ascending (the collate
    contract) and selects the scatter-fused convolution; otherwise the
    per-edge branch aggregates over a stable sort of ``edge_dst``, taken
    once per call on the device.  ``src_perm`` (collate's
    EDGE_SRC_PERM) sorts ``edge_src`` for the source gather's backward;
    without it the stable sort is taken here, once per call.  ``src_inv``
    (a port-only argument) is its inverse when the caller has it.
    ``cap(name, value)`` receives the per-stage node features.

    The halo-parallel path (``exchange_fn``, ``halo_split``) and
    per-block rematerialization (``remat``) are not ported."""
    if exchange_fn is not None or halo_split is not None:
        raise NotImplementedError('the halo-parallel path (exchange_fn, '
                                  'halo_split) is not ported: ROADMAP A.8')
    if remat:
        raise NotImplementedError('per-block rematerialization is not '
                                  'ported: ROADMAP A.3')
    for blk in spec.blocks:
        if blk.block_type != 'nequip' or blk.conv_kind != 'cg':
            raise NotImplementedError(
                f'{blk.block_type} blocks with the {blk.conv_kind} '
                'convolution are not ported: ROADMAP A.9')
    if cap is None:
        def cap(name, val):
            return None
    if src_perm is None:
        src_perm, src_inv = sort_perm(edge_src)
    elif src_inv is None:
        src_inv = inverse_perm(src_perm)
    dst_sort = None if edges_sorted else sort_perm(edge_dst)
    for blk in spec.blocks:
        x = _run_one_block(blk, params, x, onehot, emb, edge_attr, edge_src,
                           edge_dst, n_node, cap, src_perm, src_inv,
                           dst_sort)
    return x


def _run_one_block(blk, p, x, onehot, emb, edge_attr, edge_src, edge_dst,
                   n_node, cap, src_perm, src_inv, dst_sort):
    t = blk.t
    if blk.self_connection == 'nequip':
        # FCTP of x with the one-hot species embedding: a small einsum,
        # outside any kernel in both packages
        sc = apply_tp(blk.sc_spec, x, onehot,
                      _linear_w(p[f'{t}_self_connection_intro']))
    elif blk.self_connection == 'linear':
        sc = apply_linear(blk.sc_spec,
                          _linear_w(p[f'{t}_self_connection_intro']), x)
    else:
        sc = None
    if sc is not None:
        cap(f'{t}_self_connection_intro', sc)

    x = apply_linear(blk.si1, _linear_w(p[f'{t}_self_interaction_1']), x,
                     out_stride=True)
    cap(f'{t}_self_interaction_1', lambda: stride_to_e3nn(blk.irreps_x, x))

    # gather_rows' backward drops padded-edge cotangents; exact because
    # EDGE_MASK zeroes the radial embedding, so padded messages and their
    # gradients are identically zero
    conv_p = p[f'{t}_convolution']
    n_w = len(blk.radial_hs) - 1
    layout = layout_from_spec(blk.conv_tp)
    w_edge = mlp_apply([conv_p[f'weight_nn_w{i}'] for i in range(n_w)],
                       emb, blk.act_radial)
    x_src = gather_rows(x, edge_src, src_perm, src_inv)
    if dst_sort is None:
        # scatter-fused convolution on dst-sorted edges: the [E, dim_msg]
        # message tensor never exists (ops/fused_conv_agg)
        x = conv_aggregate(layout, x_src, edge_attr, w_edge, edge_dst,
                           n_node)
    else:
        # unsorted dst: per-edge messages, edge-major (the JAX branch's
        # mlp_apply_T / conv_messages_T without its two transposes), then
        # the sorted segment sum over dst's stable sort
        msg = conv_messages(layout, x_src, edge_attr, w_edge)
        x = aggregate_messages(msg, edge_dst, n_node, False, *dst_sort)
    x = x / conv_p['denominator']
    # back to the e3nn flat layout at the node-sized boundary
    x = stride_to_e3nn(blk.conv_tp.irreps_out, x)
    cap(f'{t}_convolution', x)

    x = apply_linear(blk.si2, _linear_w(p[f'{t}_self_interaction_2']), x)
    cap(f'{t}_self_interaction_2', x)
    if sc is not None:
        x = x + sc
    x = apply_gate(blk.gate, x)
    cap(f'{t}_equivariant_gate', x)
    return x


def embed_edges(spec: ModelSpec, p, edge_vec: torch.Tensor,
                edge_mask: torch.Tensor):
    """Edge vectors -> (length r, radial embedding emb [E, bessel_num],
    spherical harmonics edge_attr [E, dim_sh]); emb is 0 on padded edges
    (``edge_mask`` 0)."""
    es = spec.edge
    r = safe_norm(edge_vec)
    basis = bessel_basis(r, p['edge_embedding']['bessel_coeffs'], es.cutoff)
    if es.cutoff_function == 'poly_cut':
        env = poly_cutoff(r, es.cutoff, es.poly_cut_p)
    elif es.cutoff_function == 'XPLOR':
        env = xplor_cutoff(r, es.cutoff, es.cutoff_on)
    else:
        raise ValueError(es.cutoff_function)
    # padded edges are killed here once; the radial MLP maps 0 -> 0
    # exactly (no biases), so their messages and gradients vanish
    emb = basis * env[..., None]
    if es.weight_shift != 0.0 or es.weight_scale != 1.0:
        emb = (emb - es.weight_shift) * es.weight_scale
    emb = emb * edge_mask[..., None]
    edge_attr = spherical_harmonics(es.lmax_edge,
                                    normalize=es.normalize_sph)(edge_vec)
    return r, emb, edge_attr


def embed_nodes(spec: ModelSpec, p, atom_type: torch.Tensor, dtype):
    """Atom types -> (one-hot [N, num_species], first node features)."""
    onehot = F.one_hot(atom_type.long(), spec.num_species).to(dtype)
    x = apply_linear(_embed_spec(spec), _linear_w(p['onehot_to_feature_x']),
                     onehot)
    return onehot, x


def readout_and_rescale(spec: ModelSpec, p, x: torch.Tensor,
                        atom_type: torch.Tensor):
    """Node features -> (scaled_atomic_energy, atomic_energy)."""
    if spec.readout.as_fcn:
        n_w = len(spec.readout.fcn_hs) - 1
        atomic_e = mlp_apply([p['readout_FCN'][f'w{i}'] for i in range(n_w)],
                             x, spec.readout.fcn_act)
    else:
        h = apply_linear(spec.readout.lin1,
                         _linear_w(p['reduce_input_to_hidden']), x)
        atomic_e = apply_linear(spec.readout.lin2,
                                _linear_w(p['reduce_hidden_to_energy']), h)
    atomic_e = atomic_e[..., 0]
    scaled = atomic_e
    rp = p['rescale_atomic_energy']
    if rp['scale'].shape[0] > 1:
        at = atom_type.long()
        atomic_e = atomic_e * rp['scale'][at] + rp['shift'][at]
    else:
        atomic_e = atomic_e * rp['scale'][0] + rp['shift'][0]
    return scaled, atomic_e


def energy_network(
    model: NequIP,
    data: Dict[str, torch.Tensor],
    edge_vec: torch.Tensor,
    intermediates: Optional[Dict[str, torch.Tensor]] = None,
) -> Dict[str, torch.Tensor]:
    """Edge vectors + graph -> atomic & total energies.

    Pass ``intermediates={}`` to capture per-stage node features (keys
    like '0_convolution', '1_equivariant_gate'...)."""
    spec, p = model.spec, model.params
    out = dict(data)

    def cap(name, val):
        if intermediates is not None:
            intermediates[name] = val() if callable(val) else val

    n_node = data[K.POS].shape[0]
    idx = data[K.EDGE_IDX]
    edge_src = idx[1]   # messages flow j -> i (reference convention)
    edge_dst = idx[0]

    r, emb, edge_attr = embed_edges(spec, p, edge_vec, data[K.EDGE_MASK])
    out[K.EDGE_LENGTH] = r
    out[K.EDGE_EMBEDDING] = emb
    out[K.EDGE_ATTR] = edge_attr

    onehot, x = embed_nodes(spec, p, data[K.ATOM_TYPE], edge_vec.dtype)
    out[K.NODE_ATTR] = onehot
    cap('onehot_to_feature_x', x)

    # --- interaction blocks (collate batches are dst-sorted) ---
    x = run_blocks(spec, p, x, onehot, emb, edge_attr, edge_src, edge_dst,
                   n_node, cap=cap, edges_sorted=True,
                   src_perm=data[K.EDGE_SRC_PERM],
                   src_inv=data[EDGE_SRC_INV_PERM])
    out[K.NODE_FEATURE] = x

    # --- readout + rescale + masked reduce ---
    (out[K.SCALED_ATOMIC_ENERGY], out[K.ATOMIC_ENERGY],
     out[K.PRED_TOTAL_ENERGY]) = graph_energy(spec, p, x, data)
    return out


def graph_energy(spec: ModelSpec, p, x: torch.Tensor,
                 data: Dict[str, torch.Tensor]):
    """Node features -> (scaled atomic energies, atomic energies masked
    to the real nodes, total energy per graph)."""
    n_graph = data[K.CELL].shape[0]
    scaled, atomic_e = readout_and_rescale(spec, p, x, data[K.ATOM_TYPE])
    atomic_e = atomic_e * data[K.NODE_MASK]
    # padded tail nodes carry batch id 0: remap them to the drop sentinel
    # (n_graph) to keep the ids ascending for the sorted segment sum
    batch = data[K.BATCH]
    batch_ids = torch.where(data[K.NODE_MASK] > 0, batch,
                            torch.full_like(batch, n_graph))
    total = segment_sum_sorted(atomic_e[:, None], batch_ids, n_graph)[:, 0]
    return scaled, atomic_e, total


def _forces_and_stress(out, data, edge_vec, fij):
    """Forces (sum of edge forces at both ends) and the per-graph virial
    stress from fij = dE/d(edge_vec)."""
    idx = data[K.EDGE_IDX]
    n_node = data[K.POS].shape[0]
    n_graph = data[K.CELL].shape[0]
    # idx[0] is ascending by the collate contract; the src-side scatter
    # rides the kernel via the precomputed src-sort permutation
    pf = segment_sum_sorted(fij, idx[0], n_node)
    nf = scatter_rows(fij, idx[1], n_node, data[K.EDGE_SRC_PERM],
                      data[EDGE_SRC_INV_PERM])
    out[K.PRED_FORCE] = pf - nf

    # per-edge virial, Voigt (xx, yy, zz, xy, yz, zx), summed per graph
    voigt = torch.cat([
        edge_vec * fij,
        (edge_vec[:, 0] * fij[:, 1])[:, None],
        (edge_vec[:, 1] * fij[:, 2])[:, None],
        (edge_vec[:, 2] * fij[:, 0])[:, None],
    ], dim=-1)
    # batch ids of dst-sorted edges are ascending; sentinel edges go to
    # the drop row n_graph (their voigt rows are exactly zero anyway)
    dst = idx[0]
    batch_of_edge = torch.where(
        dst < n_node, data[K.BATCH][_clamp(dst, n_node)],
        torch.full_like(dst, n_graph))
    virial = segment_sum_sorted(voigt, batch_of_edge, n_graph)
    out[K.PRED_STRESS] = -virial / data[K.CELL_VOLUME][:, None]
    return out


def apply_model(model: NequIP,
                data: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Full forward for serving: energies + forces + stress via one
    autograd.grad of the total energy over edge vectors (reference:
    sevenn/nn/force_output.py:158-215); results are detached."""
    edge_vec = compute_edge_vec(data).detach().requires_grad_(True)
    with torch.enable_grad():
        out = energy_network(model, data, edge_vec)
        fij, = torch.autograd.grad(out[K.PRED_TOTAL_ENERGY].sum(), edge_vec)
    out = _forces_and_stress(out, data, edge_vec, fij)
    return detach_outputs(out)


def detach_outputs(out: Dict) -> Dict:
    """Tensors detached; the data-weight dict passes through."""
    return {k: v.detach() if isinstance(v, torch.Tensor) else v
            for k, v in out.items()}


def apply_model_train(model: NequIP,
                      data: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Full forward for training: as ``apply_model``, but the force pass
    keeps its graph (``create_graph=True``) and nothing is detached, so
    a loss on energies, forces and stress backpropagates to the
    parameters through a double backward of the convolution (the JAX
    package's ``value_and_grad`` over ``apply_model``)."""
    edge_vec = compute_edge_vec(data).detach().requires_grad_(True)
    out = energy_network(model, data, edge_vec)
    fij, = torch.autograd.grad(out[K.PRED_TOTAL_ENERGY].sum(), edge_vec,
                               create_graph=True)
    return _forces_and_stress(out, data, edge_vec, fij)
