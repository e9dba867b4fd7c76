"""The NequIP-style equivariant GNN potential: spec, module, apply.

Port of ``sevennet_finetuning_tpu/model/nequip.py``:

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
signature.  Every block's convolution is one path
(``ops/fused_conv_agg.convolve``) over the coupling layout its family
gives (``BlockSpec.conv``: the CG tensor product's, or the Gaunt
product's): gather by source, then with ``edges_sorted=True``
(``energy_network``; collate batches are dst-sorted) the scatter-fused
``conv_aggregate``, with ``edges_sorted=False`` (a caller whose graph is
not dst-sorted) per-edge messages (the ``cg_quad`` kernel) and
``aggregate_messages`` over a stable device sort of dst.  The
self-connection is a linear map of x ('linear') or the fully connected
TP of x with the one-hot species embedding ('nequip', plain PyTorch as
in the JAX package).

The block families of the JAX package (``BlockSpec.block_type``):
'nequip' (CG convolution, gate), 'mace' (CG convolution, then the
symmetric-contraction product basis of ``ops/symmetric_contraction``,
si3 and the residual), 'gaunt' (the Gaunt convolution of ``ops/gaunt``
where both sides carry l > 0, the residual, then the Gaunt product
basis), 'gaunt_gate' (the Gaunt convolution in a gated block),
and 'custom' (a ``CustomBlockSpec`` plugin).  The halo-parallel path
(``run_blocks(exchange_fn=, halo_split=)``, driven by
``parallel/halo``) runs each convolution over two edge partitions: local
sources from the node features, ghost sources from ``exchange_fn(x)``.
``run_blocks(remat=True)`` rematerializes each block (``_RematBlock``):
the double backward of a train step keeps a block's inputs instead of
its activations and recomputes the block; ``resolve_remat`` decides
``remat='auto'`` from the batch's edge slots.
Batches are the padded dicts of ``model.graph`` as tensors
(``batch_to_torch``).
"""

from __future__ import annotations

import functools
import os
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .. import keys as K
from .. import resolve_device, tracing
from ..irreps import Irreps
from ..ops.fused_conv import ConvFamily, cg_family, stride_to_e3nn
from ..ops.fused_conv_agg import convolve
from ..ops.gate import GateSpec, apply_gate, gate_spec
from ..ops.gaunt import (apply_gaunt_pb, gaunt_conv_spec, gaunt_family,
                         gaunt_pb_shapes, gaunt_pb_spec, init_gaunt_pb)
from ..ops.linear import (LinearSpec, apply_linear, init_linear_weights,
                          linear_spec)
from ..ops.mlp import mlp_apply, mlp_init
from ..ops.radial import bessel_basis, bessel_init, poly_cutoff, xplor_cutoff
from ..ops.scatter import (inverse_perm, scatter_rows, segment_sum_sorted,
                           sort_perm)
from ..ops.spherical import spherical_harmonics
from ..ops.symmetric_contraction import (apply_sym_contraction,
                                         init_sym_contraction,
                                         sym_contraction_shapes,
                                         sym_contraction_spec)
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
    gate: Optional[GateSpec]               # None for mace / gaunt blocks
    train_denominator: bool = False
    # the convolution denominator a fresh model starts from (init_params)
    denominator: float = 1.0
    block_type: str = 'nequip'  # 'nequip' | 'mace' | 'gaunt' | 'gaunt_gate'
    conv_kind: str = 'cg'                  # 'cg' | 'gaunt'
    pb_spec: object = None                 # SymContraction / GauntPB spec
    si3: Optional[LinearSpec] = None       # (mace)
    gaunt_conv: object = None              # GauntConvSpec when 'gaunt'

    @functools.cached_property
    def conv(self) -> ConvFamily:
        """The block's convolution for ``convolve`` (built once): the
        Gaunt family's where ``conv_kind`` is 'gaunt', else the CG
        convolution of ``conv_tp``."""
        if self.gaunt_conv is not None:
            return gaunt_family(self.gaunt_conv)
        return cg_family(self.conv_tp, self.act_radial)


@dataclass(frozen=True)
class CustomBlockSpec:
    """User-defined interaction block (the reference's plugin hook,
    reference: sevenn/model_build.py:92-100, config key
    _custom_interaction_block_callback).

    The callback returns one of these per layer, as in the JAX package:
    ``init(rng) -> {name: ndarray}`` creates the block's parameters from
    the numpy generator of ``init_params``; ``apply(params, x, ctx) ->
    x_out`` is PyTorch, with ``params`` a dict {name: tensor} and ``ctx``
    holding onehot, emb (radial embedding), edge_attr (SH), edge_src,
    edge_dst (tensors), n_node and exchange_fn (None, or local -> local +
    ghost rows on the halo-parallel path: apply it before gathering
    edge_src).  A plugin differs between the two packages only in its
    array library."""

    t: int
    irreps_x: Irreps
    irreps_out: Irreps
    init: object
    apply: object
    block_type: str = 'custom'


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
    # each destination keeps its nearest sources within the cutoff
    max_neighbors: Optional[int] = None

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


def build_mace_block(
    t: int,
    irreps_x: Irreps,
    irreps_filter: Irreps,
    irreps_out_tp: Irreps,
    irreps_out: Irreps,
    correlation: int,
    num_species: int,
    radial_hidden: Tuple[int, ...],
    bessel_num: int,
    act_radial: str,
    self_connection: str,
    biases: bool,
    train_denominator: bool = False,
    denominator: float = 1.0,
) -> BlockSpec:
    """MACE interaction block: conv -> si2 to uniform multiplicity ->
    symmetric contraction (product basis) -> si3; no gate (reference:
    sevenn/nn/interaction_blocks.py:89-162)."""
    irreps_out = Irreps(irreps_out)
    if not all(mi.ir.p == (-1) ** mi.ir.l for mi in irreps_out):
        raise ValueError(f'mace output parity must be '
                         f'spherical-harmonics-like, got {irreps_out!r}')
    feature_mul = irreps_out[0].mul
    if not all(mi.mul == feature_mul for mi in irreps_out):
        raise ValueError(f'mace output irreps need one multiplicity, got '
                         f'{irreps_out!r}')

    node_attr_irreps = Irreps(f'{num_species}x0e')
    if self_connection == 'nequip':
        sc = fctp_spec(irreps_x, node_attr_irreps, irreps_out)
    elif self_connection == 'linear':
        sc = linear_spec(irreps_x, irreps_out, biases=False)
    else:
        sc = None

    si1 = linear_spec(irreps_x, irreps_x, biases=biases)
    conv_tp = uvu_tp_spec(irreps_x, irreps_filter, irreps_out_tp)
    conv_out_simpl = conv_tp.irreps_out.simplify()
    # uniform multiplicity for the product basis (reference:
    # interaction_blocks.py:113-118)
    irreps_si2_out = Irreps(
        [(feature_mul, mi.ir) for mi in irreps_out_tp]
    )
    si2 = linear_spec(conv_out_simpl, irreps_si2_out, biases=biases)
    pb = sym_contraction_spec(irreps_si2_out, irreps_out, correlation,
                              num_species)
    si3 = linear_spec(irreps_out, irreps_out, biases=biases)
    return BlockSpec(
        t=t,
        irreps_x=irreps_x,
        irreps_out=irreps_out,
        self_connection=self_connection,
        sc_spec=sc,
        si1=si1,
        conv_tp=conv_tp,
        radial_hs=(bessel_num,) + tuple(radial_hidden)
        + (conv_tp.weight_numel,),
        act_radial=act_radial,
        si2=si2,
        gate=None,
        train_denominator=train_denominator,
        denominator=denominator,
        block_type='mace',
        pb_spec=pb,
        si3=si3,
    )


def build_gaunt_block(
    t: int,
    irreps_x: Irreps,
    irreps_filter: Irreps,
    irreps_out_tp: Irreps,
    irreps_out: Irreps,
    num_species: int,
    radial_hidden: Tuple[int, ...],
    bessel_num: int,
    act_radial: str,
    self_connection: str,
    biases: bool,
    gate_block: bool,
    act_scalar: Optional[Dict[str, str]] = None,
    act_gate: Optional[Dict[str, str]] = None,
    correlation: int = 3,
    train_denominator: bool = False,
    denominator: float = 1.0,
) -> BlockSpec:
    """Gaunt interaction blocks (reference:
    sevenn/nn/interaction_blocks.py:165-335).

    gate_block=True -> 'gaunt_gate': NequIP structure whose convolution
    uses the Fourier-basis Gaunt product (the CG convolution when either
    side is scalar-only).  gate_block=False -> 'gaunt':
    uniform-multiplicity blocks with a Gaunt self-product basis and no
    gate."""
    node_attr_irreps = Irreps(f'{num_species}x0e')
    use_gaunt_conv = irreps_x.lmax > 0 and Irreps(irreps_out_tp).lmax > 0

    if gate_block:
        gate = gate_spec(irreps_out, act_scalar, act_gate)
        target = gate.irreps_in
    else:
        gate = None
        target = Irreps(irreps_out_tp)

    if self_connection == 'nequip':
        sc = fctp_spec(irreps_x, node_attr_irreps, target)
    elif self_connection == 'linear':
        sc = linear_spec(irreps_x, target, biases=False)
    else:
        sc = None

    si1 = linear_spec(irreps_x, irreps_x, biases=biases)
    conv_tp = uvu_tp_spec(irreps_x, irreps_filter, irreps_out_tp)
    if use_gaunt_conv:
        gconv = gaunt_conv_spec(
            irreps_x, irreps_filter, Irreps(irreps_out_tp),
            radial_hidden, bessel_num, act_radial,
        )
        radial_hs = (bessel_num,) + tuple(radial_hidden) \
            + (gconv.weight_numel,)
        conv_out = Irreps(irreps_out_tp)
    else:
        gconv = None
        radial_hs = (bessel_num,) + tuple(radial_hidden) \
            + (conv_tp.weight_numel,)
        conv_out = conv_tp.irreps_out.simplify()

    si2 = linear_spec(conv_out, target, biases=biases)
    pb = None
    if not gate_block:
        pb = gaunt_pb_spec(Irreps(irreps_out_tp), irreps_out, correlation)

    return BlockSpec(
        t=t,
        irreps_x=irreps_x,
        irreps_out=(gate.irreps_out if gate_block else Irreps(irreps_out)),
        self_connection=self_connection,
        sc_spec=sc,
        si1=si1,
        conv_tp=conv_tp,
        radial_hs=radial_hs,
        act_radial=act_radial,
        si2=si2,
        gate=gate,
        train_denominator=train_denominator,
        denominator=denominator,
        block_type=('gaunt_gate' if gate_block else 'gaunt'),
        pb_spec=pb,
        conv_kind=('gaunt' if use_gaunt_conv else 'cg'),
        gaunt_conv=gconv,
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
        if blk.block_type == 'custom':
            # the plugin's init, drawn from a throwaway generator
            p[f'{t}_custom_block'] = {
                n: tuple(np.shape(v))
                for n, v in blk.init(np.random.default_rng(0)).items()}
            continue
        if blk.self_connection in ('nequip', 'linear'):
            p[f'{t}_self_connection_intro'] = _linear_shapes(blk.sc_spec)
        p[f'{t}_self_interaction_1'] = _linear_shapes(blk.si1)
        conv = {f'weight_nn_w{i}': (h_in, h_out) for i, (h_in, h_out)
                in enumerate(zip(blk.radial_hs[:-1], blk.radial_hs[1:]))}
        conv['denominator'] = (1,)
        p[f'{t}_convolution'] = conv
        p[f'{t}_self_interaction_2'] = _linear_shapes(blk.si2)
        if blk.block_type == 'mace':
            p[f'{t}_equivariant_product_basis'] = sym_contraction_shapes(
                blk.pb_spec)
            p[f'{t}_self_interaction_3'] = _linear_shapes(blk.si3)
        elif blk.block_type == 'gaunt':
            p[f'{t}_gaunt_product_basis'] = gaunt_pb_shapes(blk.pb_spec)
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
    require_model_spec(spec, 'init_params (the training path)')
    rng = np.random.default_rng(seed)
    p: Dict[str, Dict[str, np.ndarray]] = {
        'edge_embedding': {'bessel_coeffs': bessel_init(
            spec.edge.cutoff, spec.edge.bessel_num).astype(np.float32)},
        'onehot_to_feature_x': _linear_params(_embed_spec(spec), rng),
    }
    for blk in spec.blocks:
        t = blk.t
        if blk.block_type == 'custom':
            p[f'{t}_custom_block'] = blk.init(rng)
            continue
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
        # the product-basis draws follow the block's others, in JAX's order
        if blk.block_type == 'mace':
            p[f'{t}_equivariant_product_basis'] = init_sym_contraction(
                blk.pb_spec, rng)
            p[f'{t}_self_interaction_3'] = _linear_params(blk.si3, rng)
        elif blk.block_type == 'gaunt':
            p[f'{t}_gaunt_product_basis'] = init_gaunt_pb(blk.pb_spec, rng)
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

    def energy_network(self, data, edge_vec, remat=False):
        """``energy_network`` of this model (``apply_model``'s family
        dispatch: another family's module brings its own)."""
        return energy_network(self, data, edge_vec, remat=remat)


def load_jax_params(model: NequIP, params_np) -> NequIP:
    """Copy a JAX parameter dict ({'0_convolution': {'weight_nn_w0': ...},
    ...}, numpy arrays) onto the model; every group, name and shape must
    match exactly."""
    want = {group: {name: tuple(v.shape) for name, v in names.items()}
            for group, names in model.params.items()}
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
        if blk.block_type == 'custom':
            continue
        mask[f'{blk.t}_convolution']['denominator'] = blk.train_denominator
    mask['rescale_atomic_energy']['shift'] = spec.train_shift_scale
    mask['rescale_atomic_energy']['scale'] = spec.train_shift_scale
    return mask


def require_model_spec(spec, what: str):
    """NotImplementedError for ``what`` on a spec of a family that is not
    a ``ModelSpec`` ('equiformer_v2', ``model/equiformer_v2``: it serves
    energies, forces and stress through the Calculator only)."""
    if not isinstance(spec, ModelSpec):
        raise NotImplementedError(
            f'{what} is not implemented for {type(spec).__name__}: that '
            'family serves energies, forces and stress through the '
            'Calculator only')


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


def _device_bytes(device) -> int:
    """Total memory of ``device``: the card's, or the host's physical RAM
    for the CPU."""
    device = resolve_device(device)
    if device.type == 'cuda':
        return torch.cuda.get_device_properties(device).total_memory
    return os.sysconf('SC_PAGE_SIZE') * os.sysconf('SC_PHYS_PAGES')


def resolve_remat(spec: ModelSpec, n_edge: int, remat='auto',
                  device=None) -> bool:
    """Resolve ``remat='auto'`` from the batch's edge slots (JAX
    ``resolve_remat``, the same formula); True and False pass through.

    Rematerializing each block cuts the double backward's activation
    memory by about the number of blocks and recomputes every block
    twice more, so 'auto' turns it on only when the estimated live
    per-edge message residuals exceed the activation budget: 3 float32
    copies (the fused convolution keeps its operands and outputs) of
    each block's convolution output irreps per edge slot, summed over
    the blocks; a block without a CG tensor product (a custom plugin)
    counts 4 x its input irreps' dim, JAX's Gaunt-grid rule.  A tuple
    ``('auto', scale)`` scales the estimate.

    The budget is ``SEVENNET_TPU_ACT_BUDGET_GB`` (GiB; the JAX package's
    variable, so one setting drives both) or, unset, 5/8 of the memory
    of ``device`` (the card's total memory, the host's physical RAM for
    the CPU; cuda unless named): the estimate counts the per-edge
    residuals only, and the other 3/8 is left for what it does not count
    -- parameters and optimizer state, node-sized tensors, the kernels'
    workspaces and the allocator's slack."""
    scale = 1.0
    if isinstance(remat, tuple):
        remat, scale = remat
    if remat != 'auto':
        return bool(remat)
    env = os.environ.get('SEVENNET_TPU_ACT_BUDGET_GB')
    budget = (float(env) * 2.0 ** 30 if env is not None
              else 5 / 8 * _device_bytes(device))
    mid = 0
    for b in spec.blocks:
        tp = getattr(b, 'conv_tp', None)
        mid += tp.irreps_out.dim if tp is not None else 4 * b.irreps_x.dim
    est_bytes = 3.0 * 4.0 * float(n_edge) * float(mid) * scale
    return est_bytes > budget


class _BlockCall:
    """One interaction block as a function of its differentiable inputs
    only: ``call(x, emb, edge_attr, *leaves)``, the leaves being the
    block's own parameter groups (``f'{t}_*'``) flattened in ``keys``'
    order.  Everything else the block reads is fixed here and must not
    require grad: a gradient through a closure would be lost."""

    def __init__(self, blk, p, onehot, edge_src, edge_dst, n_node, src_perm,
                 src_inv, dst_sort):
        prefix = f'{blk.t}_'
        self.keys = [(g, n) for g in p if g.startswith(prefix)
                     for n in p[g]]
        self.leaves = [p[g][n] for g, n in self.keys]
        fixed = (onehot, edge_src, edge_dst, src_perm, src_inv,
                 *(dst_sort or ()))
        if any(isinstance(t, torch.Tensor) and t.requires_grad
               for t in fixed):
            raise ValueError('remat: a tensor the block closes over '
                             'requires grad, and would get none')
        self.blk, self.n_node = blk, n_node
        self.onehot, self.edge_src, self.edge_dst = onehot, edge_src, edge_dst
        self.src_perm, self.src_inv, self.dst_sort = src_perm, src_inv, dst_sort

    def __call__(self, x, emb, edge_attr, *leaves):
        p: Dict[str, Dict[str, torch.Tensor]] = {}
        for (g, n), v in zip(self.keys, leaves):
            p.setdefault(g, {})[n] = v
        return _run_one_block(self.blk, p, x, self.onehot, emb, edge_attr,
                              self.edge_src, self.edge_dst, self.n_node,
                              _no_cap, self.src_perm, self.src_inv,
                              self.dst_sort, None, None)


def _no_cap(name, val):
    return None


def _block_vjp(call, need, ybar, inputs, create_graph):
    """Recompute the block from ``inputs`` and return the VJP of ``ybar``
    with respect to the inputs flagged in ``need`` (zeros where the block
    does not use one), with those inputs as recomputed leaves."""
    ins = [t.detach().requires_grad_(m) for t, m in zip(inputs, need)]
    wrt = [t for t, m in zip(ins, need) if m]
    grads = torch.autograd.grad(call(*ins), wrt, ybar,
                                create_graph=create_graph, allow_unused=True)
    return wrt, [torch.zeros_like(t) if g is None else g
                 for g, t in zip(grads, wrt)]


class _RematBlock(torch.autograd.Function):
    """A block that keeps only its inputs for the backward (the JAX
    package's ``jax.checkpoint`` of one block).  Its backward is
    ``_RematBlockVjp``, a Function too, so the force pass's
    ``create_graph=True`` backward records one node per block, holding
    the block's inputs and cotangent, instead of the block's
    activations."""

    @staticmethod
    def forward(ctx, call, x, emb, edge_attr, *leaves):
        ctx.call = call
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(x, emb, edge_attr, *leaves)
        return call(x, emb, edge_attr, *leaves)

    @staticmethod
    def backward(ctx, ybar):
        need = ctx.needs_input_grad[1:]
        if ybar is None or not any(need):
            return (None,) * (1 + len(need))
        # a create_graph backward (the force pass) takes the VJP with
        # create_graph, so its values are the plain path's bit for bit
        grads = _RematBlockVjp.apply(ctx.call, need,
                                     torch.is_grad_enabled(), ybar,
                                     *ctx.saved_tensors)
        grads = iter((grads,) if isinstance(grads, torch.Tensor) else grads)
        return (None,) + tuple(next(grads) if m else None for m in need)


class _RematBlockVjp(torch.autograd.Function):
    """The VJP of one block, recomputed from its inputs.  The forward
    runs the block and its VJP without keeping their graph and saves
    only the cotangent and the inputs; the backward runs both again with
    ``create_graph=True`` and differentiates once more (a second-order
    train step's last order: a third raises)."""

    @staticmethod
    def forward(ctx, call, need, create_graph, ybar, *inputs):
        ctx.call, ctx.need = call, need
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(ybar, *inputs)
        with torch.enable_grad():
            _, grads = _block_vjp(call, need, ybar, inputs, create_graph)
        return tuple(g.detach() for g in grads)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, *gbar):
        ybar, *inputs = ctx.saved_tensors
        need_ybar = ctx.needs_input_grad[3]
        with torch.enable_grad():
            yb = ybar.detach().requires_grad_(need_ybar)
            wrt, grads = _block_vjp(ctx.call, ctx.need, yb, inputs, True)
            pairs = [(g, gb) for g, gb in zip(grads, gbar)
                     if gb is not None and g.requires_grad]
            srcs = ([yb] if need_ybar else []) + wrt
            d = ([None] * len(srcs) if not pairs else torch.autograd.grad(
                [g for g, _ in pairs], srcs, [gb for _, gb in pairs],
                allow_unused=True))
        d = iter(d)
        d_ybar = next(d) if need_ybar else None
        return (None, None, None, d_ybar,
                *(next(d) if m else None for m in ctx.need))


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

    ``exchange_fn``, when given, maps local features to the local +
    ghost rows the sources index (the halo exchange).  ``halo_split``
    ({'loc': {...}, 'gh': {...}}, each with src, dst, emb, sh, perm and
    inv) splits the edges by source locality: each convolution runs on
    the local-source edges from ``x`` and on the ghost-source edges from
    ``exchange_fn(x)``, and adds the two.

    ``remat=True`` rematerializes each block (``_RematBlock``): the
    training double backward otherwise keeps every block's per-edge
    activations live until the parameter gradient; with it a block keeps
    its inputs and is recomputed in the backward.  It takes no ``cap``,
    and no halo exchange: a recompute in the backward would repeat the
    block's swaps, out of the order every rank must keep."""
    if cap is None:
        cap = _no_cap
    elif remat:
        raise ValueError('intermediate capture requires remat=False')
    if remat and (exchange_fn is not None or halo_split is not None):
        raise ValueError('remat with a halo exchange: a block recomputed in '
                         'the backward would repeat its swaps, out of the '
                         'order every rank must keep')
    if src_perm is None:
        src_perm, src_inv = sort_perm(edge_src)
    elif src_inv is None:
        src_inv = inverse_perm(src_perm)
    dst_sort = None if edges_sorted else sort_perm(edge_dst)
    for blk in spec.blocks:
        if remat:
            call = _BlockCall(blk, params, onehot, edge_src, edge_dst,
                              n_node, src_perm, src_inv, dst_sort)
            x = _RematBlock.apply(call, x, emb, edge_attr, *call.leaves)
        else:
            x = _run_one_block(blk, params, x, onehot, emb, edge_attr,
                               edge_src, edge_dst, n_node, cap, src_perm,
                               src_inv, dst_sort, exchange_fn, halo_split)
    return x


def _partitions(x, exchange_fn, halo_split, whole):
    """(source rows, edges) of each edge partition, lazily: the whole edge
    set from ``x`` (or its exchange buffer), or with ``halo_split`` the
    local-source edges from ``x``, then the ghost-source ones from the
    exchange buffer."""
    if halo_split is None:
        yield (x if exchange_fn is None else exchange_fn(x)), whole
    else:
        yield x, halo_split['loc']
        yield exchange_fn(x), halo_split['gh']


def _run_one_block(blk, p, x, onehot, emb, edge_attr, edge_src, edge_dst,
                   n_node, cap, src_perm, src_inv, dst_sort, exchange_fn,
                   halo_split):
    t = blk.t
    if blk.block_type == 'custom':
        ctx = dict(onehot=onehot, emb=emb, edge_attr=edge_attr,
                   edge_src=edge_src, edge_dst=edge_dst, n_node=n_node,
                   exchange_fn=exchange_fn)
        x = blk.apply(dict(p[f'{t}_custom_block'].items()), x, ctx)
        cap(f'{t}_custom_block', x)
        return x
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

    conv_p = p[f'{t}_convolution']
    mlp_w = [conv_p[f'weight_nn_w{i}'] for i in range(len(blk.radial_hs) - 1)]
    whole = dict(src=edge_src, dst=edge_dst, emb=emb, sh=edge_attr,
                 perm=src_perm, inv=src_inv, dst_sort=dst_sort)
    x = convolve(blk.conv, mlp_w,
                 _partitions(x, exchange_fn, halo_split, whole), n_node,
                 conv_p['denominator'])
    cap(f'{t}_convolution', x)

    x = apply_linear(blk.si2, _linear_w(p[f'{t}_self_interaction_2']), x)
    cap(f'{t}_self_interaction_2', x)
    if blk.block_type == 'gaunt':
        if sc is not None:
            x = x + sc
        x = apply_gaunt_pb(blk.pb_spec, p[f'{t}_gaunt_product_basis'], x)
        cap(f'{t}_gaunt_product_basis', x)
    elif blk.block_type == 'mace':
        x = apply_sym_contraction(
            blk.pb_spec, p[f'{t}_equivariant_product_basis'], x, onehot)
        cap(f'{t}_equivariant_product_basis', x)
        x = apply_linear(blk.si3, _linear_w(p[f'{t}_self_interaction_3']), x)
        cap(f'{t}_self_interaction_3', x)
        if sc is not None:
            x = x + sc
    else:
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
    remat=False,
) -> Dict[str, torch.Tensor]:
    """Edge vectors + graph -> atomic & total energies.  ``remat`` may be
    True, False or 'auto' (``resolve_remat`` at the batch's edge slots
    and ``edge_vec``'s device).

    Pass ``intermediates={}`` to capture per-stage node features (keys
    like '0_convolution', '1_equivariant_gate'...)."""
    spec, p = model.spec, model.params
    out = dict(data)
    remat = resolve_remat(spec, data[K.EDGE_IDX].shape[1], remat,
                          edge_vec.device)

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
                   n_node, cap=(cap if intermediates is not None else None),
                   remat=remat, edges_sorted=True,
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


def apply_model(model: NequIP, data: Dict[str, torch.Tensor],
                remat=False) -> Dict[str, torch.Tensor]:
    """Full forward for serving: energies + forces + stress via one
    autograd.grad of the total energy over edge vectors (reference:
    sevenn/nn/force_output.py:158-215); results are detached.  ``remat``:
    as in ``energy_network``."""
    with tracing.span('model.forward'):
        edge_vec = compute_edge_vec(data).detach().requires_grad_(True)
        with torch.enable_grad():
            out = model.energy_network(data, edge_vec, remat=remat)
    with tracing.span('model.grad'), torch.enable_grad():
        fij, = torch.autograd.grad(out[K.PRED_TOTAL_ENERGY].sum(), edge_vec)
    with tracing.span('model.forces_stress'):
        out = _forces_and_stress(out, data, edge_vec, fij)
        return detach_outputs(out)


def detach_outputs(out: Dict) -> Dict:
    """Tensors detached; the data-weight dict passes through."""
    return {k: v.detach() if isinstance(v, torch.Tensor) else v
            for k, v in out.items()}


def apply_model_train(model: NequIP, data: Dict[str, torch.Tensor],
                      remat=False) -> Dict[str, torch.Tensor]:
    """Full forward for training: as ``apply_model``, but the force pass
    keeps its graph (``create_graph=True``) and nothing is detached, so
    a loss on energies, forces and stress backpropagates to the
    parameters through a double backward of the convolution (the JAX
    package's ``value_and_grad`` over ``apply_model``).  ``remat``: as
    in ``energy_network``."""
    edge_vec = compute_edge_vec(data).detach().requires_grad_(True)
    out = energy_network(model, data, edge_vec, remat=remat)
    fij, = torch.autograd.grad(out[K.PRED_TOTAL_ENERGY].sum(), edge_vec,
                               create_graph=True)
    return _forces_and_stress(out, data, edge_vec, fij)
