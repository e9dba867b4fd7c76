"""Import weights from reference deployed TorchScript models.

The reference ships frozen TorchScript potentials (reference:
sevenn/scripts/deploy.py:15-51) whose parameters are inlined as graph
constants in execution order.  Because our parameter layout mirrors the
reference layer-for-layer, the frozen constants can be re-bound to our
named params by walking them in order and matching against the expected
shape sequence of the ModelSpec.

Transformations on import:
- radial-MLP matrices are stored pre-divided by sqrt(fan_in) in the
  frozen graph (constant folding of e3nn's forward); multiply back
- everything else (linear / FCTP weights, bessel coefficients,
  denominators, shift/scale) imports verbatim

Requires host-side torch (CPU) only.

Port of ``sevennet_finetuning_tpu/compat/torchscript_import.py``: the same
expected sequence, graph walkers and frozen-config parse, on the port's
own specs.
"""

from __future__ import annotations

import math
import re
from typing import Dict, List, Optional, Tuple

import numpy as np

from .. import keys as K
from ..data.elements import symbol_to_z
from ..model.build import build_model_spec
from ..model.nequip import ModelSpec
from ..ops.linear import LinearSpec
from ..ops.tensor_product import TensorProductSpec


def _expected_sequence(spec: ModelSpec):
    """[(param_group, param_name, shape, transform, in_offset), ...] in the
    frozen graph's execution order.  ``in_offset`` is the start of the
    input-irrep slice the weight consumes (disambiguates equal-shape
    weights within a layer after freeze reorders independent ops)."""
    seq: List[Tuple[str, str, tuple, str, Optional[int]]] = []
    seq.append(('edge_embedding', 'bessel_coeffs',
                (spec.edge.bessel_num,), 1.0, None))

    def linear(group: str, ls: LinearSpec):
        slices = ls.irreps_in.slices()
        for i, ins in enumerate(ls.instructions):
            off = slices[ins.i_in].start if ins.i_in >= 0 else None
            seq.append((group, f'w{i}', tuple(ins.weight_shape), ins.coeff,
                        off))

    def fctp(group: str, ts: TensorProductSpec):
        slices = ts.irreps_in1.slices()
        for i, ins in enumerate(ts.instructions):
            l1 = ts.irreps_in1[ins.i_in1].ir.l
            l2 = ts.irreps_in2[ins.i_in2].ir.l
            lo = ts.irreps_out[ins.i_out].ir.l
            # e3nn's codegen scalarizes l x 0 -> l paths: the diagonal
            # w3j value 1/sqrt(2l+1) joins the path coefficient in the
            # single scalar factor the frozen graph carries
            s = ins.coeff
            if l1 == 0 or l2 == 0:
                s = ins.coeff / math.sqrt(2 * lo + 1)
            seq.append((group, f'w{i}', tuple(ins.weight_shape), s,
                        slices[ins.i_in1].start))

    from ..irreps import Irreps
    from ..ops.linear import linear_spec

    embed = linear_spec(Irreps(f'{spec.num_species}x0e'),
                        spec.blocks[0].irreps_x,
                        biases=spec.use_bias_in_linear)
    linear('onehot_to_feature_x', embed)

    for blk in spec.blocks:
        t = blk.t
        if blk.self_connection == 'nequip':
            fctp(f'{t}_self_connection_intro', blk.sc_spec)
        elif blk.self_connection == 'linear':
            linear(f'{t}_self_connection_intro', blk.sc_spec)
        linear(f'{t}_self_interaction_1', blk.si1)
        hs = blk.radial_hs
        for i, (h_in, _) in enumerate(zip(hs[:-1], hs[1:])):
            seq.append((f'{t}_convolution', f'weight_nn_w{i}',
                        (h_in, hs[i + 1]), 1.0 / math.sqrt(h_in), None))
        seq.append((f'{t}_convolution', 'denominator', (1,), 1.0, None))
        linear(f'{t}_self_interaction_2', blk.si2)

    if spec.readout.as_fcn:
        hs = spec.readout.fcn_hs
        for i, h_in in enumerate(hs[:-1]):
            seq.append(('readout_FCN', f'w{i}', (h_in, hs[i + 1]),
                        1.0 / math.sqrt(h_in), None))
    else:
        linear('reduce_input_to_hidden', spec.readout.lin1)
        linear('reduce_hidden_to_energy', spec.readout.lin2)

    n_sc = len(spec.shift)
    seq.append(('rescale_atomic_energy', 'scale', (n_sc,), 1.0, None))
    seq.append(('rescale_atomic_energy', 'shift', (n_sc,), 1.0, None))
    return seq


def import_deployed_serial(
    path: str,
    config_overrides: Optional[Dict] = None,
) -> Tuple[ModelSpec, Dict, Dict, Dict]:
    """Load a frozen deployed_serial.pt -> (spec, params, meta, config).

    Architecture hyperparameters not recoverable from a frozen graph
    (irreps_manual, exact layer count...) can be supplied via
    ``config_overrides``; shape-matching validates the result and raises
    on any inconsistency.
    """
    import torch

    extra = {
        'chemical_symbols_to_index': '',
        'cutoff': '',
        'num_species': '',
        'model_type': '',
        'version': '',
        'dtype': '',
    }
    m = torch.jit.load(path, map_location='cpu', _extra_files=extra)
    meta = {k: v.decode() if isinstance(v, bytes) else v
            for k, v in extra.items()}
    code, consts = m.code_with_constants
    cmap = consts.const_mapping

    config = _config_from_frozen(code, cmap, meta)
    if config_overrides:
        config.update(config_overrides)
    spec = build_model_spec(config)

    seq = _expected_sequence(spec)
    # group the expected sequence: freeze reorders independent ops WITHIN
    # a layer, so per group we match a shape multiset, disambiguating
    # equal shapes by the input-irrep slice offset traced from the graph.
    groups: List[Tuple[str, List]] = []
    for group, pname, shape, transform, off in seq:
        if not groups or groups[-1][0] != group:
            groups.append((group, []))
        groups[-1][1].append([pname, shape, transform, off, None])

    weight_ops = _extract_weight_ops(m.graph)

    gi = 0
    matched = 0
    for arr, traced_off, input_muls in weight_ops:
        if gi >= len(groups):
            break

        def try_consume(items) -> bool:
            nonlocal matched
            cands = [
                it for it in items
                if it[4] is None and tuple(arr.shape) == it[1]
            ]
            if len(cands) > 1 and traced_off is not None:
                by_off = [it for it in cands if it[3] == traced_off]
                if by_off:
                    cands = by_off
            if not cands:
                return False
            it = cands[0]
            coeff = it[2]
            # e3nn's codegen applies the path coefficient to the INPUT on
            # scalar fast paths (an explicit mul survives freezing) but to
            # the OUTPUT on generic paths, where freezing folds it into
            # the stored constant -- divide it back out in that case
            explicit = any(abs(s - coeff) < 1e-6 * max(1.0, abs(coeff))
                           for s in input_muls)
            a = arr if explicit or coeff == 1.0 else arr / coeff
            it[4] = np.asarray(a, dtype=np.float32)
            matched += 1
            return True

        if try_consume(groups[gi][1]):
            continue
        while gi < len(groups) and all(
            it[4] is not None for it in groups[gi][1]
        ):
            gi += 1
            if gi < len(groups) and try_consume(groups[gi][1]):
                break

    params: Dict[str, Dict[str, np.ndarray]] = {}
    unmatched = []
    for gname, items in groups:
        for pname, shape, _, _, arr in items:
            if arr is None:
                unmatched.append((gname, pname, shape))
            else:
                params.setdefault(gname, {})[pname] = arr
    if unmatched:
        raise RuntimeError(
            f'weight import incomplete: matched {matched}/{len(seq)}; '
            f'unmatched (first 5): {unmatched[:5]}'
        )
    return spec, params, meta, config


_WEIGHT_OP_KINDS = {
    'aten::tensordot', 'aten::einsum', 'aten::matmul',
    'aten::div', 'aten::mul', 'aten::add',
    # species-wise rescale gathers shift/scale by atom type
    'aten::index_select', 'aten::index', 'aten::embedding',
}
_TRACE_THROUGH = {
    'aten::mul', 'aten::reshape', 'aten::permute', 'aten::broadcast_to',
    'aten::expand', 'aten::einsum', 'aten::contiguous', 'aten::view',
    'aten::unsqueeze', 'aten::to', 'prim::ListConstruct', 'aten::div',
    'aten::slice', 'aten::narrow',
}


def _scan_inputs(value, offsets, muls, depth=0, seen=None):
    """DFS up the producer chain collecting dim-1 slice starts and scalar
    multiplier values."""
    if seen is None:
        seen = set()
    if depth > 16 or value.unique() in seen:
        return
    seen.add(value.unique())
    node = value.node()
    kind = node.kind()
    ins = list(node.inputs())
    if kind in ('aten::slice', 'aten::narrow'):
        try:
            dim = ins[1].toIValue()
            start = ins[2].toIValue()
        except RuntimeError:
            dim, start = None, None
        if dim in (1, -1) and isinstance(start, int) and start >= 0:
            offsets.append(start)
        _scan_inputs(ins[0], offsets, muls, depth + 1, seen)
        return
    if kind == 'aten::mul':
        for i in ins:
            prod = i.node()
            if prod.kind() == 'prim::Constant':
                try:
                    v = i.toIValue()
                except RuntimeError:
                    v = None
                if v is not None and hasattr(v, 'dim') and v.dim() == 0:
                    muls.append(float(v))
                elif isinstance(v, (int, float)):
                    muls.append(float(v))
            else:
                _scan_inputs(i, offsets, muls, depth + 1, seen)
        return
    if kind in _TRACE_THROUGH:
        for i in ins:
            tk = i.type().kind()
            if tk in ('TensorType', 'ListType'):
                _scan_inputs(i, offsets, muls, depth + 1, seen)
        return


def _walk_nodes(block):
    for node in block.nodes():
        yield node
        for b in node.blocks():
            yield from _walk_nodes(b)


def _scan_consumers(value, muls, depth=0):
    """Collect scalar-mul constants applied to this op's OUTPUT (older
    torch versions leave the path coefficient as a consumer-side mul
    instead of folding it into the weight)."""
    if depth > 4:
        return
    for use in value.uses():
        user = use.user
        kind = user.kind()
        if kind == 'aten::mul':
            for i in user.inputs():
                prod = i.node()
                if prod.kind() == 'prim::Constant':
                    try:
                        v = i.toIValue()
                    except RuntimeError:
                        v = None
                    if v is not None and hasattr(v, 'dim') and v.dim() == 0:
                        muls.append(float(v))
                    elif isinstance(v, (int, float)):
                        muls.append(float(v))
        elif kind in ('aten::reshape', 'aten::permute', 'aten::view',
                      'aten::contiguous'):
            _scan_consumers(user.output(), muls, depth + 1)


def _extract_weight_ops(graph):
    """(constant ndarray, first traced input offset or None, scalar-mul
    values in the input chain) for every weighted op, in graph order."""
    out = []
    for node in _walk_nodes(graph):
        if node.kind() not in _WEIGHT_OP_KINDS:
            continue
        const_arr = None
        data_inputs = []
        for i in node.inputs():
            prod = i.node()
            if prod.kind() == 'prim::Constant' and \
                    i.type().kind() == 'TensorType':
                t = prod.t('value')
                if t.dim() >= 1:
                    const_arr = t.detach().numpy()
            elif i.type().kind() in ('TensorType', 'ListType'):
                data_inputs.append(i)
        if const_arr is None:
            continue
        offsets = []
        muls = []
        for di in data_inputs:
            _scan_inputs(di, offsets, muls)
        if not offsets:
            # the weight may contract the unsliced operand first (e.g.
            # FCTP on the scalar attr), the sliced features joining in a
            # consumer einsum -- scan the consumers' other inputs
            for use in node.output().uses():
                user = use.user
                if user.kind() in _WEIGHT_OP_KINDS or \
                        user.kind() in _TRACE_THROUGH:
                    for i in user.inputs():
                        if i.node() is node:
                            continue
                        if i.type().kind() in ('TensorType', 'ListType'):
                            _scan_inputs(i, offsets, muls)
        _scan_consumers(node.output(), muls)
        off = offsets[0] if offsets else None
        out.append((const_arr, off, muls))
    return out


def _config_from_frozen(code: str, cmap, meta: Dict) -> Dict:
    """Recover architecture hyperparameters visible in a frozen graph.

    Deeper choices (irreps_manual, exact layer count, parity...) are not
    reliably recoverable once frozen; pass them via ``config_overrides``
    -- shape matching during import validates the combination.
    """
    cutoff = float(meta['cutoff'])
    num_species = int(meta['num_species'])
    chem = meta['chemical_symbols_to_index'].split()
    type_map = {symbol_to_z(s): i for i, s in enumerate(chem)}

    bessel_num = int(cmap['c0'].numel())

    mxplor = re.search(r'torch\.lt\((?:\w+), (\d+\.?\d*)\)', code)
    head = code.split('one_hot')[0]
    if mxplor is not None and 'torch.where' in head:
        cutoff_fn = {K.CUTOFF_FUNCTION_NAME: 'XPLOR',
                     K.CUTOFF_ON: float(mxplor.group(1))}
    else:
        cutoff_fn = {K.CUTOFF_FUNCTION_NAME: 'poly_cut'}

    normalize_sph = 'clamp_min' in head

    sh_ls = set(int(x) for x in re.findall(r'sh_(\d+)_\d+', code))
    lmax = max(sh_ls) if sh_ls else 1

    # embedding weight (num_species, channel0) is the first 2D constant
    channel0 = None
    for i in range(0, 40):
        key = f'c{i}'
        if key in cmap.keys():
            v = cmap[key]
            if hasattr(v, 'dim') and v.dim() == 2 \
                    and v.shape[0] == num_species:
                channel0 = int(v.shape[1])
                break
    assert channel0 is not None, 'could not locate embedding weight'

    return {
        K.NUM_SPECIES: num_species,
        K.TYPE_MAP: type_map,
        K.CUTOFF: cutoff,
        K.NODE_FEATURE_MULTIPLICITY: channel0,
        K.LMAX: lmax,
        K.IS_PARITY: True,
        K.NUM_CONVOLUTION: 3,
        K.RADIAL_BASIS: {K.RADIAL_BASIS_NAME: 'bessel',
                         K.BESSEL_BASIS_NUM: bessel_num},
        K.CUTOFF_FUNCTION: cutoff_fn,
        K._NORMALIZE_SPH: normalize_sph,
        K.SELF_CONNECTION_TYPE: 'nequip',
        K.CONV_DENOMINATOR: 1.0,
        K.SHIFT: 0.0,
        K.SCALE: 1.0,
    }
