"""Import reference training checkpoints / state dicts (.pth / .pt).

The reference fine-tunes *from a training checkpoint*
(reference: sevenn/util.py:95-183 ``model_from_checkpoint``;
sevenn/scripts/processing_continue.py:59-150): a ``torch.save`` dict
holding ``model_state_dict`` (e3nn-layout named tensors), the full flat
config, optimizer/scheduler state, and the epoch.  This module maps that
layout onto our ``ModelSpec`` params:

- e3nn ``Linear`` stores ONE flat weight vector per layer, the
  concatenation of per-instruction ``(mul_in, mul_out)`` blocks in
  instruction order (input-irrep-major), biases in a separate flat
  vector over scalar outputs.  Our ``linear_spec`` enumerates the same
  instruction order, and both conventions store the RAW weight with the
  path-normalization coefficient applied at forward time -- so the import
  is a pure split + reshape, bit-for-bit.
- e3nn ``FullyConnectedTensorProduct`` (the 'nequip' self connection,
  reference: sevenn/nn/self_connection.py:11-38) similarly concatenates
  ``(mul1, mul2, mul_out)`` blocks in (in1, in2, out)-major instruction
  order, matched by ``fctp_spec``.
- radial MLPs (``FullyConnectedNet``) store per-layer ``(in, out)``
  matrices verbatim (forward divides by sqrt(fan_in) in both frameworks).
- ``denominator`` / ``shift`` / ``scale`` / bessel coeffs import verbatim.

Works on raw named-parameter dicts too (e.g. the reference's shipped
``opt_params_sevenn.pt`` -- SevenNet-0's full parameter set from the
Fisher run), given the architecture config.

Only the nequip interaction family (the reference's released models) is
covered; MACE/Gaunt state dicts raise with the unmatched key list.
Requires host-side torch (CPU) only.

Port of ``sevennet_finetuning_tpu/compat/state_dict_import.py``: the same
schema and the same checks; a frozen TorchScript artifact goes through
this package's ``compat.torchscript_import``.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from .. import keys as K
from ..model.build import build_model_spec
from ..model.nequip import ModelSpec
from ..ops.linear import LinearSpec

# state-dict buffers with no counterpart in our functional params
_IGNORED_SUFFIXES = ('output_mask', '_w3j', 'num_batched_tensors')


def _linear_entries(ls: LinearSpec):
    """(weight split plan, bias split plan): [(pname, shape), ...]."""
    w_plan: List[Tuple[str, tuple]] = []
    b_plan: List[Tuple[str, tuple]] = []
    for i, ins in enumerate(ls.instructions):
        if ins.i_in >= 0:
            w_plan.append((f'w{i}', tuple(ins.weight_shape)))
        else:
            b_plan.append((f'w{i}', tuple(ins.weight_shape)))
    return w_plan, b_plan


def flat_schema(spec: ModelSpec) -> Dict[str, Tuple[str, List]]:
    """reference state-dict key -> (our param group, split plan).

    The split plan is ``[(param_name, shape), ...]``; a flat stored vector
    is consumed left-to-right (a single entry consumes the whole tensor,
    reshaped)."""
    schema: Dict[str, Tuple[str, List]] = {}

    def put(sd_key: str, group: str, plan: List[Tuple[str, tuple]]):
        schema[sd_key] = (group, plan)

    def linear(ref_name: str, group: str, ls: LinearSpec):
        w_plan, b_plan = _linear_entries(ls)
        put(f'{ref_name}.linear.weight', group, w_plan)
        if b_plan:
            put(f'{ref_name}.linear.bias', group, b_plan)

    put('edge_embedding.basis_function.coeffs', 'edge_embedding',
        [('bessel_coeffs', (spec.edge.bessel_num,))])

    from ..irreps import Irreps
    from ..ops.linear import linear_spec

    embed = linear_spec(Irreps(f'{spec.num_species}x0e'),
                        spec.blocks[0].irreps_x,
                        biases=spec.use_bias_in_linear)
    linear('onehot_to_feature_x', 'onehot_to_feature_x', embed)

    for blk in spec.blocks:
        t = blk.t
        if blk.self_connection == 'nequip':
            # FullyConnectedTensorProduct: one flat weight vector
            plan = [(f'w{i}', tuple(ins.weight_shape))
                    for i, ins in enumerate(blk.sc_spec.instructions)]
            put(f'{t}_self_connection_intro.fc_tensor_product.weight',
                f'{t}_self_connection_intro', plan)
        elif blk.self_connection == 'linear':
            linear(f'{t}_self_connection_intro',
                   f'{t}_self_connection_intro', blk.sc_spec)
        linear(f'{t}_self_interaction_1', f'{t}_self_interaction_1',
               blk.si1)
        hs = blk.radial_hs
        for i in range(len(hs) - 1):
            put(f'{t}_convolution.weight_nn.layer{i}.weight',
                f'{t}_convolution',
                [(f'weight_nn_w{i}', (hs[i], hs[i + 1]))])
        put(f'{t}_convolution.denominator', f'{t}_convolution',
            [('denominator', (1,))])
        linear(f'{t}_self_interaction_2', f'{t}_self_interaction_2',
               blk.si2)
        if getattr(blk, 'si3', None) is not None:
            linear(f'{t}_self_interaction_3', f'{t}_self_interaction_3',
                   blk.si3)

    if spec.readout.as_fcn:
        hs = spec.readout.fcn_hs
        for i in range(len(hs) - 1):
            put(f'readout_FCN.fcn.layer{i}.weight', 'readout_FCN',
                [(f'w{i}', (hs[i], hs[i + 1]))])
    else:
        linear('reduce_input_to_hidden', 'reduce_input_to_hidden',
               spec.readout.lin1)
        linear('reduce_hidden_to_energy', 'reduce_hidden_to_energy',
               spec.readout.lin2)

    n_sc = len(spec.shift)
    put('rescale_atomic_energy.shift', 'rescale_atomic_energy',
        [('shift', (n_sc,))])
    put('rescale_atomic_energy.scale', 'rescale_atomic_energy',
        [('scale', (n_sc,))])
    return schema


def params_from_state_dict(
    spec: ModelSpec,
    state_dict: Dict[str, np.ndarray],
    strict: bool = True,
):
    """Reference named tensors -> our params pytree.

    ``strict`` raises when the state dict holds model keys the schema
    does not cover, or when schema entries stay unfilled."""
    schema = flat_schema(spec)
    params: Dict[str, Dict[str, np.ndarray]] = {}
    unknown: List[str] = []
    filled = set()
    for sd_key, tensor in state_dict.items():
        if sd_key.endswith(_IGNORED_SUFFIXES):
            continue
        if sd_key not in schema:
            unknown.append(sd_key)
            continue
        group, plan = schema[sd_key]
        arr = np.asarray(tensor, dtype=np.float32)
        want = sum(int(np.prod(s)) for _, s in plan)
        if arr.size != want:
            raise ValueError(
                f'{sd_key}: stored size {arr.size} != expected {want} '
                f'(architecture config mismatch)'
            )
        if len(plan) == 1:
            pname, shape = plan[0]
            params.setdefault(group, {})[pname] = arr.reshape(shape)
        else:
            flat = arr.reshape(-1)
            off = 0
            for pname, shape in plan:
                n = int(np.prod(shape))
                params.setdefault(group, {})[pname] = \
                    flat[off:off + n].reshape(shape)
                off += n
        filled.add(sd_key)
    if strict:
        missing = sorted(set(schema) - filled)
        # e3nn keeps non-trainable denominators/bessel as buffers, which
        # ARE in a state_dict but absent from named-parameter dumps like
        # opt_params_sevenn.pt; default those from the spec instead
        hard_missing = []
        for sd_key in missing:
            group, plan = schema[sd_key]
            if sd_key.endswith('.denominator'):
                blk = spec.blocks[int(group.split('_')[0])]
                params.setdefault(group, {})['denominator'] = np.asarray(
                    [blk.denominator], np.float32
                )
            elif sd_key.endswith('basis_function.coeffs'):
                import math

                n = spec.edge.bessel_num
                params.setdefault(group, {})['bessel_coeffs'] = np.asarray(
                    [math.pi * (i + 1) for i in range(n)], np.float32
                )
            elif sd_key.endswith(('rescale_atomic_energy.shift',
                                  'rescale_atomic_energy.scale')):
                pname = sd_key.rsplit('.', 1)[1]
                src = spec.shift if pname == 'shift' else spec.scale
                params.setdefault(group, {})[pname] = np.asarray(
                    src, np.float32
                )
            else:
                hard_missing.append(sd_key)
        if unknown or hard_missing:
            raise RuntimeError(
                f'state-dict import mismatch: unmatched stored keys '
                f'{unknown[:8]}, unfilled schema keys {hard_missing[:8]}'
            )
    return params


def state_dict_from_params(spec: ModelSpec, params) -> Dict[str, np.ndarray]:
    """Inverse of :func:`params_from_state_dict` -- our params pytree to
    reference-layout named tensors (flat e3nn weight vectors)."""
    schema = flat_schema(spec)
    out: Dict[str, np.ndarray] = {}
    for sd_key, (group, plan) in schema.items():
        parts = [
            np.asarray(params[group][pname], np.float32).reshape(-1)
            for pname, _ in plan
        ]
        arr = np.concatenate(parts) if len(parts) > 1 else parts[0]
        if len(plan) == 1:
            arr = arr.reshape(plan[0][1])
        out[sd_key] = arr
    return out


def _known_overrides(path: str, config_overrides: Optional[Dict]) -> Dict:
    """Architecture overrides for frozen artifacts: caller-supplied, else
    guessed from the archive's metadata against the known releases
    (reference: sevenn/_const.py:53-55 pretrained paths)."""
    if config_overrides:
        return dict(config_overrides)
    import torch

    extra = {'num_species': ''}
    torch.jit.load(path, map_location='cpu', _extra_files=extra)
    ns = extra['num_species']
    ns = int(ns.decode() if isinstance(ns, bytes) else ns)
    from .known_models import EXAMPLE_MD_MODEL, SEVENNET_0_11JULY2024

    if ns == 89:
        return dict(SEVENNET_0_11JULY2024)
    return dict(EXAMPLE_MD_MODEL)


def _looks_like_state_dict(obj) -> bool:
    return isinstance(obj, dict) and obj and all(
        hasattr(v, 'shape') for v in obj.values()
    )


def reference_config_to_config(ref_config: Dict) -> Dict:
    """Sanitize a reference checkpoint's stored config for our builder.

    The key strings match ours by design (keys.py mirrors
    reference sevenn/_keys.py); values needing care are normalized."""
    config = dict(ref_config)
    im = config.get(K.IRREPS_MANUAL)
    if im:
        config[K.IRREPS_MANUAL] = [str(s) for s in im]
    tm = config.get(K.TYPE_MAP)
    if tm:
        from ..data.elements import symbol_to_z

        config[K.TYPE_MAP] = {
            (symbol_to_z(z) if isinstance(z, str) else int(z)): int(i)
            for z, i in tm.items()
        }
        config[K.NUM_SPECIES] = len(config[K.TYPE_MAP])
    return config


def import_reference_checkpoint(
    path: str,
    config_overrides: Optional[Dict] = None,
) -> Tuple[ModelSpec, Dict, Dict, int]:
    """Load a reference .pth / .pt -> (spec, params, config, epoch).

    Accepts either a full training checkpoint
    ({'model_state_dict', 'config', 'epoch', ...}, reference:
    sevenn/train/trainer.py:98-107) or a bare named-tensor dict (e.g.
    opt_params_sevenn.pt), in which case ``config_overrides`` must fully
    describe the architecture.  Torch optimizer/scheduler states are NOT
    translatable to optax and are dropped (the reference fine-tune recipe
    resets both anyway, example_inputs/fine_tuning/FT_w_reEWC).
    """
    import torch

    import warnings

    with warnings.catch_warnings():
        warnings.simplefilter('ignore')  # TorchScript-dispatch notice
        blob = torch.load(path, map_location='cpu', weights_only=False)
    if isinstance(blob, torch.jit.ScriptModule):
        # frozen deployed artifact: route through the TorchScript importer
        # (covers fine-tuning straight from the shipped SevenNet-0)
        from .torchscript_import import import_deployed_serial

        spec, params, meta, config = import_deployed_serial(
            path, _known_overrides(path, config_overrides)
        )
        resc = params['rescale_atomic_energy']
        sh = np.asarray(resc['shift']).reshape(-1)
        sc = np.asarray(resc['scale']).reshape(-1)
        config[K.SHIFT] = sh.tolist() if sh.size > 1 else float(sh[0])
        config[K.SCALE] = sc.tolist() if sc.size > 1 else float(sc[0])
        config[K.CONV_DENOMINATOR] = [
            float(np.asarray(
                params[f'{b.t}_convolution']['denominator']).reshape(-1)[0])
            for b in spec.blocks
        ]
        return spec, params, config, 0
    epoch = 0
    if _looks_like_state_dict(blob):
        if not config_overrides:
            raise ValueError(
                f'{path} is a bare state dict; pass the architecture '
                f'config via config_overrides'
            )
        sd = blob
        config = dict(config_overrides)
    elif isinstance(blob, dict) and 'model_state_dict' in blob:
        sd = blob['model_state_dict']
        config = reference_config_to_config(blob.get('config', {}))
        if config_overrides:
            config.update(config_overrides)
        epoch = int(blob.get('epoch') or 0)
    else:
        raise ValueError(f'unrecognized torch checkpoint layout: {path}')

    sd = {k: v.detach().numpy() if hasattr(v, 'detach') else np.asarray(v)
          for k, v in sd.items()}

    # statistics live in the state dict; surface the concrete values in
    # the config so spec rebuild and continue-handling see them
    # (reference: sevenn/scripts/processing_continue.py:92-108)
    if 'rescale_atomic_energy.shift' in sd:
        s = np.asarray(sd['rescale_atomic_energy.shift']).reshape(-1)
        config[K.SHIFT] = s.tolist() if s.size > 1 else float(s[0])
    if 'rescale_atomic_energy.scale' in sd:
        s = np.asarray(sd['rescale_atomic_energy.scale']).reshape(-1)
        config[K.SCALE] = s.tolist() if s.size > 1 else float(s[0])
    denoms = []
    t = 0
    while f'{t}_convolution.denominator' in sd:
        denoms.append(float(np.asarray(
            sd[f'{t}_convolution.denominator']).reshape(-1)[0]))
        t += 1
    if denoms:
        config[K.CONV_DENOMINATOR] = denoms
        config.setdefault(K.NUM_CONVOLUTION, len(denoms))

    spec = build_model_spec(config)
    params = params_from_state_dict(spec, sd, strict=True)
    return spec, params, config, epoch
