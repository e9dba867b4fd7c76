"""Model assembly from a flat config dict.

Port of ``sevennet_finetuning_tpu/model/build.py`` for
``interaction_type: nequip``: per-layer output irreps are inferred from
the tensor product of node and filter irreps, capped at lmax, full parity
in hidden layers, scalars only ('even', l=0) at the last layer; an
``irreps_manual`` list overrides inference.
"""

from __future__ import annotations

from typing import Dict

from .. import keys as K
from ..irreps import Irreps, tp_out_irreps
from ..ops.linear import linear_spec
from .nequip import EdgeEmbedSpec, ModelSpec, ReadoutSpec, build_nequip_block


def build_model_spec(config: Dict) -> ModelSpec:
    num_species = config[K.NUM_SPECIES]
    channel = config.get(K.NODE_FEATURE_MULTIPLICITY, 32)
    lmax = config.get(K.LMAX, 1)
    lmax_edge = config.get(K.LMAX_EDGE, -1)
    lmax_node = config.get(K.LMAX_NODE, -1)
    lmax_edge = lmax_edge if lmax_edge > 0 else lmax
    lmax_node = lmax_node if lmax_node > 0 else lmax
    is_parity = config.get(K.IS_PARITY, True)
    parity = -1 if is_parity else 1
    num_layers = config.get(K.NUM_CONVOLUTION, 3)
    cutoff = float(config.get(K.CUTOFF, 4.5))
    biases = config.get(K.USE_BIAS_IN_LINEAR, False)
    interaction = config.get(K.INTERACTION_TYPE, 'nequip')
    if interaction != 'nequip':
        raise NotImplementedError(
            f'interaction type {interaction!r} is not ported yet')

    rb = config.get(K.RADIAL_BASIS, {K.RADIAL_BASIS_NAME: 'bessel'})
    assert rb.get(K.RADIAL_BASIS_NAME, 'bessel') == 'bessel'
    bessel_num = rb.get(K.BESSEL_BASIS_NUM, 8)
    cf = config.get(K.CUTOFF_FUNCTION, {K.CUTOFF_FUNCTION_NAME: 'poly_cut'})
    cf_name = cf.get(K.CUTOFF_FUNCTION_NAME, 'poly_cut')

    edge = EdgeEmbedSpec(
        cutoff=cutoff,
        bessel_num=bessel_num,
        cutoff_function=cf_name,
        poly_cut_p=cf.get(K.POLY_CUT_P, 6),
        cutoff_on=cf.get(K.CUTOFF_ON, None),
        lmax_edge=lmax_edge,
        parity=parity,
        normalize_sph=config.get(K._NORMALIZE_SPH, True),
        weight_shift=float(config.get(K._RADIAL_WEIGHT_SHIFT, 0.0)),
        weight_scale=float(config.get(K._RADIAL_WEIGHT_SCALE, 1.0)),
    )
    irreps_filter = Irreps.spherical_harmonics(lmax_edge, parity)

    irreps_manual = config.get(K.IRREPS_MANUAL, False)
    if irreps_manual:
        irreps_manual = [Irreps(s) for s in irreps_manual]
        assert len(irreps_manual) == num_layers + 1, (
            'irreps_manual must have num_convolution_layer + 1 entries'
        )

    act_scalar = config.get(K.ACTIVATION_SCALAR, {'e': 'silu', 'o': 'tanh'})
    act_gate = config.get(K.ACTIVATION_GATE, {'e': 'silu', 'o': 'tanh'})
    act_radial = config.get(K.ACTIVATION_RADIAL, 'silu')
    radial_hidden = tuple(
        config.get(K.CONVOLUTION_WEIGHT_NN_HIDDEN_NEURONS, [64, 64])
    )
    self_connection = config.get(K.SELF_CONNECTION_TYPE, 'nequip')

    irreps_x = (
        Irreps(f'{channel}x0e') if not irreps_manual else irreps_manual[0]
    )
    restrict_last = config.get(K._RESTRICT_LAST_LAYER, True)
    blocks = []
    cur_lmax_node = lmax_node
    for t in range(num_layers):
        parity_mode = 'full'
        if t == num_layers - 1 and restrict_last:
            cur_lmax_node = 0
            parity_mode = 'even'
        irreps_out_tp = tp_out_irreps(
            irreps_x, irreps_filter, cur_lmax_node, parity_mode
        )
        irreps_out = (
            tp_out_irreps(
                irreps_x, irreps_filter, cur_lmax_node, parity_mode,
                fix_multiplicity=channel,
            )
            if not irreps_manual
            else irreps_manual[t + 1]
        )
        blocks.append(
            build_nequip_block(
                t=t,
                irreps_x=irreps_x,
                irreps_filter=irreps_filter,
                irreps_out_tp=irreps_out_tp,
                irreps_out=irreps_out,
                num_species=num_species,
                radial_hidden=radial_hidden,
                bessel_num=bessel_num,
                act_radial=act_radial,
                act_scalar=act_scalar,
                act_gate=act_gate,
                self_connection=self_connection,
                biases=biases,
            )
        )
        irreps_x = blocks[-1].irreps_out

    if config.get(K.READOUT_AS_FCN, False):
        hidden = tuple(config.get(K.READOUT_FCN_HIDDEN_NEURONS, [30, 30]))
        readout = ReadoutSpec(
            as_fcn=True,
            fcn_hs=(irreps_x.dim,) + hidden + (1,),
            fcn_act=config.get(K.READOUT_FCN_ACTIVATION, 'relu'),
        )
    else:
        mid = channel if not irreps_manual else irreps_manual[-1].num_irreps
        hidden_irreps = Irreps(f'{mid // 2}x0e')
        readout = ReadoutSpec(
            as_fcn=False,
            lin1=linear_spec(irreps_x, hidden_irreps, biases=biases),
            lin2=linear_spec(hidden_irreps, Irreps('1x0e'), biases=biases),
        )

    shift = config.get(K.SHIFT, 0.0)
    scale = config.get(K.SCALE, 1.0)
    shift = tuple(shift) if isinstance(shift, (list, tuple)) else (float(shift),)
    scale = tuple(scale) if isinstance(scale, (list, tuple)) else (float(scale),)

    type_map = config[K.TYPE_MAP]
    return ModelSpec(
        num_species=num_species,
        type_map=tuple(sorted(type_map.items())),
        edge=edge,
        blocks=tuple(blocks),
        readout=readout,
        shift=shift,
        scale=scale,
        use_bias_in_linear=biases,
    )
