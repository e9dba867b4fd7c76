"""Config system: YAML -> validated flat dicts (model/train/data).

A copy of ``sevennet_finetuning_tpu/config.py``.  It mirrors the
reference's three-section YAML format and defaults tables (reference:
sevenn/_const.py:92-330, sevenn/parse_input.py:15-259) so configs
written for the reference parse unchanged: defaults are filled, per-key
conditions checked (type or predicate), unknown keys warn.
"""

from __future__ import annotations

import os
import warnings
from typing import Any, Callable, Dict, Tuple, Union

import yaml

from . import keys as K

IMPLEMENTED_RADIAL_BASIS = ['bessel']
IMPLEMENTED_CUTOFF_FUNCTION = ['poly_cut', 'XPLOR']
IMPLEMENTED_SELF_CONNECTION_TYPE = ['nequip', 'linear', 'none']
IMPLEMENTED_INTERACTION_TYPE = ['nequip', 'mace', 'gaunt', 'gaunt_gate',
                                'custom']
IMPLEMENTED_SHIFT = ['per_atom_energy_mean', 'elemwise_reference_energies']
IMPLEMENTED_SCALE = ['force_rms', 'per_atom_energy_std',
                     'elemwise_force_rms']

DEFAULT_MODEL_CONFIG: Dict[str, Any] = {
    K.IRREPS_MANUAL: False,
    K.NODE_FEATURE_MULTIPLICITY: 32,
    K.LMAX: 1,
    K.LMAX_EDGE: -1,
    K.LMAX_NODE: -1,
    K.IS_PARITY: True,
    K.RADIAL_BASIS: {K.RADIAL_BASIS_NAME: 'bessel'},
    K.CUTOFF_FUNCTION: {K.CUTOFF_FUNCTION_NAME: 'poly_cut'},
    K.ACTIVATION_RADIAL: 'silu',
    K.CUTOFF: 4.5,
    K.CONVOLUTION_WEIGHT_NN_HIDDEN_NEURONS: [64, 64],
    K.NUM_CONVOLUTION: 3,
    K.CONV_DENOMINATOR: 'avg_num_neigh',
    K.TRAIN_DENOMINATOR: False,
    K.TRAIN_SHIFT_SCALE: False,
    K.USE_BIAS_IN_LINEAR: False,
    K.READOUT_AS_FCN: False,
    K.READOUT_FCN_HIDDEN_NEURONS: [30, 30],
    K.READOUT_FCN_ACTIVATION: 'relu',
    K.SELF_CONNECTION_TYPE: 'nequip',
    K.INTERACTION_TYPE: 'nequip',
    K.CORRELATION: 3,  # mace/gaunt product-basis order
    K.ACTIVATION_SCALAR: {'e': 'silu', 'o': 'tanh'},
    K.ACTIVATION_GATE: {'e': 'silu', 'o': 'tanh'},
    K._NORMALIZE_SPH: True,
    K._RESTRICT_LAST_LAYER: True,
    K.USE_SPECIES_WISE_SHIFT_SCALE: False,
    # Grimme D3 dispersion added on top of the GNN at inference/MD time
    # (None, or {'functional': 'pbe', 'damping': 'bj'|'zero', ...}) --
    # product wiring of ops/d3.py; the reference couples its CUDA D3
    # pair style the same way (sevenn/pair_e3gnn/pair_d3.cu:2030-2056)
    K.DISPERSION: None,
}

MODEL_CONFIG_CONDITION: Dict[str, Any] = {
    K.DISPERSION: lambda v: v is None or isinstance(v, dict),
    K.NODE_FEATURE_MULTIPLICITY: int,
    K.LMAX: int,
    K.LMAX_EDGE: int,
    K.LMAX_NODE: int,
    K.IS_PARITY: bool,
    K.RADIAL_BASIS: {
        K.RADIAL_BASIS_NAME: lambda x: x in IMPLEMENTED_RADIAL_BASIS,
    },
    K.CUTOFF_FUNCTION: {
        K.CUTOFF_FUNCTION_NAME: lambda x: x in IMPLEMENTED_CUTOFF_FUNCTION,
    },
    K.CUTOFF: float,
    K.NUM_CONVOLUTION: int,
    K.CONV_DENOMINATOR: lambda x: isinstance(x, (int, float)) or x in [
        'avg_num_neigh', 'sqrt_avg_num_neigh',
    ],
    K.CONVOLUTION_WEIGHT_NN_HIDDEN_NEURONS: list,
    K.TRAIN_SHIFT_SCALE: bool,
    K.TRAIN_DENOMINATOR: bool,
    K.USE_BIAS_IN_LINEAR: bool,
    K.READOUT_AS_FCN: bool,
    K.READOUT_FCN_HIDDEN_NEURONS: list,
    K.READOUT_FCN_ACTIVATION: str,
    K.ACTIVATION_RADIAL: str,
    K.SELF_CONNECTION_TYPE: lambda x: x in IMPLEMENTED_SELF_CONNECTION_TYPE,
    K.INTERACTION_TYPE: lambda x: x in IMPLEMENTED_INTERACTION_TYPE,
    K.CORRELATION: int,
    K._NORMALIZE_SPH: bool,
}

DEFAULT_TRAINING_CONFIG: Dict[str, Any] = {
    K.RANDOM_SEED: 1,
    K.EPOCH: 300,
    K.LOSS: 'mse',
    K.OPTIMIZER: 'adam',
    K.OPTIM_PARAM: {'lr': 0.01},
    K.SCHEDULER: 'exponentiallr',
    K.SCHEDULER_PARAM: {'gamma': 0.999},
    K.FORCE_WEIGHT: 0.1,
    K.STRESS_WEIGHT: 1e-6,
    K.PER_EPOCH: 10,
    K.IS_TRAIN_STRESS: True,
    K.TRAIN_SHUFFLE: True,
    K.REMAT: 'auto',
    K.METRICS_EVERY: 1,
    K.ERROR_RECORD: [
        ['Energy', 'RMSE'],
        ['Force', 'RMSE'],
        ['Stress', 'RMSE'],
        ['TotalLoss', 'None'],
    ],
    K.BEST_METRIC: 'TotalLoss',
    K.CONTINUE: {
        K.CHECKPOINT: False,
        K.RESET_OPTIMIZER: False,
        K.RESET_SCHEDULER: False,
        K.RESET_EPOCH: False,
        K.USE_STATISTIC_VALUES_OF_CHECKPOINT: True,
        K.FISHER: False,
        K.OPT_PARAMS: False,
        K.EWC_LAMBDA: 0.0,
        # reference nests these under continue: (reference:
        # sevenn/_const.py:279-283); also accepted at train top level
        K.CALC_FISHER: False,
        K.LOSS_THR: -1.0,
    },
    K.CALC_FISHER: False,
    K.LOSS_THR: -1.0,
    K.IS_DDP: False,
}

TRAINING_CONFIG_CONDITION: Dict[str, Any] = {
    K.RANDOM_SEED: int,
    K.EPOCH: int,
    K.FORCE_WEIGHT: float,
    K.STRESS_WEIGHT: float,
    K.PER_EPOCH: int,
    K.IS_TRAIN_STRESS: bool,
    K.TRAIN_SHUFFLE: bool,
    K.REMAT: lambda x: x in ('auto', True, False),
    K.METRICS_EVERY: int,
    K.CALC_FISHER: bool,
    K.LOSS_THR: float,
    K.IS_DDP: bool,
    K.CONTINUE: {
        K.RESET_OPTIMIZER: bool,
        K.RESET_SCHEDULER: bool,
        K.RESET_EPOCH: bool,
        K.USE_STATISTIC_VALUES_OF_CHECKPOINT: bool,
    },
}

DEFAULT_DATA_CONFIG: Dict[str, Any] = {
    K.DATA_FORMAT: 'structure_list',
    K.DATA_FORMAT_ARGS: {},
    K.RATIO: 0.1,
    K.BATCH_SIZE: 6,
    K.PREPROCESS_NUM_CORES: 1,
    K.DATA_SHUFFLE: True,
    # False = reference semantics: batch MEMBERSHIP reshuffles every
    # epoch (collate re-runs per epoch).  True = opt-in fast path:
    # collate once, freeze membership, reshuffle only batch ORDER --
    # semantics differ from the reference (ADVICE r3 medium), so it must
    # be requested, not inherited by unmodified reference YAMLs.
    K.CACHE_BATCHES: False,
    K.SAVE_DATASET: False,
    K.SAVE_BY_LABEL: False,
    K.SAVE_BY_TRAIN_VALID: False,
    K.LOAD_VALIDSET: False,
    K.LOAD_MEMORY: False,
    # rehearsal lives in the data section (reference: _const.py:210-231)
    K.REHEARSAL: False,
    K.MEM_BATCH_SIZE: 1,
    K.MEM_RATIO: 1.0,
    K.SHIFT: 'per_atom_energy_mean',
    K.SCALE: 'force_rms',
    K.STANDARDIZE_RADIAL_EMBEDDING: False,
}

DATA_CONFIG_CONDITION: Dict[str, Any] = {
    K.DATA_FORMAT: str,
    K.DATA_FORMAT_ARGS: dict,
    K.RATIO: float,
    K.BATCH_SIZE: int,
    K.PREPROCESS_NUM_CORES: int,
    K.DATA_SHUFFLE: bool,
    K.CACHE_BATCHES: bool,
    K.REHEARSAL: bool,
    K.MEM_BATCH_SIZE: int,
    K.MEM_RATIO: float,
}


# deprecated key -> (replacement key or None, extra message); applied
# warn-and-rewrite before validation so old reference YAMLs keep their
# settings (reference: sevenn/parse_input.py:84-106)
_DEPRECATED_KEYS: Dict[str, Tuple[Union[str, None], str]] = {
    'avg_num_neigh': (
        K.CONV_DENOMINATOR,
        "use 'conv_denominator' (the value is carried over)",
    ),
    'train_avg_num_neigh': (
        K.TRAIN_DENOMINATOR,
        "use 'train_denominator' (the value is carried over)",
    ),
    'optimize_by_reduce': (None, 'always true; the key is ignored'),
}


def _apply_deprecations(user: Dict, section: str) -> Dict:
    out = dict(user or {})
    for old, (new, msg) in _DEPRECATED_KEYS.items():
        if old not in out:
            continue
        warnings.warn(
            f"{section} key '{old}' is deprecated: {msg}", UserWarning
        )
        val = out.pop(old)
        if new is not None and new not in out:
            out[new] = val
    return out


def _init_section(
    user: Dict, defaults: Dict, conditions: Dict, section: str
) -> Dict:
    user = _apply_deprecations(user, section)
    out = dict(defaults)
    for key, val in (user or {}).items():
        if key not in defaults and key not in conditions:
            # passthrough for known global keys; warn on typos
            if not key.startswith('_') and key not in vars(K).values():
                warnings.warn(f'unknown {section} key ignored: {key}')
                continue
        if isinstance(val, dict) and isinstance(out.get(key), dict):
            merged = dict(out[key])
            merged.update(val)
            out[key] = merged
        else:
            out[key] = val

    # coerce float-typed keys first: YAML 1.1 parses '1e-06' as a string
    for key, cond in conditions.items():
        if cond is float and key in out and isinstance(out[key], (int, str)):
            try:
                out[key] = float(out[key])
            except (TypeError, ValueError):
                pass

    for key, cond in conditions.items():
        if key not in out:
            continue
        val = out[key]
        if isinstance(cond, dict):
            for sub, subcond in cond.items():
                if isinstance(val, dict) and sub in val:
                    _check(section, f'{key}.{sub}', val[sub], subcond)
        else:
            _check(section, key, val, cond)
    return out


def _check(section: str, key: str, val, cond: Union[type, Callable]):
    if isinstance(cond, type):
        if cond is float and isinstance(val, int):
            return
        if not isinstance(val, cond):
            raise ValueError(
                f'{section}.{key}: expected {cond.__name__}, '
                f'got {type(val).__name__} ({val!r})'
            )
    elif callable(cond):
        if not cond(val):
            raise ValueError(f'{section}.{key}: invalid value {val!r}')


def read_config_yaml(path: str) -> Tuple[Dict, Dict, Dict]:
    """YAML file -> (model, train, data) validated config dicts."""
    with open(path) as f:
        raw = yaml.safe_load(f)
    for section in ('model', 'train', 'data'):
        if section not in raw:
            raise ValueError(f'config missing section: {section}')
    model = _init_section(raw['model'], DEFAULT_MODEL_CONFIG,
                          MODEL_CONFIG_CONDITION, 'model')
    train = _init_section(raw['train'], DEFAULT_TRAINING_CONFIG,
                          TRAINING_CONFIG_CONDITION, 'train')
    data = _init_section(raw['data'], DEFAULT_DATA_CONFIG,
                         DATA_CONFIG_CONDITION, 'data')
    # dataset paths may be a single string or a list
    for k in (K.LOAD_DATASET, K.LOAD_VALIDSET, K.LOAD_MEMORY):
        if isinstance(data.get(k), str):
            data[k] = [data[k]]
    return model, train, data


def global_config(model: Dict, train: Dict, data: Dict) -> Dict:
    """Merge sections into one flat dict (reference:
    sevenn/main/sevenn.py:84-87)."""
    out: Dict[str, Any] = {}
    out.update(data)
    out.update(train)
    out.update(model)
    return out
