"""String key registry for data fields and configuration.

Mirrors the role of the reference's key registry (reference:
sevenn/_keys.py:26-233) so that configs and data dictionaries use one
canonical vocabulary across the framework.  Data-field keys intentionally
match the reference spelling so YAML configs written for the reference
parse unchanged.
"""

from typing import Final

# -------------------------------------------------------------------------
# data fields (graph batch)
# -------------------------------------------------------------------------
ATOMIC_NUMBERS: Final[str] = 'atomic_numbers'      # (N,)
POS: Final[str] = 'pos'                            # (N, 3)
CELL: Final[str] = 'cell_lattice_vectors'          # (B, 3, 3)
CELL_SHIFT: Final[str] = 'pbc_shift'               # (E, 3)
CELL_VOLUME: Final[str] = 'cell_volume'            # (B,)

EDGE_VEC: Final[str] = 'edge_vec'                  # (E, 3)
EDGE_LENGTH: Final[str] = 'edge_length'            # (E,)
EDGE_IDX: Final[str] = 'edge_index'                # (2, E)

ATOM_TYPE: Final[str] = 'atom_type'                # (N,) one-hot index
NODE_FEATURE: Final[str] = 'x'
NODE_FEATURE_GHOST: Final[str] = 'x_ghost'
NODE_ATTR: Final[str] = 'node_attr'
EDGE_ATTR: Final[str] = 'edge_attr'                # spherical harmonics
EDGE_EMBEDDING: Final[str] = 'edge_embedding'      # radial basis x cutoff

ENERGY: Final[str] = 'total_energy'                # (B,)
FORCE: Final[str] = 'force_of_atoms'               # (N, 3)
STRESS: Final[str] = 'stress'                      # (B, 6) eV/A^3

SCALED_ATOMIC_ENERGY: Final[str] = 'scaled_atomic_energy'
ATOMIC_ENERGY: Final[str] = 'atomic_energy'
PRED_TOTAL_ENERGY: Final[str] = 'inferred_total_energy'
PER_ATOM_ENERGY: Final[str] = 'per_atom_energy'
PRED_FORCE: Final[str] = 'inferred_force'
PRED_STRESS: Final[str] = 'inferred_stress'

NUM_ATOMS: Final[str] = 'num_atoms'                # (B,)
NLOCAL: Final[str] = 'nlocal'
USER_LABEL: Final[str] = 'user_label'
DATA_WEIGHT: Final[str] = 'data_weight'
BATCH: Final[str] = 'batch'                        # (N,) graph index
NODE_MASK: Final[str] = 'node_mask'                # (N,) 1=real 0=padding
EDGE_MASK: Final[str] = 'edge_mask'                # (E,)
# permutation sorting batch edges by SOURCE index (edge_idx[1][perm]
# ascending): lets AD-transpose scatters (cotangents accumulated by src)
# ride the sorted-segment-sum kernel.  TPU-native addition, no reference
# counterpart.
EDGE_SRC_PERM: Final[str] = '_edge_src_perm'       # (E,)

SHIFT: Final[str] = 'shift'
SCALE: Final[str] = 'scale'

SELF_CONNECTION_TEMP: Final[str] = 'self_cont_tmp'
INFO: Final[str] = 'data_info'
LABEL_NONE: Final[str] = 'No_label'

# -------------------------------------------------------------------------
# config: model section
# -------------------------------------------------------------------------
IRREPS_MANUAL: Final[str] = 'irreps_manual'
NODE_FEATURE_MULTIPLICITY: Final[str] = 'channel'
LMAX: Final[str] = 'lmax'
LMAX_EDGE: Final[str] = 'lmax_edge'
LMAX_NODE: Final[str] = 'lmax_node'
IS_PARITY: Final[str] = 'is_parity'
RADIAL_BASIS: Final[str] = 'radial_basis'
RADIAL_BASIS_NAME: Final[str] = 'radial_basis_name'
BESSEL_BASIS_NUM: Final[str] = 'bessel_basis_num'
CUTOFF_FUNCTION: Final[str] = 'cutoff_function'
CUTOFF_FUNCTION_NAME: Final[str] = 'cutoff_function_name'
POLY_CUT_P: Final[str] = 'poly_cut_p_value'
CUTOFF_ON: Final[str] = 'cutoff_on'
ACTIVATION_RADIAL: Final[str] = 'act_radial'
CUTOFF: Final[str] = 'cutoff'
# D3 dispersion config (model section): None or
# {'functional': 'pbe', 'damping': 'bj' | 'zero', ...d3_spec kwargs}
DISPERSION: Final[str] = 'dispersion'
CONVOLUTION_WEIGHT_NN_HIDDEN_NEURONS: Final[str] = 'weight_nn_hidden_neurons'
NUM_CONVOLUTION: Final[str] = 'num_convolution_layer'
CONV_DENOMINATOR: Final[str] = 'conv_denominator'
TRAIN_DENOMINATOR: Final[str] = 'train_denominator'
TRAIN_SHIFT_SCALE: Final[str] = 'train_shift_scale'
USE_BIAS_IN_LINEAR: Final[str] = 'use_bias_in_linear'
READOUT_AS_FCN: Final[str] = 'readout_as_fcn'
READOUT_FCN_HIDDEN_NEURONS: Final[str] = 'readout_fcn_hidden_neurons'
READOUT_FCN_ACTIVATION: Final[str] = 'readout_fcn_activation'
SELF_CONNECTION_TYPE: Final[str] = 'self_connection_type'
INTERACTION_TYPE: Final[str] = 'interaction_type'
ACTIVATION_SCALAR: Final[str] = 'act_scalar'
ACTIVATION_GATE: Final[str] = 'act_gate'
CORRELATION: Final[str] = 'correlation'
# each destination keeps its nearest sources within the cutoff
MAX_NEIGHBORS: Final[str] = 'max_neighbors'
_NORMALIZE_SPH: Final[str] = '_normalize_sph'
# current reference restricts the last interaction layer to even scalars
# (reference: sevenn/model_build.py:303-352); older deployed artifacts
# keep full irreps in the last layer and let the readout select scalars
_RESTRICT_LAST_LAYER: Final[str] = '_restrict_last_layer'
CHEMICAL_SPECIES: Final[str] = 'chemical_species'
CHEMICAL_SPECIES_BY_ATOMIC_NUMBER: Final[str] = 'chemical_species_by_atomic_number'
NUM_SPECIES: Final[str] = '_number_of_species'
TYPE_MAP: Final[str] = '_type_map'
MODEL_TYPE: Final[str] = '_model_type'
USE_SPECIES_WISE_SHIFT_SCALE: Final[str] = 'use_species_wise_shift_scale'

# -------------------------------------------------------------------------
# config: train section
# -------------------------------------------------------------------------
RANDOM_SEED: Final[str] = 'random_seed'
EPOCH: Final[str] = 'epoch'
LOSS: Final[str] = 'loss'
LOSS_PARAM: Final[str] = 'loss_param'
OPTIMIZER: Final[str] = 'optimizer'
OPTIM_PARAM: Final[str] = 'optim_param'
SCHEDULER: Final[str] = 'scheduler'
SCHEDULER_PARAM: Final[str] = 'scheduler_param'
FORCE_WEIGHT: Final[str] = 'force_loss_weight'
STRESS_WEIGHT: Final[str] = 'stress_loss_weight'
IS_TRAIN_STRESS: Final[str] = 'is_train_stress'
PER_EPOCH: Final[str] = 'per_epoch'
ERROR_RECORD: Final[str] = 'error_record'
BEST_METRIC: Final[str] = 'best_metric'
DTYPE: Final[str] = 'dtype'
DEVICE: Final[str] = 'device'
IS_DDP: Final[str] = 'is_ddp'
LOCAL_RANK: Final[str] = 'local_rank'
RANK: Final[str] = 'rank'
WORLD_SIZE: Final[str] = 'world_size'
TRAIN_SHUFFLE: Final[str] = 'train_shuffle'
REMAT: Final[str] = 'remat'  # 'auto' | True | False: checkpoint blocks
# evaluate + fetch/log metrics only every K-th epoch (and the last).
# K>1 skips the validation pass and every device->host metric fetch in
# between -- the standard large-scale eval_every pattern; on tunneled
# runtimes it also avoids the fetch-degraded dispatch mode.  No
# reference counterpart (it logs every epoch).
METRICS_EVERY: Final[str] = 'metrics_every'

CONTINUE: Final[str] = 'continue'
CHECKPOINT: Final[str] = 'checkpoint'
RESET_OPTIMIZER: Final[str] = 'reset_optimizer'
RESET_SCHEDULER: Final[str] = 'reset_scheduler'
RESET_EPOCH: Final[str] = 'reset_epoch'
USE_STATISTIC_VALUES_OF_CHECKPOINT: Final[str] = (
    'use_statistic_values_of_checkpoint'
)
# reEWC fine-tuning (within continue:)
FISHER: Final[str] = 'fisher_information'
OPT_PARAMS: Final[str] = 'opt_params'
EWC_LAMBDA: Final[str] = 'ewc_lambda'
CALC_FISHER: Final[str] = 'calc_fisher'
LOSS_THR: Final[str] = 'loss_threshold'

# rehearsal (experience replay)
REHEARSAL: Final[str] = 'rehearsal'
LOAD_MEMORY: Final[str] = 'load_memory_path'
MEM_BATCH_SIZE: Final[str] = 'mem_batch_size'
MEM_RATIO: Final[str] = 'mem_ratio'

# -------------------------------------------------------------------------
# config: data section
# -------------------------------------------------------------------------
DATA_FORMAT: Final[str] = 'data_format'
DATA_FORMAT_ARGS: Final[str] = 'data_format_args'
STRUCTURE_LIST: Final[str] = 'structure_list'
LOAD_DATASET: Final[str] = 'load_dataset_path'
LOAD_VALIDSET: Final[str] = 'load_validset_path'
LOAD_DATASET_WITH_WEIGHTS: Final[str] = 'load_dataset_with_weights'
SAVE_DATASET: Final[str] = 'save_dataset_path'
SAVE_BY_LABEL: Final[str] = 'save_by_label'
SAVE_BY_TRAIN_VALID: Final[str] = 'save_by_train_valid'
RATIO: Final[str] = 'data_divide_ratio'
BATCH_SIZE: Final[str] = 'batch_size'
PREPROCESS_NUM_CORES: Final[str] = 'preprocess_num_cores'
USE_TESTSET: Final[str] = 'use_testset'
DATA_SHUFFLE: Final[str] = 'data_shuffle'
# TPU-native input-pipeline fast path: collate once, keep batches
# device-resident across epochs (no reference counterpart -- eager
# PyTorch re-collates per epoch); False restores per-epoch membership
# reshuffle at full re-collation cost
CACHE_BATCHES: Final[str] = 'cache_batches'

# saved statistics (postfixed _cp when coming from a checkpoint)
AVG_NUM_NEIGH: Final[str] = 'avg_num_neigh'
SHIFT_CP: Final[str] = 'shift_cp'
SCALE_CP: Final[str] = 'scale_cp'
CONV_DENOMINATOR_CP: Final[str] = 'conv_denominator_cp'

# plugin hooks (reference: sevenn/_keys.py:204, sevenn/train/loss.py:312)
_CUSTOM_INTERACTION_BLOCK_CALLBACK: Final[str] = (
    '_custom_interaction_block_callback'
)
STANDARDIZE_RADIAL_EMBEDDING: Final[str] = 'standardize_radial_embedding'
_RADIAL_WEIGHT_SHIFT: Final[str] = '_radial_weight_shift'
_RADIAL_WEIGHT_SCALE: Final[str] = '_radial_weight_scale'
