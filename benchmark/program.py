"""What the benchmark takes from the program
(``sevennet_finetuning_tpu_torch``) and what it hands to it: the model
built from a configuration file's dict, the weights as a dict of numpy
arrays, the CUDA sources a cell's path launches.  The program is imported
inside these functions only.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

from .reference import checkpoint as ref_checkpoint
from .reference.model import build_spec, init_weights, param_shapes

# the csrc sources of the serving, MD and training paths (cg_multi is
# built from cg_gmulti.cu)
MODEL_SOURCES = ('segment_sum', 'cg_agg', 'cg_gmulti')
TRAIN_SOURCES = MODEL_SOURCES + ('cg_gagg',)


def model_config(config_file: Dict) -> Dict:
    """The flat model configuration of a configuration file, its type
    map's keys as ints."""
    cfg = dict(config_file['model'])
    cfg['_type_map'] = {int(k): int(v) for k, v in cfg['_type_map'].items()}
    return cfg


def weights(config_file: Dict, root, seed: int, device
            ) -> Tuple[Dict, Dict[str, Dict[str, np.ndarray]]]:
    """(model configuration, weights): a checkpoint's, read by the
    benchmark's own reader, whose model keys must equal the file's; or
    random ones drawn from ``seed`` on ``device``."""
    cfg = model_config(config_file)
    path = config_file.get('weights')
    if path is None:
        return cfg, init_weights(cfg, param_shapes(build_spec(cfg)), seed,
                                 device)
    blob = ref_checkpoint.load(str(root / path))
    ck = dict(blob['config'])
    ck['_type_map'] = {int(k): int(v) for k, v in ck['_type_map'].items()}
    diff = sorted(k for k in cfg if ck.get(k) != cfg[k])
    if diff:
        raise ValueError(f'{path}: keys {diff} differ from the '
                         'configuration file')
    return cfg, blob['model_state_dict']


def build_kernels(names) -> None:
    """Compile (or find already built) the named csrc sources, in
    parallel, into the checkout's ``build/torch_kernels``."""
    from sevennet_finetuning_tpu_torch.ops import _cuda

    _cuda.build_all(list(names))


def calculator(cfg: Dict, params, device):
    from sevennet_finetuning_tpu_torch.calculator import Calculator
    from sevennet_finetuning_tpu_torch.model.build import build_model_spec

    return Calculator(build_model_spec(cfg), params, device=device)
