"""Config overrides for importing known reference release artifacts, and
pretrained-model names (``continue: checkpoint: 'SevenNet-0'``).

Port of ``sevennet_finetuning_tpu/compat/known_models.py``.  Frozen
TorchScript graphs do not retain every architecture hyperparameter; these
tables pin down the shipped SevenNet releases (sources: reference
pretrained_potentials/SevenNet_0__11July2024/pre_train.yaml and the
example_inputs deployed models, decoded from their frozen graphs).  The
port searches ``$SEVENN_PRETRAINED_DIR`` only for release artifacts: a
reference torch ``.pth`` or a frozen TorchScript, both of which
``load_checkpoint`` reads.
"""

from __future__ import annotations

import os

from .. import keys as K

SEVENNET_0_11JULY2024 = {
    K.NODE_FEATURE_MULTIPLICITY: 128,
    K.LMAX: 2,
    K.NUM_CONVOLUTION: 5,
    K.IS_PARITY: False,
    K.SELF_CONNECTION_TYPE: 'linear',
    K.IRREPS_MANUAL: [
        '128x0e', '128x0e+64x1e+32x2e', '128x0e+64x1e+32x2e',
        '128x0e+64x1e+32x2e', '128x0e+64x1e+32x2e', '128x0e',
    ],
    K._NORMALIZE_SPH: True,
    K._RESTRICT_LAST_LAYER: True,
    K.SHIFT: [0.0] * 89,           # species-wise; values imported
    K.SCALE: [1.0] * 89,
}


def pretrained_name_to_path(name: str) -> str:
    """Resolve a pretrained-model name to a loadable artifact path
    (reference: sevenn/util.py:316-329, sevenn/_const.py:53-55).
    Prefers a training checkpoint (.pth); falls back to the frozen serial
    TorchScript."""
    key = name.lower().replace('_', '-')
    if key not in ('7net-0', 'sevennet-0', '7net-0-11july2024',
                   'sevennet-0-11july2024'):
        raise ValueError(f'unknown pretrained model: {name}')
    candidates = []
    env = os.environ.get('SEVENN_PRETRAINED_DIR')
    if env:
        candidates += [
            os.path.join(env, 'checkpoint_sevennet_0.pth'),
            os.path.join(env, 'deployed_serial.pt'),
        ]
    for c in candidates:
        if os.path.exists(c):
            return c
    raise FileNotFoundError(
        f'no artifact found for {name}; set SEVENN_PRETRAINED_DIR '
        f'(searched: {candidates})'
    )


# the model deployed with the reference's example_inputs/md_*_example
EXAMPLE_MD_MODEL = {
    K.NODE_FEATURE_MULTIPLICITY: 4,
    K.LMAX: 1,
    K.NUM_CONVOLUTION: 4,
    K.IS_PARITY: True,
    K.SELF_CONNECTION_TYPE: 'nequip',
    K._NORMALIZE_SPH: False,
    K._RESTRICT_LAST_LAYER: False,
}
