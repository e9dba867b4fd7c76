"""Pretrained-model names (``continue: checkpoint: 'SevenNet-0'``).

Port of ``pretrained_name_to_path`` and ``EXAMPLE_MD_MODEL`` of
``sevennet_finetuning_tpu/compat/known_models.py``.  The port searches
``$SEVENN_PRETRAINED_DIR`` only: the release artifacts there are a
reference torch ``.pth`` or a frozen TorchScript, which the port's
``load_checkpoint`` does not read yet (ROADMAP A.10).
"""

from __future__ import annotations

import os

from .. import keys as K


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
