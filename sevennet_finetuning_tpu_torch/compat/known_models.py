"""Pretrained-model names (``continue: checkpoint: 'SevenNet-0'``).

Port of ``pretrained_name_to_path`` of
``sevennet_finetuning_tpu/compat/known_models.py``.  The port searches
``$SEVENN_PRETRAINED_DIR`` only: the release artifacts there are a
reference torch ``.pth`` or a frozen TorchScript, zip files that the
port's ``load_checkpoint`` does not read yet (ROADMAP A.6).
"""

from __future__ import annotations

import os


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
