"""Checkpoint loading (pickle checkpoints written by the JAX package).

Port of ``load_checkpoint`` / ``model_from_checkpoint`` of
``sevennet_finetuning_tpu/train/checkpoint.py``, pickle branch only.

A checkpoint's ``optimizer_state_dict`` holds optax classes
(``optax.schedules._inject.InjectStatefulHyperparamsState``,
``ScaleByAdamState``, ...): a plain ``pickle.load`` would import jax and
optax.  ``_Unpickler`` resolves only the numpy globals an array needs and
maps every jax/optax global to an inert stub, so serving needs neither.  The
optimizer state is then dropped; the training slice reads it again.
"""

from __future__ import annotations

import importlib
import pickle

_STUB_ROOTS = ('optax', 'jax', 'jaxlib', 'chex')
# the numpy globals a pickled array needs; nothing else is resolved
_NUMPY_NAMES = ('dtype', 'ndarray', '_reconstruct', 'scalar')


class _Stub:
    """Inert stand-in for a jax/optax class in a pickled optimizer state."""

    def __init__(self, *args, **kwargs):
        pass

    def __setstate__(self, state):
        pass


class _Unpickler(pickle.Unpickler):
    def find_class(self, module, name):
        root = module.split('.')[0]
        if root in _STUB_ROOTS:
            return type(name, (_Stub,), {})
        if root == 'numpy' and name in _NUMPY_NAMES:
            try:
                mod = importlib.import_module(module)
            except ImportError:
                # pickles written under numpy 2 name numpy._core, which
                # numpy 1 spells numpy.core
                mod = importlib.import_module(
                    module.replace('numpy._core', 'numpy.core'))
            return getattr(mod, name)
        raise pickle.UnpicklingError(
            f'checkpoint references {module}.{name}, which is not loaded')


def load_checkpoint(path: str) -> dict:
    """Load a pickle checkpoint of the JAX package, optimizer state
    dropped."""
    with open(path, 'rb') as f:
        if f.read(2) == b'PK':
            raise NotImplementedError(
                f'{path}: zip checkpoints (deploy npz, reference torch '
                '.pth) are not ported yet')
        f.seek(0)
        blob = _Unpickler(f).load()
    blob['optimizer_state_dict'] = None
    return blob


def model_from_checkpoint(path: str, device=None):
    """Rebuild (model, config) from a checkpoint file; the model's weights
    are the checkpoint's, on ``device`` (cuda unless asked otherwise)."""
    from .. import resolve_device
    from ..model.build import build_model_spec
    from ..model.nequip import NequIP, load_jax_params

    device = resolve_device(device)
    blob = load_checkpoint(path)
    config = blob['config']
    model = NequIP(build_model_spec(config))
    load_jax_params(model, blob['model_state_dict'])
    return model.to(device), config
