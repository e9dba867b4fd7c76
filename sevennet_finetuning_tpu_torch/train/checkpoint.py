"""Checkpoints: pickle files in the JAX package's layout.

Port of ``save_checkpoint`` / ``load_checkpoint`` / ``model_from_checkpoint``
/ ``save_pytree`` / ``load_pytree`` of
``sevennet_finetuning_tpu/train/checkpoint.py``, pickle branch only.

A checkpoint is one pickle of numpy arrays and builtins:
``model_state_dict`` (the parameters by the JAX package's names),
``config``, ``epoch``, ``scheduler_state_dict`` and, where there is one,
``optimizer_state_dict``.  The port's own checkpoints also carry
``format: 'sevennet_finetuning_tpu_torch'``, and their optimizer state is
a ``torch.optim`` state dict with every tensor stored as a numpy array,
so the JAX package's ``load_checkpoint`` (a plain ``pickle.load``) reads
them too; ``load_checkpoint`` turns the arrays back into tensors.

A JAX checkpoint's ``optimizer_state_dict`` holds optax classes
(``optax.schedules._inject.InjectStatefulHyperparamsState``,
``ScaleByAdamState``, ...): a plain ``pickle.load`` would import jax and
optax.  ``_Unpickler`` resolves only the numpy globals an array needs and
maps every jax/optax global to an inert stub.  That optimizer state is
then dropped (the port does not read optax state, ROADMAP A.4), and
``optax_state_dropped`` says that there was one.  ``load_pytree`` reads
the Fisher / anchor-parameter pickles (``fisher_sevenn.pt``,
``opt_params_sevenn.pt``: nested dicts of numpy arrays) through the same
unpickler.
"""

from __future__ import annotations

import importlib
import pickle
from typing import Dict, Optional

import numpy as np
import torch

# the marker of a checkpoint written by this package
FORMAT = 'sevennet_finetuning_tpu_torch'

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


def _to_numpy(tree):
    """Tensors of a nested dict / list / tuple as numpy arrays."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    if isinstance(tree, dict):
        return {k: _to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_numpy(v) for v in tree)
    return tree


def _to_torch(tree):
    """The inverse of ``_to_numpy`` for an optimizer state dict."""
    if isinstance(tree, np.ndarray):
        return torch.tensor(np.array(tree))
    if isinstance(tree, dict):
        return {k: _to_torch(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_torch(v) for v in tree)
    return tree


def save_checkpoint(path: str, params, config: Dict, epoch: int = 0,
                    optimizer_state=None,
                    scheduler_state: Optional[Dict] = None):
    """``params``: group -> name -> array or tensor; ``optimizer_state``:
    a ``torch.optim`` state dict (stored as numpy)."""
    blob = {
        'model_state_dict': _to_numpy(params),
        'config': config,
        'epoch': epoch,
        'scheduler_state_dict': scheduler_state,
        'format': FORMAT,
    }
    if optimizer_state is not None:
        blob['optimizer_state_dict'] = _to_numpy(optimizer_state)
    with open(path, 'wb') as f:
        pickle.dump(blob, f)


def load_checkpoint(path: str) -> dict:
    """Load a pickle checkpoint of this package or of the JAX package.
    The port's own optimizer state comes back as a ``torch.optim`` state
    dict; a JAX checkpoint's optax state is dropped
    (``optax_state_dropped``)."""
    with open(path, 'rb') as f:
        if f.read(2) == b'PK':
            raise NotImplementedError(
                f'{path}: zip checkpoints (deploy npz, reference torch '
                '.pth) are not ported yet: ROADMAP A.6')
        f.seek(0)
        blob = _Unpickler(f).load()
    state = blob.get('optimizer_state_dict')
    if blob.get('format') == FORMAT:
        blob['optimizer_state_dict'] = (None if state is None
                                        else _to_torch(state))
    else:
        blob['optimizer_state_dict'] = None
        blob['optax_state_dropped'] = state is not None
    return blob


def save_pytree(path: str, tree):
    """Fisher / anchor-parameter artifacts (``fisher_sevenn.pt``,
    ``opt_params_sevenn.pt``): a pickled nested dict of numpy arrays."""
    with open(path, 'wb') as f:
        pickle.dump(_to_numpy(tree), f)


def load_pytree(path: str):
    """A pickled pytree of numpy arrays (Fisher / anchor parameters)."""
    with open(path, 'rb') as f:
        return _Unpickler(f).load()


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
