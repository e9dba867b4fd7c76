"""Checkpoints: pickle files in the JAX package's layout.

Port of ``sevennet_finetuning_tpu/train/checkpoint.py``: ``save_checkpoint``
/ ``load_checkpoint`` / ``model_from_checkpoint`` / ``save_pytree`` /
``load_pytree``, and the deploy artifact (``save_deployed`` /
``load_deployed`` / ``model_from_deployed``: one npz of named float arrays
and the JSON config, the same layout in both packages, so each reads the
other's).  A reference torch ``.pth`` zip (a training checkpoint, a bare
state dict or a frozen TorchScript) goes through
``compat/state_dict_import.import_reference_checkpoint``, as in the JAX
package.

A checkpoint is one pickle of numpy arrays and builtins:
``model_state_dict`` (the parameters by the JAX package's names),
``config``, ``epoch``, ``scheduler_state_dict`` and, where there is one,
``optimizer_state_dict``.  The port's own checkpoints also carry
``format: 'sevennet_finetuning_tpu_torch'``, and their optimizer state is
a ``torch.optim`` state dict with every tensor stored as a numpy array,
so the JAX package's ``load_checkpoint`` (a plain ``pickle.load``) reads
them too; ``load_checkpoint`` turns the arrays back into tensors.

A JAX checkpoint's ``optimizer_state_dict`` holds optax NamedTuples
(``optax.schedules._inject.InjectStatefulHyperparamsState``,
``ScaleByAdamState``, ``MaskedState``, ...): a plain ``pickle.load`` would
import jax and optax.  ``_Unpickler`` resolves only the numpy globals an
array needs and turns every jax/optax/chex class into an ``OptaxState``,
a tuple that keeps the positional fields pickle rebuilds it from and the
class's name; ``train/optim.optax_state_dict`` translates that tree into
the port's optimizer state (``Trainer.load_optimizer_state``).
``load_pytree`` reads the Fisher / anchor-parameter pickles
(``fisher_sevenn.pt``, ``opt_params_sevenn.pt``: nested dicts of numpy
arrays) through the same unpickler.
"""

from __future__ import annotations

import functools
import importlib
import pickle
from typing import Dict, Optional, Tuple

import numpy as np
import torch

# the marker of a checkpoint written by this package
FORMAT = 'sevennet_finetuning_tpu_torch'

_STUB_ROOTS = ('optax', 'jax', 'jaxlib', 'chex')
# the numpy globals a pickled array needs; nothing else is resolved
_NUMPY_NAMES = ('dtype', 'ndarray', '_reconstruct', 'scalar', '_frombuffer')

# the fields read by name of the optax NamedTuples the JAX package's
# optimizers write (optax.inject_hyperparams over optax.masked chains of
# adam, adamw, sgd, adagrad or radam); MaskedState, MaskedNode and
# EmptyState are kept as their positional fields
OPTAX_FIELDS = {
    'InjectStatefulHyperparamsState': ('count', 'hyperparams',
                                       'hyperparams_states', 'inner_state'),
    'ScaleByAdamState': ('count', 'mu', 'nu'),
    'TraceState': ('trace',),
    'ScaleByRssState': ('sum_of_squares',),
}


class OptaxState(tuple):
    """A jax/optax class of a pickled optimizer state: the positional
    fields pickle rebuilds it from, readable by name (``field``) where the
    class is one of ``OPTAX_FIELDS``."""

    optax_name = ''

    def __new__(cls, *fields):
        return super().__new__(cls, fields)

    def __setstate__(self, state):
        pass

    def field(self, name: str):
        names = OPTAX_FIELDS.get(self.optax_name, ())
        if name not in names or names.index(name) >= len(self):
            raise ValueError(f'{self.optax_name} has no field {name!r}')
        return self[names.index(name)]

    def __repr__(self):
        return f'{self.optax_name}{tuple.__repr__(self)}'


@functools.lru_cache(maxsize=None)
def _optax_class(name: str) -> type:
    return type(name, (OptaxState,), {'optax_name': name})


def numpy_global(module: str, name: str):
    """A numpy global of ``_NUMPY_NAMES`` (None for any other)."""
    if module.split('.')[0] != 'numpy' or name not in _NUMPY_NAMES:
        return None
    try:
        mod = importlib.import_module(module)
    except ImportError:
        # pickles written under numpy 2 name numpy._core, which numpy 1
        # spells numpy.core (and the other way round)
        alt = (module.replace('numpy._core', 'numpy.core')
               if '_core' in module
               else module.replace('numpy.core', 'numpy._core'))
        mod = importlib.import_module(alt)
    return getattr(mod, name)


class _Unpickler(pickle.Unpickler):
    def find_class(self, module, name):
        if module.split('.')[0] in _STUB_ROOTS:
            return _optax_class(name)
        fn = numpy_global(module, name)
        if fn is not None:
            return fn
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
    """Load a checkpoint: a pickle of this package or of the JAX package,
    the npz deploy artifact, or a reference torch ``.pth`` (through
    ``compat/state_dict_import``).  The port's own optimizer state comes
    back as a ``torch.optim`` state dict, a JAX checkpoint's as its
    optax tree of ``OptaxState`` (``Trainer.load_optimizer_state`` reads
    both); a reference ``.pth``'s torch optimizer state is dropped, as in
    the JAX package."""
    with open(path, 'rb') as f:
        magic = f.read(2)
    if magic == b'PK':
        # npz (the deploy artifact) and torch archives are both zips
        import zipfile

        with zipfile.ZipFile(path) as zf:
            is_deployed = '__format__.npy' in zf.namelist()
        if is_deployed:
            params, config = load_deployed(path)
            epoch = 0
        else:
            from ..compat.state_dict_import import (
                import_reference_checkpoint)

            _, params, config, epoch = import_reference_checkpoint(path)
        return {
            'model_state_dict': params,
            'config': config,
            'epoch': epoch,
            'optimizer_state_dict': None,
            'scheduler_state_dict': None,
        }
    with open(path, 'rb') as f:
        blob = _Unpickler(f).load()
    state = blob.get('optimizer_state_dict')
    if blob.get('format') == FORMAT and state is not None:
        blob['optimizer_state_dict'] = _to_torch(state)
    return blob


def save_deployed(path: str, params, config: Dict):
    """Write a deployment artifact: a single npz of named float arrays
    plus the JSON-encoded config -- self-describing and safe to share
    (no pickle; the reference's counterpart is the frozen TorchScript
    with _extra_files metadata, reference: sevenn/scripts/deploy.py:34-51).

    Layout: '<group>/<param>' arrays + '__config__' (JSON bytes) +
    '__format__' (version tag), as the JAX package writes it."""
    import json

    flat = {}
    for group, sub in _to_numpy(params).items():
        if isinstance(sub, dict):
            for name, arr in sub.items():
                flat[f'{group}/{name}'] = np.asarray(arr)
        else:
            flat[group] = np.asarray(sub)

    def _jsonable(v):
        if isinstance(v, (np.floating, np.integer)):
            return v.item()
        if isinstance(v, np.ndarray):
            return v.tolist()
        raise TypeError(f'config value not serializable: {type(v)}')

    cfg = json.dumps(config, default=_jsonable)
    flat['__config__'] = np.frombuffer(cfg.encode(), dtype=np.uint8)
    flat['__format__'] = np.frombuffer(b'sevenn-ft-tpu-deploy-v1',
                                       dtype=np.uint8)
    with open(path, 'wb') as f:
        np.savez(f, **flat)


def load_deployed(path: str) -> Tuple[Dict, Dict]:
    """(params, config) from a deployment artifact.  Pickle-free."""
    import json

    from .. import keys as K

    with np.load(path, allow_pickle=False) as z:
        tag = bytes(z['__format__']).decode()
        if not tag.startswith('sevenn-ft-tpu-deploy'):
            raise ValueError(f'{path}: not a deployment artifact ({tag})')
        config = json.loads(bytes(z['__config__']).decode())
        params: Dict = {}
        for key in z.files:
            if key.startswith('__'):
                continue
            group, _, name = key.partition('/')
            if name:
                params.setdefault(group, {})[name] = z[key]
            else:
                params[group] = z[key]
    # JSON stringifies the int keys of the type map
    if config.get(K.TYPE_MAP):
        config[K.TYPE_MAP] = {
            int(k): int(v) for k, v in config[K.TYPE_MAP].items()
        }
    return params, config


def model_from_deployed(path: str):
    """Rebuild (spec, params, config) from a deployment artifact (the
    JAX package's return value; ``Calculator`` loads the params)."""
    from ..model.build import build_model_spec

    params, config = load_deployed(path)
    return build_model_spec(config), params, config


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
