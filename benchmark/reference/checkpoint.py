"""The reference's own reader of the pickled checkpoints and EWC files.

A checkpoint is a pickle of numpy arrays and builtins; one written by the
JAX package also holds optax NamedTuples in its optimizer state.  This
unpickler resolves the numpy globals an array needs and turns any other
class into an inert tuple, so neither jax nor optax is imported.
"""

from __future__ import annotations

import importlib
import pickle

_NUMPY_NAMES = ('dtype', 'ndarray', '_reconstruct', 'scalar', '_frombuffer')


class _Inert(tuple):
    def __new__(cls, *fields):
        return super().__new__(cls, fields)

    def __setstate__(self, state):
        pass


class _Unpickler(pickle.Unpickler):
    def find_class(self, module, name):
        root = module.split('.')[0]
        if root == 'numpy' and name in _NUMPY_NAMES:
            try:
                return getattr(importlib.import_module(module), name)
            except ImportError:
                alt = (module.replace('numpy._core', 'numpy.core')
                       if '_core' in module
                       else module.replace('numpy.core', 'numpy._core'))
                return getattr(importlib.import_module(alt), name)
        if root in ('optax', 'jax', 'jaxlib', 'chex'):
            return type(name, (_Inert,), {})
        raise pickle.UnpicklingError(f'{module}.{name} is not resolved')


def load(path: str):
    """The pickled object at ``path`` (a checkpoint dict, or the nested
    dict of numpy arrays of a Fisher / anchor file)."""
    with open(path, 'rb') as f:
        return _Unpickler(f).load()
