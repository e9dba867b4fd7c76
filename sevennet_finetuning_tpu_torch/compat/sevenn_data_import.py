"""Best-effort importer for REFERENCE-format .sevenn_data artifacts.

The reference saves datasets with ``torch.save(AtomGraphDataset, path)``
(reference: sevenn/train/dataset.py:453-465) -- a pickle whose payload
references ``sevenn.*`` and ``torch_geometric.*`` classes that are not
installed here.  This module unpickles through opaque stand-in classes
(host torch only), walks the reconstructed object graph for the per-graph
field tensors (field names from reference: sevenn/_keys.py:27-81,
populated by sevenn/train/dataload.py:131-149), converts each graph back
to a Structure, and rebuilds our graphs with our own neighbor list at the
stored (or requested) cutoff.

Only unpickle artifacts you trust -- torch.load of a full object is
arbitrary-code pickle by design; stand-ins neuter the class lookups for
``sevenn``/``torch_geometric`` modules but any other callable in the
stream resolves normally.

Port of ``sevennet_finetuning_tpu/compat/sevenn_data_import.py``.  The
format sniff reads the port's own artifacts through
``data.dataset._load_blob`` (the restricted unpickler), so a pickle of the
JAX package's ``Structure`` never imports that package.
"""

from __future__ import annotations

import pickle
import types
from typing import Dict, List, Optional

import numpy as np

from ..data.elements import z_to_symbol
from ..data.vasp import Structure

# reference field-name strings (reference: sevenn/_keys.py:27-81)
_R_POS = 'pos'
_R_CELL = 'cell_lattice_vectors'
_R_ATOMIC_NUMBERS = 'atomic_numbers'
_R_NODE_FEATURE = 'x'
_R_ENERGY = 'total_energy'
_R_FORCE = 'force_of_atoms'
_R_STRESS = 'stress'
_R_USER_LABEL = 'user_label'
_R_INFO = 'data_info'

_STUB_PREFIXES = ('sevenn', 'torch_geometric')


class _Opaque:
    """Stand-in for any unavailable class in the pickle stream: accepts
    any constructor args and records whatever state pickle hands it."""

    def __init__(self, *args, **kwargs):
        self._stub_args = args
        self._stub_kwargs = kwargs

    def __setstate__(self, state):
        object.__setattr__(self, '_stub_state', state)

    def __call__(self, *args, **kwargs):  # tolerate REDUCE-as-call
        return _Opaque(*args, **kwargs)


_stub_cache: Dict[tuple, type] = {}


def _stub_for(module: str, name: str) -> type:
    key = (module, name)
    if key not in _stub_cache:
        _stub_cache[key] = type(name, (_Opaque,), {'__module__': module})
    return _stub_cache[key]


class _StubUnpickler(pickle.Unpickler):
    def find_class(self, module, name):
        if module.split('.')[0] in _STUB_PREFIXES:
            return _stub_for(module, name)
        return super().find_class(module, name)


def _load_with_stubs(path: str):
    import torch

    shim = types.SimpleNamespace(
        Unpickler=_StubUnpickler,
        load=lambda f, **kw: _StubUnpickler(f, **kw).load(),
        __name__='sevenn_data_import_shim',
    )
    return torch.load(path, map_location='cpu', pickle_module=shim,
                      weights_only=False)


def _state_of(obj) -> Dict:
    """An opaque object's attribute dict, whichever way pickle set it."""
    if isinstance(obj, dict):
        return obj
    st = getattr(obj, '_stub_state', None)
    if isinstance(st, dict):
        return st
    if isinstance(st, tuple):  # (state, slots) protocol
        merged = {}
        for part in st:
            if isinstance(part, dict):
                merged.update(part)
        return merged
    return dict(getattr(obj, '__dict__', {}) or {})


def _find_field_mapping(obj, depth=0) -> Optional[Dict]:
    """Depth-first search of an unpickled graph object for the dict that
    maps reference field names to tensors (PyG nests it as
    Data.__dict__['_store'].__dict__['_mapping']; older layouts differ).
    """
    if depth > 6:
        return None
    if isinstance(obj, dict):
        if _R_POS in obj and _R_ENERGY in obj:
            return obj
        for v in obj.values():
            hit = _find_field_mapping(v, depth + 1)
            if hit is not None:
                return hit
        return None
    if isinstance(obj, _Opaque):
        return _find_field_mapping(_state_of(obj), depth + 1)
    return None


def _to_np(v):
    import torch

    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return np.asarray(v)


def _graph_to_structure(fields: Dict, label: str) -> Structure:
    pos = _to_np(fields[_R_POS]).astype(float)
    cell = _to_np(fields[_R_CELL]).astype(float).reshape(3, 3)
    zs = fields.get(_R_ATOMIC_NUMBERS)
    if zs is None:
        zs = fields.get(_R_NODE_FEATURE)  # pre-onehot datasets store Z
    zs = _to_np(zs).astype(int).ravel()
    if zs.shape[0] != pos.shape[0]:
        raise ValueError(
            f'cannot recover atomic numbers ({zs.shape} vs {pos.shape}); '
            'the dataset was saved after one-hot conversion'
        )
    energy = float(_to_np(fields[_R_ENERGY]).ravel()[0])
    forces = _to_np(fields[_R_FORCE]).astype(float).reshape(-1, 3)
    stress = None
    if _R_STRESS in fields:
        sv = _to_np(fields[_R_STRESS]).astype(float).ravel()
        if sv.size == 6 and np.all(np.isfinite(sv)):
            stress = sv  # already the internal convention (negated
            # Voigt xx yy zz xy yz zx; reference: dataload.py:102-106)
    info = fields.get(_R_INFO)
    info = dict(info) if isinstance(info, dict) else {}
    info['label'] = str(fields.get(_R_USER_LABEL, label))
    return Structure(
        species=[z_to_symbol(int(z)) for z in zs], pos=pos, cell=cell,
        energy=energy, forces=forces, stress=stress, info=info,
    )


def reference_sevenn_data_structures(path: str) -> List[Structure]:
    """All labeled Structures stored in a reference .sevenn_data."""
    root = _load_with_stubs(path)
    state = _state_of(root)
    dataset = state.get('dataset')
    if not isinstance(dataset, dict):
        raise ValueError(
            f'{path}: does not look like a reference AtomGraphDataset '
            f'(no dataset dict; top-level keys {sorted(state)[:8]})'
        )
    out: List[Structure] = []
    for label, items in dataset.items():
        for it in items:
            fields = _find_field_mapping(it)
            if fields is None:
                raise ValueError(
                    f'{path}: could not locate field tensors in a '
                    f'graph of label {label!r}'
                )
            out.append(_graph_to_structure(fields, str(label)))
    return out


def reference_sevenn_data_cutoff(path: str) -> Optional[float]:
    try:
        cut = _state_of(_load_with_stubs(path)).get('cutoff')
        return None if cut is None else float(cut)
    except Exception:
        return None


def is_reference_sevenn_data(path: str) -> bool:
    """Sniff the on-disk format: torch.save writes a zipfile (PK..) or
    the legacy tar/magic-number stream; our artifact is a bare pickle
    (protocol marker 0x80).  A bare pickle naming a global the restricted
    unpickler does not resolve raises ``pickle.UnpicklingError``."""
    with open(path, 'rb') as f:
        head = f.read(4)
    if head[:2] == b'PK':
        return True
    # legacy torch.save: pickle stream too, but begins with the torch
    # magic-number long; ours starts with PROTO (0x80) then version byte
    # followed by a dict -- sniff deeper by trying our loader cheaply
    if head[:1] != b'\x80':
        return True
    from ..data.dataset import _load_blob

    try:
        blob = _load_blob(path)
        return not (isinstance(blob, dict) and 'version' in blob)
    except pickle.UnpicklingError:
        raise  # a plain pickle naming a class it may not load
    except Exception:
        return True
