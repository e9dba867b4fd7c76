"""ctypes binding for the native (C++) neighbor-list core.

Port of ``sevennet_finetuning_tpu/data/native.py``.  The package's own
copy of the core, ``native/neighborlist.cpp``, is compiled on first use
(``g++ -O3 -march=native -shared -fPIC``, the JAX package's flags) into
``build/native/`` at the repository root, under a name that carries a
hash of the source, and loaded with ctypes.  Without a toolchain the
caller falls back to the cKDTree path of ``data/neighborlist.py``.  The
native path is the hot host-side loop of MD and dataset preprocessing.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import warnings
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

SOURCE = Path(__file__).resolve().parents[1] / 'native' / 'neighborlist.cpp'
BUILD_DIR = Path(__file__).resolve().parents[2] / 'build' / 'native'
CXX_FLAGS = ('-O3', '-march=native', '-shared', '-fPIC')

_LIB = None
_TRIED = False


def _build() -> Path:
    """The library of the current source, compiled if it is missing; the
    compiler writes a temporary file that is renamed into place, so
    processes building at once do not read a half-written library."""
    digest = hashlib.sha256(SOURCE.read_bytes()
                            + ' '.join(CXX_FLAGS).encode()).hexdigest()[:16]
    so_path = BUILD_DIR / f'libsevennl_{digest}.so'
    if not so_path.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = BUILD_DIR / f'.{so_path.name}.{os.getpid()}'
        subprocess.run(['g++', *CXX_FLAGS, str(SOURCE), '-o', str(tmp)],
                       check=True, capture_output=True, timeout=120)
        os.replace(tmp, so_path)
    return so_path


def _load() -> Optional[ctypes.CDLL]:
    global _LIB, _TRIED
    if _LIB is not None or _TRIED:
        return _LIB
    _TRIED = True
    try:
        lib = ctypes.CDLL(str(_build()))
    except (OSError, subprocess.SubprocessError) as e:
        warnings.warn(f'native neighbor list unavailable: {e}')
        return None
    lib.sevennl_build.restype = ctypes.c_longlong
    lib.sevennl_build.argtypes = [
        ctypes.POINTER(ctypes.c_double), ctypes.c_longlong,
        ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_int),
        ctypes.c_double, ctypes.c_longlong,
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_double),
    ]
    _LIB = lib
    return _LIB


def native_available() -> bool:
    return _load() is not None


def neighbor_list_native(
    pos: np.ndarray,
    cell: np.ndarray,
    pbc,
    cutoff: float,
) -> Optional[Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]]:
    """Same contract as data.neighborlist.neighbor_list; None if the
    native core is unavailable.  Edges come grouped by ascending i."""
    lib = _load()
    if lib is None:
        return None
    pos = np.ascontiguousarray(pos, dtype=np.float64)
    cell = np.ascontiguousarray(cell, dtype=np.float64).reshape(3, 3)
    if isinstance(pbc, bool):
        pbc = (pbc, pbc, pbc)
    pbc_arr = np.ascontiguousarray(
        [1 if p else 0 for p in pbc], dtype=np.int32
    )
    n = len(pos)
    cap = max(1024, n * 64)
    while True:
        out_i = np.empty(cap, np.int32)
        out_j = np.empty(cap, np.int32)
        out_s = np.empty((cap, 3), np.float64)
        got = lib.sevennl_build(
            pos.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), n,
            cell.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            pbc_arr.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
            float(cutoff), cap,
            out_i.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
            out_j.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
            out_s.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        )
        if got == -1:
            return None
        if got < 0:
            cap = int(-got) + 64
            continue
        m = int(got)
        vec = pos[out_j[:m]] + out_s[:m] @ cell - pos[out_i[:m]]
        return (
            out_i[:m].astype(np.int64), out_j[:m].astype(np.int64),
            out_s[:m], vec,
        )
