"""Build, load and count the hand-written CUDA kernels of ``csrc/``.

Each source is compiled by ``nvcc`` for ``sm_90a`` into a shared library
with a plain C interface and loaded with ``ctypes`` (no PyTorch headers,
so a build takes seconds).  Libraries are named by a hash of their
source and land in ``build/torch_kernels/`` at the repository root; a
library is built on first use, or ahead of time by ``build_all``, which
starts one ``nvcc`` per source in parallel.

Every C entry point takes device pointers, sizes and the CUDA stream,
launches on that stream, and returns ``cudaGetLastError()``; ``check``
turns a non-zero return into an exception.  ``LAUNCHES`` counts the
launches of each kernel; the wrappers beside the kernels' plain versions
increment it where they launch, and nowhere else.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from collections import Counter
from pathlib import Path
from typing import Dict, Iterable

import torch

CSRC = Path(__file__).resolve().parent.parent / 'csrc'
BUILD_DIR = Path(__file__).resolve().parents[2] / 'build' / 'torch_kernels'
SOURCES = ('segment_sum', 'cg_agg', 'cg_multi')
NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17',
              '-O3', '-shared', '-Xcompiler', '-fPIC', '-Xptxas', '-v')

LAUNCHES: Counter = Counter()

_P = ctypes.c_void_p
_I = ctypes.c_int
# argument types of each C entry point (pointers and the stream as
# c_void_p: ctypes would otherwise pass them as 32-bit ints)
SIGNATURES = {
    'segment_sum': ('seg_sum_sorted_f32', (_P, _P, _P, _I, _I, _P)),
    'cg_agg': ('cg_agg_f32',
               (_P, _P, _P, _P, _P, _P, _P) + (_I,) * 6 + (_P,)),
    'cg_multi': ('cg_multi_f32',
                 (_P,) * 5 + (_P, _P, _P, _I) + (_P, _P, _I, _I)
                 + (_P, _P, _P, _I, _I, _I) + (_I,) * 7 + (_P,)),
}

_LIBS: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    found = shutil.which('nvcc')
    if found:
        return found
    path = '/usr/local/cuda/bin/nvcc'
    if os.path.exists(path):
        return path
    raise RuntimeError('nvcc not found: the CUDA kernels cannot be built')


def _lib_path(name: str) -> Path:
    src = (CSRC / f'{name}.cu').read_bytes()
    digest = hashlib.sha1(src).hexdigest()[:12]
    return BUILD_DIR / f'lib{name}-{digest}.so'


def build_all(names: Iterable[str] = SOURCES) -> None:
    """Compile the named sources in parallel (one nvcc each).  Compiler
    output (register and shared-memory use from ``-Xptxas -v``) goes to
    ``<lib>.log``."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = None
    procs = {}
    for name in names:
        out = _lib_path(name)
        if out.exists():
            continue
        nvcc = nvcc or nvcc_path()
        tmp = out.with_suffix(f'.{os.getpid()}.tmp')
        log = open(out.with_suffix('.log'), 'w')
        procs[name] = (subprocess.Popen(
            [nvcc, *NVCC_FLAGS, '-o', str(tmp), str(CSRC / f'{name}.cu')],
            stdout=log, stderr=subprocess.STDOUT), tmp, out, log)
    failed = []
    for name, (proc, tmp, out, log) in procs.items():
        rc = proc.wait()
        log.close()
        if rc != 0:
            failed.append(f'{name}: nvcc exit {rc}\n'
                          + out.with_suffix('.log').read_text())
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError('kernel build failed:\n' + '\n'.join(failed))


def build_log(name: str) -> str:
    log = _lib_path(name).with_suffix('.log')
    return log.read_text() if log.exists() else ''


def kernel(name: str):
    """The C entry point of ``csrc/<name>.cu``, built on first use."""
    if name not in _LIBS:
        path = _lib_path(name)
        if not path.exists():
            build_all([name])
        _LIBS[name] = ctypes.CDLL(str(path))
    fn_name, argtypes = SIGNATURES[name]
    fn = getattr(_LIBS[name], fn_name)
    fn.argtypes = list(argtypes)
    fn.restype = ctypes.c_int
    return fn


def check(name: str, rc: int) -> None:
    if rc != 0:
        raise RuntimeError(f'CUDA kernel {name} failed to launch: '
                           f'cudaError {rc}')


def stream_ptr(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def require(t: torch.Tensor, name: str, dtype, shape=None) -> None:
    """Wrapper-side checks: CUDA device, dtype, shape, contiguity."""
    if not t.is_cuda:
        raise ValueError(f'{name}: expected a CUDA tensor, got {t.device}')
    if t.dtype != dtype:
        raise TypeError(f'{name}: expected {dtype}, got {t.dtype}')
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f'{name}: expected shape {tuple(shape)}, '
                         f'got {tuple(t.shape)}')
    if not t.is_contiguous():
        raise ValueError(f'{name}: expected a contiguous tensor')
