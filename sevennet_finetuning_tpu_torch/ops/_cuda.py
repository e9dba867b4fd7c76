"""Build, load and count the hand-written CUDA kernels of ``csrc/``.

Each source is compiled by ``nvcc`` for ``sm_90a`` into a shared library
with a plain C interface and loaded with ``ctypes`` (no PyTorch headers,
so a build takes seconds).  Libraries are named by a hash of their
source and land in ``build/torch_kernels/`` at the repository root; a
library is built on first use, or ahead of time by ``build_all``, which
starts one ``nvcc`` per source in parallel.

Every C entry point takes device pointers, sizes and the CUDA stream,
launches on that stream, and returns ``cudaGetLastError()``; ``check``
turns a non-zero return into an exception.  A source holds one entry
point named as the source, or several (``SOURCE_OF`` names each one's
source).  ``LAUNCHES`` counts the launches of each entry point
(``KERNELS``); the wrappers beside the kernels' plain versions increment
it where they launch, and nowhere else.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from collections import Counter
from pathlib import Path
from typing import Dict, Iterable, Tuple

import torch

CSRC = Path(__file__).resolve().parent.parent / 'csrc'
BUILD_DIR = Path(__file__).resolve().parents[2] / 'build' / 'torch_kernels'
SOURCES = ('segment_sum', 'cg_agg', 'cg_gagg', 'cg_gmulti', 'cg_quad',
           'neighbor_cells', 'so2', 'probe_copy', 'probe_feats')
NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17',
              '-O3', '-shared', '-Xcompiler', '-fPIC', '-Xptxas', '-v')

LAUNCHES: Counter = Counter()

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# argument types of each C entry point (pointers and the stream as
# c_void_p: ctypes would otherwise pass them as 32-bit ints)
SIGNATURES = {
    'segment_sum': ('seg_sum_sorted_f32', (_P, _P, _P) + (_I,) * 4 + (_P,)),
    # the plan's meta, the launch config and the shared-memory layout are
    # host arrays
    'cg_agg': ('cg_agg_f32', (_P,) * 10 + (_I,) * 6 + (_P,)),
    # pool pointers, terms, output pointers and the plan's meta are host
    # arrays
    'cg_gagg': ('cg_gagg_f32',
                (_P, _I, _P, _I, _P, _P, _P, _P) + (_I,) * 5 + (_P,)),
    'cg_gmulti': ('cg_gmulti_f32',
                  (_P, _P, _I, _P, _I) + (_P,) * 4 + (_I,) * 8 + (_P,)),
    # the first-order backward: cg_gmulti.cu's kernel built for one slot
    'cg_multi': ('cg_multi_f32',
                 (_P, _P, _I, _P, _I) + (_P,) * 4 + (_I,) * 8 + (_P,)),
    # the mode, the legs, the plan; its meta, the launch config and the
    # shared-memory layout are host arrays
    'cg_quad': ('cg_quad_f32', (_I,) + (_P,) * 8 + (_I,) * 5 + (_P,)),
    # MD's neighbor rebuild (ops/neighbor.py): the work buffers' device
    # pointers, the geometry and the sizes are host arrays
    'neighbor_count': ('neighbor_count_f32', (_P,) * 5),
    'neighbor_fill': ('neighbor_fill_f32', (_P,) * 5 + (_I, _P)),
    # the 'equiformer_v2' family's edge frame (ops/so2.py): strides and
    # sizes as ints, D's row spans a host array, two legs' pointers
    'so2_rotate': ('so2_rotate_f32',
                   (_P, _I, _P, _I, _I) + (_P,) * 4 + (_I, _I, _P, _P)
                   + (_I,) * 6 + (_P,)),
    'so2_rotate_grad': ('so2_rotate_grad_f32',
                        (_P, _I, _I) + (_P,) * 4 + (_I, _I) + (_P,) * 4
                        + (_I, _I, _P) + (_I,) * 5 + (_P,)),
    's2_act': ('s2_act_f32', (_P,) * 4 + (_I,) * 4 + (_P,)),
    's2_act_bwd': ('s2_act_bwd_f32', (_P,) * 5 + (_I,) * 4 + (_P,)),
    # the measurement probes of tools/ (csrc/probe_copy.cu,
    # csrc/probe_feats.cu)
    'probe_copy_tiled': ('probe_copy_tiled_f32',
                         (_P, _P, _I, _I, _I, _I, _F, _P)),
    'probe_colsum': ('probe_colsum_f32', (_P, _P, _P, _I, _I, _I, _I, _P)),
    'probe_copy_ring': ('probe_copy_ring_f32',
                        (_P, _P, _I, _I, _I, _I, _I, _F, _P)),
    'probe_transpose': ('probe_transpose_f32', (_P, _P, _I, _I, _P)),
    'probe_split': ('probe_split_f32', (_P, _P, _P, _I, _P)),
    'probe_dot': ('probe_dot_bf16x3_f32', (_P, _P, _P, _I, _I, _I, _P)),
    'probe_window': ('probe_window_f32', (_P, _P, _P) + (_I,) * 4 + (_P,)),
}
# the source of each entry point: its own name, but for those that share
# a source
SHARED_SOURCES = {
    'cg_gmulti': ('cg_multi',),
    'neighbor_cells': ('neighbor_count', 'neighbor_fill'),
    'so2': ('so2_rotate', 'so2_rotate_grad', 's2_act', 's2_act_bwd'),
    'probe_copy': ('probe_copy_tiled', 'probe_colsum', 'probe_copy_ring'),
    'probe_feats': ('probe_transpose', 'probe_split', 'probe_dot',
                    'probe_window')}
SOURCE_OF = {name: name for name in SIGNATURES}
SOURCE_OF.update({name: src for src, names in SHARED_SOURCES.items()
                  for name in names})
KERNELS = tuple(SIGNATURES)


def host_ptrs(tensors) -> ctypes.Array:
    """A host array of the tensors' device pointers (the kernels copy
    it into a by-value launch argument)."""
    return (ctypes.c_void_p * len(tensors))(*(t.data_ptr() for t in tensors))


def host_ints(values) -> ctypes.Array:
    return (ctypes.c_int * len(values))(*values)

_LIBS: Dict[str, ctypes.CDLL] = {}
_FNS: Dict[str, ctypes._CFuncPtr] = {}


def nvcc_path() -> str:
    found = shutil.which('nvcc')
    if found:
        return found
    path = '/usr/local/cuda/bin/nvcc'
    if os.path.exists(path):
        return path
    raise RuntimeError('nvcc not found: the CUDA kernels cannot be built')


def _lib_path(name: str, defines: Tuple[str, ...] = ()) -> Path:
    src = (CSRC / f'{name}.cu').read_bytes() + ' '.join(defines).encode()
    digest = hashlib.sha1(src).hexdigest()[:12]
    return BUILD_DIR / f'lib{name}-{digest}.so'


def build_all(names: Iterable[str] = SOURCES,
              defines: Tuple[str, ...] = ()) -> None:
    """Compile the named sources in parallel (one nvcc each), with
    ``-D`` ``defines`` if given (a measurement build, a library of its
    own).  Compiler output (register and shared-memory use from
    ``-Xptxas -v``) goes to ``<lib>.log``."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = None
    procs = {}
    for name in names:
        out = _lib_path(name, defines)
        if out.exists():
            continue
        nvcc = nvcc or nvcc_path()
        tmp = out.with_suffix(f'.{os.getpid()}.tmp')
        log = open(out.with_suffix('.log'), 'w')
        procs[name] = (subprocess.Popen(
            [nvcc, *NVCC_FLAGS, *(f'-D{d}' for d in defines), '-o', str(tmp),
             str(CSRC / f'{name}.cu')],
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
    """The C entry point ``name`` (one of ``KERNELS``), its source built
    on first use; the typed function is kept, so a call costs a lookup."""
    fn = _FNS.get(name)
    if fn is not None:
        return fn
    src = SOURCE_OF[name]
    if src not in _LIBS:
        path = _lib_path(src)
        if not path.exists():
            build_all([src])
        _LIBS[src] = ctypes.CDLL(str(path))
    fn_name, argtypes = SIGNATURES[name]
    fn = getattr(_LIBS[src], fn_name)
    fn.argtypes = list(argtypes)
    fn.restype = ctypes.c_int
    _FNS[name] = fn
    return fn


def variant_kernel(name: str, defines: Tuple[str, ...]):
    """The C entry point ``name`` from its source built with ``-D``
    ``defines``: the measurement builds of tools/ (``SOURCE_OF``'s
    source, a library of its own), never launched on a user path."""
    src = SOURCE_OF[name]
    path = _lib_path(src, defines)
    if not path.exists():
        build_all([src], defines)
    fn_name, argtypes = SIGNATURES[name]
    fn = getattr(ctypes.CDLL(str(path)), fn_name)
    fn.argtypes = list(argtypes)
    fn.restype = ctypes.c_int
    return fn


def check(name: str, rc: int) -> None:
    if rc != 0:
        raise RuntimeError(f'CUDA kernel {name} failed to launch: '
                           f'cudaError {rc}')


def stream_ptr(device: torch.device) -> int:
    """The raw handle of the current CUDA stream on ``device``, without
    building a ``torch.cuda.Stream`` (a few microseconds a call)."""
    index = device.index
    if index is None:
        index = torch.cuda.current_device()
    return torch._C._cuda_getCurrentRawStream(index)


def aligned16(t: torch.Tensor) -> torch.Tensor:
    """t, or a copy of it at a new (16-byte aligned) allocation: bulk
    copies need 16-byte aligned rows."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


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
