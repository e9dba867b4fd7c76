"""The kernels' frozen memory bounds and the table of peaks.

Peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at the full
700 W power limit): 3.35 TB/s of HBM, 67 TFLOP/s float32 outside the
tensor cores.  The csrc kernels run float32 on the CUDA cores and are
bound by bytes at these widths, so a launch's bound is its bytes over
3.35 TB/s: each input byte read once (the live edges' rows of each edge
array it reads, the node rows it reads, the edge index) and each output
byte written once.  ``Census`` records each launch's sizes by wrapping
the program's kernel wrappers (``ops/scatter.segment_sum_cuda``,
``ops/fused_conv_agg.agg_cuda``, ``ops/fused_conv_multi.gagg_cuda`` and
``_gmulti_launch``, under which ``cg_multi`` and ``cg_gmulti`` launch)
while a trace is on; ``bytes_of`` turns a record into bytes once the
slice has ended (the live edge counts are read then, not inside it).
"""

from __future__ import annotations

from typing import Dict, List, Tuple

HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
F32 = 4
I32 = 4


def segment_sum_bytes(E: int, D: int, n_rows: int, live: int) -> int:
    """msg [E, D] (live rows read), dst [E], out [n_rows, D]."""
    return F32 * live * D + I32 * E + F32 * n_rows * D


def agg_bytes(E: int, live: int, N: int, dx: int, dsh: int, dw: int,
              dmsg: int) -> int:
    """x, sh, w (live rows), dst, out [N, dmsg]."""
    return F32 * live * (dx + dsh + dw) + I32 * E + F32 * N * dmsg


def gagg_bytes(E: int, live: int, N: int, pool_dims: List[int],
               dmsg: int) -> int:
    """The pool arrays the terms read (live rows), dst, out [N, dmsg]."""
    return F32 * live * sum(pool_dims) + I32 * E + F32 * N * dmsg


def gmulti_bytes(E: int, live: int, N: int, pool_dims: List[int],
                 out_dims: List[int], dmsg: int) -> int:
    """ybar [N, dmsg], the pool arrays the jobs read (live rows), dst,
    one [E, d] output a group (every row written)."""
    return (F32 * N * dmsg + F32 * live * sum(pool_dims) + I32 * E
            + F32 * E * sum(out_dims))


def bound_s(n_bytes: int) -> float:
    return n_bytes / HBM_BYTES_PER_S


class Census:
    """The csrc launches between ``install()`` and ``remove()``: one
    record (family, sizes, dst) a wrapper call."""

    def __init__(self):
        self.records: List[Tuple[str, Dict, object]] = []
        self._saved = []

    def install(self):
        from sevennet_finetuning_tpu_torch.ops import (fused_conv_agg,
                                                       fused_conv_multi,
                                                       scatter)

        rec = self.records

        def seg(fn):
            def wrapped(msg, dst, n_rows):
                rec.append(('segment_sum', dict(E=msg.shape[0],
                                                D=msg.shape[1],
                                                n_rows=n_rows), dst))
                return fn(msg, dst, n_rows)
            return wrapped

        def agg(fn):
            def wrapped(x, sh, w, dst, layout, n_node, *a, **k):
                rec.append(('cg_agg', dict(
                    E=dst.shape[0], N=n_node, dx=layout.dim_x,
                    dsh=layout.dim_sh, dw=layout.dim_w,
                    dmsg=layout.dim_msg), dst))
                return fn(x, sh, w, dst, layout, n_node, *a, **k)
            return wrapped

        def gagg(fn):
            def wrapped(pool, dst, terms, layout, n_node):
                used = sorted({i for t in terms for i in t})
                rec.append(('cg_gagg', dict(
                    E=dst.shape[0], N=n_node,
                    pool_dims=[pool[i].shape[1] for i in used],
                    dmsg=layout.dim_msg), dst))
                return fn(pool, dst, terms, layout, n_node)
            return wrapped

        def gmulti(fn):
            def wrapped(entry, ybar, pool, dst, jobs, groups, layout,
                        n_node, n_phase):
                outs = fn(entry, ybar, pool, dst, jobs, groups, layout,
                          n_node, n_phase)
                used = sorted({i for j in jobs for i in j[1:3]})
                rec.append((entry, dict(
                    E=dst.shape[0], N=n_node,
                    pool_dims=[pool[i].shape[1] for i in used],
                    out_dims=[o.shape[1] for o in outs],
                    dmsg=layout.dim_msg), dst))
                return outs
            return wrapped

        for mod, name, wrap in ((scatter, 'segment_sum_cuda', seg),
                                (fused_conv_agg, 'agg_cuda', agg),
                                (fused_conv_multi, 'gagg_cuda', gagg),
                                (fused_conv_multi, '_gmulti_launch',
                                 gmulti)):
            fn = getattr(mod, name)
            self._saved.append((mod, name, fn))
            setattr(mod, name, wrap(fn))

    def remove(self):
        for mod, name, fn in reversed(self._saved):
            setattr(mod, name, fn)
        self._saved = []

    def bound_seconds(self) -> Dict[str, float]:
        """Seconds of the bound by family, summed over the records."""
        out: Dict[str, float] = {}
        live_of = {}
        for fam, sz, dst in self.records:
            key = id(dst)
            if key not in live_of:
                n = sz.get('n_rows', sz.get('N'))
                live_of[key] = int((dst < n).sum())
            out[fam] = out.get(fam, 0.0) + bound_s(
                bytes_of(fam, sz, live_of[key]))
        return out


def bytes_of(fam: str, sz: Dict, live: int) -> int:
    if fam == 'segment_sum':
        return segment_sum_bytes(sz['E'], sz['D'], sz['n_rows'], live)
    if fam == 'cg_agg':
        return agg_bytes(sz['E'], live, sz['N'], sz['dx'], sz['dsh'],
                         sz['dw'], sz['dmsg'])
    if fam == 'cg_gagg':
        return gagg_bytes(sz['E'], live, sz['N'], sz['pool_dims'],
                          sz['dmsg'])
    return gmulti_bytes(sz['E'], live, sz['N'], sz['pool_dims'],
                        sz['out_dims'], sz['dmsg'])
