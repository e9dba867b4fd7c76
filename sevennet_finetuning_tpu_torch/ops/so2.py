"""The edge frame of the SO(2) convolutions (EquiformerV2, arXiv:2306.12059).

Coefficients are real spherical harmonics in e3nn's basis and order
(``ops/spherical``: y is the polar axis, index l^2 + l + m in a degree's
block).  Per edge:

- ``edge_rotation``: the Wigner-D matrix D(R) of the rotation R that takes
  the edge's direction n onto +y, built from n's two angles with the roll
  fixed at 0: R = Rx(-beta) Ry(-alpha), n = (sin b sin a, cos b, sin b
  cos a).  D(Ry(t)) mixes m and -m by cos(m t) and sin(|m| t); D(Rx(t)) is
  D(Q)^T D(Ry(t)) D(Q) with Q = Rz(pi / 2), which takes x to y.  D(Q) and
  the sine pattern of D(Ry) are fitted once from the harmonics (float64
  least squares).  cos(m a), sin(m a) come from powers of (z + i x) / rho,
  so no angle function is called; at the poles (rho = 0) alpha is 0.  A
  product by a D(Ry) is elementwise (a diagonal and one partner entry a
  column), so only the product by D(Q) is a GEMM.  Rows are kept for |m| <= mmax and put in the m-major order
  ``m_major(lmax, mmax)``: m = 0 for l = 0..lmax, then +1 and -1 for l =
  1..lmax, then +2 and -2, as fairchem's SO(2) convolution reads them.
- ``rotate_in`` / ``rotate_back``: node features into the edge frames
  (both ends in one launch, the gathers folded in) and edge-frame rows
  back, on the card by ``csrc/so2.cu`` (``EdgeRotate``,
  ``EdgeRotateBack``; their cotangents by ``so2_rotate_grad`` and the
  scatter kernels), which read and write only D's degree blocks
  (``row_spans``); on the CPU by their plain versions (gathers and
  batched products).
- ``so2_linear``: the SO(2) linear map of m-major coefficients [E, K, C]:
  m = 0 by one linear map (with bias), m > 0 by the complex form
  y+ = W_r x+ - W_i x-, y- = W_r x- + W_i x+; an optional radial weight a
  (m, l, channel), shared by +m and -m, multiplies the input.
- ``grid_matrices``: e3nn's ToS2Grid / FromS2Grid at a resolution (R, R)
  with 'component' normalisation, as fairchem's EquiformerV2 builds its
  SO3_Grid: the 'integral' harmonics at beta_b = (b + 1/2) pi / R,
  alpha_a = 2 pi a / R, degree l times c_l = sqrt(4 pi / ((2l + 1)
  (lmax + 1))), and back through the Driscoll-Healy weights in beta over
  c_l; restricted to |m| <= mmax with the degrees l > mmax rescaled by
  sqrt((2l + 1) / (2 mmax + 1)), as fairchem's SO3_Grid (the edge
  frame's m-major rows; ``node_grid_matrices``: every degree, l-major, for
  node features).  ``s2_act`` applies SiLU on the grid and projects
  back, saving only its input (the grid is recomputed in the backward):
  on the card by ``s2_act`` / ``s2_act_bwd`` (the grid never in device
  memory), on the CPU as two GEMMs.

Nothing is built at import: the constant matrices are cached on first
use, per device and dtype.
"""

from __future__ import annotations

import math
from functools import lru_cache
from typing import List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from . import _cuda
from .spherical import spherical_harmonics


# -- layout ------------------------------------------------------------------

@lru_cache(maxsize=None)
def m_major(lmax: int, mmax: int) -> Tuple[int, ...]:
    """l-major indices (l^2 + l + m) of the kept coefficients, m-major."""
    rows = [l * l + l for l in range(lmax + 1)]
    for m in range(1, mmax + 1):
        for sign in (1, -1):
            rows += [l * l + l + sign * m for l in range(m, lmax + 1)]
    return tuple(rows)


@lru_cache(maxsize=None)
def m_sizes(lmax: int, mmax: int) -> Tuple[int, ...]:
    """Degrees with each m = 0..mmax (lmax + 1 - m)."""
    return tuple(lmax + 1 - m for m in range(mmax + 1))


@lru_cache(maxsize=None)
def row_degrees(lmax: int, mmax: int) -> Tuple[int, ...]:
    """The degree l of each m-major row."""
    return tuple(math.isqrt(i) for i in m_major(lmax, mmax))


def degree_rescale(lmax: int, mmax: int) -> np.ndarray:
    """sqrt((2l + 1) / (2 mmax + 1)) for the m-major rows of l > mmax, 1
    elsewhere (fairchem's rescale of truncated degrees)."""
    return np.array([math.sqrt((2 * l + 1) / (2 * mmax + 1)) if l > mmax
                     else 1.0 for l in row_degrees(lmax, mmax)])


# -- rotations ---------------------------------------------------------------

def _rot_y(t: float) -> np.ndarray:
    c, s = math.cos(t), math.sin(t)
    return np.array([[c, 0.0, s], [0.0, 1.0, 0.0], [-s, 0.0, c]])


def _rot_z(t: float) -> np.ndarray:
    c, s = math.cos(t), math.sin(t)
    return np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])


def _sh64(lmax: int, v: np.ndarray) -> np.ndarray:
    return spherical_harmonics(lmax)(torch.as_tensor(v)).numpy()


@lru_cache(maxsize=None)
def fitted_wigner(lmax: int, key: Tuple[float, ...]) -> np.ndarray:
    """The block-diagonal D(R) [(lmax+1)^2]^2 of the rotation R (``key``:
    its 9 entries) with Y(R n) = D(R) Y(n), fitted in float64."""
    R = np.asarray(key, np.float64).reshape(3, 3)
    n = np.random.default_rng(0).normal(size=(64, 3))
    n /= np.linalg.norm(n, axis=1, keepdims=True)
    A, B = _sh64(lmax, n), _sh64(lmax, n @ R.T)
    D = np.linalg.lstsq(A, B, rcond=None)[0].T
    out = np.zeros_like(D)
    for l in range(lmax + 1):
        s = slice(l * l, (l + 1) ** 2)
        out[s, s] = D[s, s]
    return out


@lru_cache(maxsize=None)
def _y_signs(lmax: int) -> np.ndarray:
    """S [d, d]: D(Ry(t)) = cos(m t) on the diagonal plus S[a, b] sin(|m|
    t) at each coefficient's partner b (its -m), the sign read off a fit
    at one angle."""
    d = (lmax + 1) ** 2
    t0 = 0.3
    fit = fitted_wigner(lmax, tuple(_rot_y(t0).reshape(-1)))
    S = np.zeros((d, d))
    for l in range(lmax + 1):
        for m in range(-l, l + 1):
            if m != 0:
                a, b = l * l + l + m, l * l + l - m
                S[a, b] = np.sign(fit[a, b] / math.sin(abs(m) * t0))
    return S


@lru_cache(maxsize=None)
def _frame_consts(lmax: int, mmax: int, device: torch.device, dtype):
    """(J = D(Q) [d, d], J^T's kept rows [K, d] and their columns taken
    at each column's partner -m, the index of cos(|m| t) and of sin(|m|
    t) in ``_powers`` for each coefficient, the sine's sign)."""
    S = _y_signs(lmax)
    J = fitted_wigner(lmax, tuple(_rot_z(math.pi / 2).reshape(-1)))
    rows = list(m_major(lmax, mmax))
    d = (lmax + 1) ** 2
    partner = [l * l + l - (j - l * l - l) for l in range(lmax + 1)
               for j in range(l * l, (l + 1) ** 2)]
    mabs = [abs(j - l * l - l) for l in range(lmax + 1)
            for j in range(l * l, (l + 1) ** 2)]
    # D(Ry(t))[partner(j), j] = sign_j sin(|m_j| t); cos(m t) on the diagonal
    sign = [S[partner[j], j] for j in range(d)]
    cos_at = mabs
    sin_at = [lmax + m if m else 0 for m in mabs]

    def t(a, dt=dtype):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dt,
                               device=device)

    Jt = J.T[rows]
    return (t(J), t(Jt), t(Jt[:, partner]), t(partner, torch.long),
            t(cos_at, torch.long), t(sin_at, torch.long), t(sign))


def _powers(c: torch.Tensor, s: torch.Tensor, k: int) -> torch.Tensor:
    """[cos(0 t) .. cos(k t), sin(t) .. sin(k t)] of (c, s) = (cos t,
    sin t), by complex powers."""
    cos, sin = [torch.ones_like(c), c], [s]
    for _ in range(2, k + 1):
        cos.append(cos[-1] * c - sin[-1] * s)
        sin.append(sin[-1] * c + cos[-2] * s)
    return torch.stack(cos[:k + 1] + sin[:k], -1)


def edge_rotation(vec: torch.Tensor, lmax: int, mmax: int) -> torch.Tensor:
    """D(R) of each edge vector [E, 3] (non-zero), its rows m-major for
    |m| <= mmax: [E, K, (lmax + 1)^2], differentiable in ``vec``.

    D = J^T Zb J Za with Z = D(Ry(-t)) diagonal (cos) plus one partner
    entry a column (sin), so each product by a Z is elementwise: (A Z)[:,
    j] = A[:, j] Z[j, j] + A[:, partner(j)] Z[partner(j), j]."""
    J, Jt, Jt_p, partner, cos_at, sin_at, sign = _frame_consts(
        lmax, mmax, vec.device, vec.dtype)
    x, y, z = vec.unbind(-1)
    r = torch.sqrt(x * x + y * y + z * z)
    rho2 = x * x + z * z
    pole = rho2 <= (1e-12 * r) ** 2
    rho = torch.sqrt(torch.where(pole, torch.ones_like(rho2), rho2))
    # alpha: (cos, sin) = (z, x) / rho; beta: (cos, sin) = (y, rho) / r
    ca = torch.where(pole, torch.ones_like(z), z / rho)
    sa = torch.where(pole, torch.zeros_like(x), x / rho)
    cb = y / r
    sb = torch.where(pole, torch.zeros_like(x), rho / r)
    # Ry(-t): cos(m t) stays, sin(m t) changes sign
    fa = _powers(ca, -sa, lmax)
    fb = _powers(cb, -sb, lmax)
    diag_a, off_a = fa[:, cos_at], fa[:, sin_at] * sign
    diag_b, off_b = fb[:, cos_at], fb[:, sin_at] * sign
    # rows of D(Rx(-b)) D(Ry(-a)) = J^T Zb J Za, J = D(Q)
    a = Jt * diag_b[:, None, :] + Jt_p * off_b[:, None, :]     # [E, K, d]
    a = a @ J
    return a * diag_a[:, None, :] + a[:, :, partner] * off_a[:, None, :]


# -- the SO(2) linear map ------------------------------------------------------

def so2_linear(x: torch.Tensor, w0: torch.Tensor, b0: torch.Tensor,
               wm: List[torch.Tensor], sizes: Tuple[int, ...],
               radial: torch.Tensor = None, extra: int = 0):
    """SO(2) linear map of m-major coefficients x [E, K, C_in] to [E, K,
    C_out] (and the ``extra`` m = 0 scalars [E, extra], or None).

    ``w0`` [sizes[0] C_in, extra + sizes[0] C_out] and ``b0``: the m = 0
    map, its first ``extra`` outputs the scalars; ``wm[m - 1]`` [sizes[m]
    C_in, 2 sizes[m] C_out]: W_r then W_i of order m.  ``radial`` [E,
    sum(sizes) C_in]: the per-edge weights of the inputs, m by m.  Inputs
    and outputs are cut with ``split`` (whose backward is a ``cat``, not a
    zero fill per slice)."""
    e, _, c_in = x.shape
    parts = x.split([sizes[0]] + [2 * n for n in sizes[1:]], 1)
    rad = (radial.split([n * c_in for n in sizes], 1) if radial is not None
           else [None] * len(sizes))
    n0 = sizes[0]
    x0 = parts[0].reshape(e, n0 * c_in)
    if rad[0] is not None:
        x0 = x0 * rad[0]
    y0 = torch.addmm(b0, x0, w0)
    c_out = (y0.shape[1] - extra) // n0
    ex, y0 = y0.split([extra, n0 * c_out], 1)
    out = [y0.reshape(e, n0, c_out)]
    for m, w in enumerate(wm, start=1):
        n = sizes[m]
        xm = parts[m].reshape(e, 2, n * c_in)
        if rad[m] is not None:
            xm = xm * rad[m][:, None]
        # one 2-D GEMM (a batched product would expand w for the backward)
        yr, yi = (xm.reshape(2 * e, n * c_in) @ w).view(
            e, 2, 2 * n * c_out).split(n * c_out, 2)         # [E, 2, n C]
        yp, ym = yr.unbind(1)
        ip, im = yi.unbind(1)
        out.append(torch.stack([yp - im, ym + ip], 1).reshape(e, 2 * n,
                                                             c_out))
    return torch.cat(out, 1), (ex if extra else None)


# -- the edge rotation on the card ---------------------------------------------

@lru_cache(maxsize=None)
def row_spans(d: int, rows: int) -> Tuple[Tuple[int, int], ...]:
    """(first column, count) of each of the first ``rows`` m-major rows of
    an edge frame D [E, K, d], d = (lmax + 1)^2: row k of degree l is
    non-zero only in its degree's block l^2..(l+1)^2 - 1 (D(R) is
    block-diagonal by degree).  ``m_major(lmax, mmax)`` is a prefix of
    ``m_major(lmax, lmax)`` for every mmax, so the first rows' degrees
    do not depend on mmax."""
    lmax = math.isqrt(d) - 1
    if (lmax + 1) ** 2 != d or not 1 <= rows <= d:
        raise ValueError(f'so2_rotate: D of {rows} rows and {d} columns is '
                         'not an edge frame')
    return tuple((l * l, 2 * l + 1) for l in row_degrees(lmax, lmax)[:rows])


@lru_cache(maxsize=None)
def _host_spans(d: int, rows: int):
    """``row_spans`` as the kernels' host array."""
    return _cuda.host_ints([v for span in row_spans(d, rows) for v in span])


def _card_f32(name: str, t: torch.Tensor, what: str) -> None:
    if not t.is_cuda or t.dtype != torch.float32 or t.stride(-1) != 1:
        raise ValueError(f'{name}: {what} must be float32 on the card with '
                         'contiguous channels')


def _legs(name: str, ts) -> None:
    """The legs of one launch share shapes and strides."""
    if len(ts) not in (1, 2) or any(
            t.shape != ts[0].shape or t.stride() != ts[0].stride()
            for t in ts):
        raise ValueError(f'{name}: one or two legs of one shape and stride')


def _ptr(t):
    return t.data_ptr() if t is not None else None


def _rotate(D: torch.Tensor, xs, idxs, transpose: bool, outs):
    """``so2_rotate`` of one or two legs in one launch, D read once:
    outs[i] [E, n_out, >= C] (its channels may be a slice of a wider row)
    = D xs[i] (n_out = K) or D^T xs[i] (``transpose``, n_out = d), xs[i]
    [rows, n_in, C] gathered by idxs[i] (int32) or one row an edge.  D [E,
    K, d] holds the first K rows of the m-major order (a prefix slice
    allowed, as the edge-degree embedding's m = 0 rows); only its degree
    blocks are read."""
    E, K, d = D.shape
    _legs('so2_rotate', xs)
    _legs('so2_rotate', outs)
    _card_f32('so2_rotate', D, 'D')
    for x, out in zip(xs, outs):
        _card_f32('so2_rotate', x, 'x')
        _card_f32('so2_rotate', out, 'out')
    x, out = xs[0], outs[0]
    n_in, n_out = (K, d) if transpose else (d, K)
    if x.shape[1] != n_in or out.shape[:2] != (E, n_out):
        raise ValueError(f'so2_rotate: x rows of {x.shape[1]}, out of '
                         f'{tuple(out.shape[:2])} for D {tuple(D.shape)}')
    if D.stride(1) != d or D.storage_offset() % D.stride(0):
        raise ValueError('so2_rotate: D must hold contiguous rows, the '
                         'first of the m-major order')
    legs = len(xs)
    _cuda.LAUNCHES['so2_rotate'] += 1
    _cuda.check('so2_rotate', _cuda.kernel('so2_rotate')(
        D.data_ptr(), D.stride(0), _host_spans(d, K), K, d, x.data_ptr(),
        xs[-1].data_ptr(), _ptr(idxs[0]), _ptr(idxs[-1]), x.stride(0),
        x.stride(1), out.data_ptr(), outs[-1].data_ptr(), out.stride(0),
        out.stride(1), E, x.shape[2], int(transpose), legs,
        _cuda.stream_ptr(x.device)))
    return outs


def _rotate_grad(As, ias, Bs, ibs, out, accumulate: bool):
    """``so2_rotate_grad`` of one or two legs in one launch: out[e, k, i]
    (+)= sum over the legs and channels of As[ias(e), k, c] Bs[ibs(e), i,
    c] on D's degree blocks (i in row k's span, ``row_spans``), 0 off them
    (or left as it was, with ``accumulate``): the cotangent of an edge
    frame D [E, K, d] (out, contiguous) through ``_rotate``, whose
    structural zeros ``edge_rotation``'s backward multiplies by zeros."""
    _cuda.require(out, 'out', torch.float32)
    E, K, d = out.shape
    _legs('so2_rotate_grad', As)
    _legs('so2_rotate_grad', Bs)
    for a, b in zip(As, Bs):
        _card_f32('so2_rotate_grad', a, 'a')
        _card_f32('so2_rotate_grad', b, 'b')
    a, b = As[0], Bs[0]
    if a.shape[1:] != (K, b.shape[2]) or b.shape[1] != d:
        raise ValueError(f'so2_rotate_grad: a {tuple(a.shape)}, b '
                         f'{tuple(b.shape)} for out {tuple(out.shape)}')
    _cuda.LAUNCHES['so2_rotate_grad'] += 1
    _cuda.check('so2_rotate_grad', _cuda.kernel('so2_rotate_grad')(
        _host_spans(d, K), K, d, a.data_ptr(), As[-1].data_ptr(),
        _ptr(ias[0]), _ptr(ias[-1]), a.stride(0), a.stride(1), b.data_ptr(),
        Bs[-1].data_ptr(), _ptr(ibs[0]), _ptr(ibs[-1]), b.stride(0),
        b.stride(1), out.data_ptr(), K * d, E, a.shape[2], len(As),
        int(accumulate), _cuda.stream_ptr(out.device)))
    return out


def rotate_in(D: torch.Tensor, x: torch.Tensor, src: torch.Tensor,
              dst: torch.Tensor, perm: torch.Tensor,
              inv: torch.Tensor) -> torch.Tensor:
    """[D x[src] | D x[dst]] [E, K, 2C] of node features x [N, d, C] into
    the edge frames D [E, K, d]; ``src`` / ``dst``: the batch's indices
    (the sentinel n past the last row), ``perm`` / ``inv`` the sources'
    sort.  ``EdgeRotate`` on the card; on the CPU its plain version."""
    if x.is_cuda:
        top = x.shape[0] - 1
        return EdgeRotate.apply(D, x, src.clamp(max=top).int(),
                                dst.clamp(max=top).int(), src, dst, perm,
                                inv)
    return rotate_in_plain(D, x, src, dst, perm, inv)


def rotate_in_plain(D, x, src, dst, perm, inv) -> torch.Tensor:
    """``rotate_in``'s plain version: the gathers (``gather_rows``,
    ``gather_zero_oob``) and a batched product."""
    from .scatter import gather_rows, gather_zero_oob

    n = x.shape[0]
    flat = x.reshape(n, -1)
    xs = gather_rows(flat, src, perm, inv).reshape(-1, *x.shape[1:])
    xt = gather_zero_oob(flat, dst).reshape(-1, *x.shape[1:])
    return torch.bmm(D, torch.cat([xs, xt], -1))


def rotate_back(D: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """D^T y [E, d, C] of edge-frame rows y [E, K, C]: ``EdgeRotateBack``
    on the card, its plain batched product on the CPU."""
    if y.is_cuda:
        return EdgeRotateBack.apply(D, y)
    return torch.bmm(D.transpose(1, 2), y)


class EdgeRotate(torch.autograd.Function):
    """[D x[src] | D x[dst]] [E, K, 2C] of node features x [N, d, C]:
    both legs in one launch, the gathers folded into the kernel (``src``
    / ``dst`` int32, clamped into range); the backward gives D's
    cotangent by one ``so2_rotate_grad`` of both legs and x's as D^T of
    the message's cotangent (one launch for both halves), summed at the
    sources (``scatter_rows`` by ``perm`` / ``inv``) and destinations (the
    sorted segment sum) on their kernels."""

    @staticmethod
    def forward(ctx, D, x, src, dst, src_s, dst_s, perm, inv):
        E, K = D.shape[0], D.shape[1]
        n, d, C = x.shape
        out = torch.empty((E, K, 2 * C), dtype=x.dtype, device=x.device)
        _rotate(D, (x, x), (src, dst), False, (out[:, :, :C], out[:, :, C:]))
        ctx.save_for_backward(D, x, src, dst, src_s, dst_s, perm, inv)
        return out

    @staticmethod
    def backward(ctx, ct):
        from .scatter import scatter_rows, segment_sum_sorted

        D, x, src, dst, src_s, dst_s, perm, inv = ctx.saved_tensors
        ct = ct.contiguous()
        n, d, C = x.shape
        E = D.shape[0]
        halves = (ct[:, :, :C], ct[:, :, C:])
        dD = _rotate_grad(halves, (None, None), (x, x), (src, dst),
                          torch.empty(D.shape, dtype=D.dtype,
                                      device=D.device), False)
        g = torch.empty((2, E, d, C), dtype=x.dtype, device=x.device)
        _rotate(D, halves, (None, None), True, (g[0], g[1]))
        dx = scatter_rows(g[0].reshape(E, d * C), src_s, n, perm, inv) \
            + segment_sum_sorted(g[1].reshape(E, d * C), dst_s, n)
        return dD, dx.reshape(n, d, C), None, None, None, None, None, None


class EdgeRotateBack(torch.autograd.Function):
    """D^T y [E, d, C] of edge-frame rows y [E, K, C] (D [E, K, d], a
    prefix of its rows allowed)."""

    @staticmethod
    def forward(ctx, D, y):
        y = y.contiguous()
        ctx.save_for_backward(D, y)
        out = torch.empty((y.shape[0], D.shape[2], y.shape[2]),
                          dtype=y.dtype, device=y.device)
        return _rotate(D, (y,), (None,), True, (out,))[0]

    @staticmethod
    def backward(ctx, ct):
        D, y = ctx.saved_tensors
        ct = ct.contiguous()
        dD = _rotate_grad((y,), (None,), (ct,), (None,),
                          torch.empty(D.shape, dtype=D.dtype,
                                      device=D.device), False)
        dy = _rotate(D, (ct,), (None,), False, (torch.empty_like(y),))[0]
        return dD, dy


# -- the S2 grid -------------------------------------------------------------

def dh_weights(res: int) -> np.ndarray:
    """Driscoll-Healy weights of the beta grid (b + 1/2) pi / res, summing
    to 2 = int_0^pi sin(beta) d beta (e3nn's ``_quadrature_weights``)."""
    b = res // 2
    k = np.arange(b)
    w = np.array([(2.0 / b) * math.sin(math.pi * (2 * j + 1) / (4 * b))
                  * np.sum(np.sin((2 * j + 1) * (2 * k + 1) * math.pi
                                  / (4 * b)) / (2 * k + 1))
                  for j in range(2 * b)])
    return 2.0 * w / w.sum()


@lru_cache(maxsize=None)
def _grid64(lmax: int, res: int) -> Tuple[np.ndarray, np.ndarray]:
    """(to [P, d], from [d, P]) float64 in l-major order, P = res^2,
    'component' normalised (degree l's columns of ``to`` times c_l, its
    rows of ``from`` over c_l)."""
    beta = (np.arange(res) + 0.5) * math.pi / res
    alpha = np.arange(res) * 2 * math.pi / res
    bb, aa = np.meshgrid(beta, alpha, indexing='ij')
    n = np.stack([np.sin(bb) * np.sin(aa), np.cos(bb),
                  np.sin(bb) * np.cos(aa)], -1).reshape(-1, 3)
    Y = spherical_harmonics(lmax, normalization='integral')(
        torch.as_tensor(n)).numpy()
    omega = np.repeat(dh_weights(res), res) * (2 * math.pi / res)
    c = np.array([math.sqrt(4 * math.pi / ((2 * l + 1) * (lmax + 1)))
                  for l in range(lmax + 1) for _ in range(2 * l + 1)])
    return Y * c, (Y * omega[:, None] / c).T


@lru_cache(maxsize=None)
def grid_matrices(lmax: int, mmax: int, res: int, device: torch.device,
                  dtype) -> Tuple[torch.Tensor, torch.Tensor]:
    """(to_grid [P, K], from_grid [K, P]) of the edge frame's m-major rows
    of |m| <= mmax, the truncated degrees rescaled."""
    to, frm = _grid64(lmax, res)
    rows = list(m_major(lmax, mmax))
    scale = degree_rescale(lmax, mmax)
    return (torch.as_tensor(to[:, rows] * scale, dtype=dtype, device=device),
            torch.as_tensor(frm[rows] * scale[:, None], dtype=dtype,
                            device=device))


@lru_cache(maxsize=None)
def node_grid_matrices(lmax: int, res: int, device: torch.device,
                       dtype) -> Tuple[torch.Tensor, torch.Tensor]:
    """(to_grid [P, d], from_grid [d, P]) of node features, l-major."""
    to, frm = _grid64(lmax, res)
    return (torch.as_tensor(to, dtype=dtype, device=device),
            torch.as_tensor(frm, dtype=dtype, device=device))


class S2Act(torch.autograd.Function):
    """from @ silu(to @ x) for x [B, K, C], as two GEMMs over the B C
    rows (the plain version, on the CPU); saves x only (the grid is
    recomputed in the backward)."""

    @staticmethod
    def forward(ctx, x, to, frm):
        ctx.save_for_backward(x, to, frm)
        b, k, c = x.shape
        rows = x.transpose(1, 2).reshape(b * c, k)
        out = F.silu(rows @ to.t()) @ frm.t()
        return out.reshape(b, c, k).transpose(1, 2)

    @staticmethod
    def backward(ctx, ct):
        x, to, frm = ctx.saved_tensors
        b, k, c = x.shape
        rows = x.transpose(1, 2).reshape(b * c, k)
        g = rows @ to.t()
        s = torch.sigmoid(g)
        dg = (ct.transpose(1, 2).reshape(b * c, k) @ frm) \
            * (s * (1 + g * (1 - s)))
        return (dg @ to).reshape(b, c, k).transpose(1, 2), None, None


def _padded_rows(m: torch.Tensor) -> torch.Tensor:
    """[P, K] padded with zero columns to a multiple of 4."""
    k = m.shape[1]
    return F.pad(m, (0, (-k) % 4)).contiguous()


@lru_cache(maxsize=None)
def _card_grid(to: torch.Tensor, frm: torch.Tensor):
    """(to, from^T) padded: the kernels' [P, K] rows (``to`` and ``frm``
    are ``grid_matrices``' cached tensors, so this caches by identity)."""
    return _padded_rows(to), _padded_rows(frm.t())


class S2ActCard(torch.autograd.Function):
    """``S2Act`` by ``s2_act`` / ``s2_act_bwd``: a thread a (row,
    channel), the grid in registers."""

    @staticmethod
    def forward(ctx, x, to, frm):
        x = x.contiguous()
        tp, fp = _card_grid(to, frm)
        b, k, c = x.shape
        out = torch.empty_like(x)
        _cuda.LAUNCHES['s2_act'] += 1
        _cuda.check('s2_act', _cuda.kernel('s2_act')(
            x.data_ptr(), tp.data_ptr(), fp.data_ptr(), out.data_ptr(), b, k,
            c, tp.shape[0], _cuda.stream_ptr(x.device)))
        ctx.save_for_backward(x, tp, fp)
        return out

    @staticmethod
    def backward(ctx, ct):
        x, tp, fp = ctx.saved_tensors
        ct = ct.contiguous()
        b, k, c = x.shape
        dx = torch.empty_like(x)
        _cuda.LAUNCHES['s2_act_bwd'] += 1
        _cuda.check('s2_act_bwd', _cuda.kernel('s2_act_bwd')(
            x.data_ptr(), ct.data_ptr(), tp.data_ptr(), fp.data_ptr(),
            dx.data_ptr(), b, k, c, tp.shape[0], _cuda.stream_ptr(x.device)))
        return dx, None, None


def s2_act(x: torch.Tensor, to: torch.Tensor,
           frm: torch.Tensor) -> torch.Tensor:
    """from @ silu(to @ x) over the coefficient rows of x [B, K, C]: the
    kernels on a CUDA tensor, the plain GEMMs on the CPU."""
    if x.is_cuda:
        return S2ActCard.apply(x, to, frm)
    return S2Act.apply(x, to, frm)


@lru_cache(maxsize=None)
def degree_index(lmax: int, device: torch.device) -> torch.Tensor:
    """The degree l of each l-major coefficient, on ``device``."""
    return torch.as_tensor([l for l in range(lmax + 1)
                            for _ in range(2 * l + 1)], device=device)


@lru_cache(maxsize=None)
def rescale_rows(lmax: int, mmax: int, device: torch.device,
                 dtype) -> torch.Tensor:
    """``degree_rescale`` on ``device``."""
    return torch.as_tensor(degree_rescale(lmax, mmax), dtype=dtype,
                           device=device)
