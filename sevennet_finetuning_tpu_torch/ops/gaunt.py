"""Gaunt tensor products in the 2D Fourier basis.

Port of ``sevennet_finetuning_tpu/ops/gaunt.py`` (reference:
sevenn/nn/gaunt_util.py, sevenn/nn/convolution.py:126-403,
sevenn/nn/gaunt_product_basis.py; method of Luo et al., "Gaunt Tensor
Products", arXiv:2401.10216): spherical-harmonic expansions are mapped to
2D Fourier coefficients on the torus (theta, phi), where products of
functions on the sphere become 2D convolutions of coefficient grids --
evaluated as FFT pointwise products.

- Y (SH -> Fourier) coefficients come from sampling the package's real
  spherical harmonics on a torus grid and an exact DFT (they are trig
  polynomials of bounded degree); Z (Fourier -> SH) is the Moore-Penrose
  pseudo-inverse of Y.  Both are float64 numpy on the host, cached, and
  copied to a device once per (dtype, device).
- The model's path contracts through the Gaunt product's sparse
  coupling table (``gaunt_layout``: a ``CGLayout`` of (k, i, j, c)
  couplings, 21 at (l <= 1) x (l <= 3) -> (l <= 1)) on the port's one
  convolution path (``fused_conv_agg.convolve``: ``csrc/cg_agg.cu``
  forward, ``cg_multi`` / ``cg_gagg`` / ``cg_gmulti`` backward, their
  plain versions on CPU tensors), so no per-edge sample grid exists.
  ``gaunt_family`` is what the Gaunt family gives that path;
  ``apply_gaunt_conv`` is the path on e3nn features.
- ``gaunt_conv_fft`` keeps the FFT formulation: the source of that table
  and the reference the coupling path is held against.  Its Hermitian
  fast path (``rfft=True``, the default) takes its real FFTs with
  ``torch.fft.rfft2`` / ``irfft2``, which autograd differentiates to any
  order.  (The JAX module wraps them in a primitive of its own only so
  that shard_map transposes carry varying axes.)  ``rfft=False`` is its
  complex-FFT variant.  It gathers the per-node sample grids by source
  with ``scatter.gather_rows`` and aggregates the messages by destination
  with the sorted segment sum (``csrc/segment_sum.cu`` on the card), so
  both sums, and their backward passes, run in a fixed order.
"""

from __future__ import annotations

import operator
from dataclasses import dataclass
from functools import lru_cache, partial, reduce
from typing import Tuple

import numpy as np
import torch

from .. import tracing
from ..irreps import Irreps
from .fused_conv import CGGroup, CGLayout, CGPath, ConvFamily, e3nn_to_stride
from .fused_conv_agg import convolve
from .mlp import mlp_apply
from .scatter import aggregate_messages, gather_rows
from .spherical import _recursion_scales
from .wigner import wigner_3j


@lru_cache(maxsize=None)
def y_coeffs(L: int) -> np.ndarray:
    """Fourier coefficients of the real SH basis on the torus:
    shape ((L+1)^2, 2L+1, 2L+1) complex; axes (lm, u+L, v+L) with
    Y_lm(theta, phi) = sum_uv Y[lm, u, v] e^(i u theta) e^(i v phi)."""
    n = 2 * L + 1
    theta = 2 * np.pi * np.arange(n) / n
    phi = 2 * np.pi * np.arange(n) / n
    tt, pp = np.meshgrid(theta, phi, indexing='ij')
    dirs = np.stack(
        [np.sin(tt) * np.cos(pp), np.sin(tt) * np.sin(pp), np.cos(tt)],
        axis=-1,
    ).reshape(-1, 3)
    # the package's real SH in float64 numpy (the recursion of
    # ops.spherical)
    scales = _recursion_scales(L) if L >= 1 else ()
    blocks = [np.ones((dirs.shape[0], 1))]
    if L >= 1:
        prev = dirs
        blocks.append(prev * np.sqrt(3.0))
        for l in range(2, L + 1):
            w = wigner_3j(l - 1, 1, l) * scales[l - 1]
            prev = np.einsum('na,nb,abk->nk', prev, dirs, w)
            blocks.append(prev * np.sqrt(2 * l + 1))
    vals = np.concatenate(blocks, axis=-1).reshape(n, n, (L + 1) ** 2)
    # c[u, v] = (1/n^2) sum f e^{-i(u theta + v phi)} -> exact for trig
    # polynomials of degree <= L
    c = np.fft.fft2(vals, axes=(0, 1)) / n**2
    # reorder fft frequencies [0..L, -L..-1] -> [-L..L]
    order = np.concatenate([np.arange(L + 1, n), np.arange(L + 1)])
    c = c[np.ix_(order, order)]
    return np.ascontiguousarray(np.moveaxis(c, -1, 0))


@lru_cache(maxsize=None)
def z_coeffs(L: int, L_max: int = -1) -> np.ndarray:
    """Fourier -> SH projection: shape ((2L+1)^2, (L_max+1)^2) complex,
    the pseudo-inverse of the degree-L Y table (exact on products of
    extended spherical harmonics)."""
    if L_max == -1:
        L_max = L
    Y = y_coeffs(L).reshape((L + 1) ** 2, -1)
    Z = np.linalg.pinv(Y)          # ((2L+1)^2, (L+1)^2)
    return np.ascontiguousarray(Z[:, :(L_max + 1) ** 2])


def weight_align_matrix(L: int) -> np.ndarray:
    """( L+1, (L+1)^2 ): broadcast one weight per l over its 2l+1
    components (reference: sevenn/nn/gaunt_util.py:16-24)."""
    idx = [l for l in range(L + 1) for _ in range(2 * l + 1)]
    return np.eye(L + 1)[idx].T.astype(np.float32)


@lru_cache(maxsize=None)
def fit_gaunt_to_w3j(L1: int, L2: int) -> np.ndarray:
    """Per-l_out ratio normalizing the Gaunt product to the CG-TP scale
    (reference: sevenn/nn/gaunt_util.py:179-201, mode 'norm')."""
    Lmax = L1 + L2
    buckets = [[] for _ in range(Lmax + 1)]
    for l1 in range(L1 + 1):
        for l2 in range(L2 + 1):
            for lo in range(abs(l1 - l2), l1 + l2 + 1):
                w = wigner_3j(l1, l2, lo)[l1, l2, lo]
                mult = (2 * l1 + 1) * (2 * l2 + 1) * (2 * lo + 1)
                buckets[lo].append(np.sqrt(mult / (4 * np.pi)) * w)
    out = np.ones(Lmax + 1)
    for lo, vals in enumerate(buckets):
        if vals:
            out[lo] = 1.0 / np.linalg.norm(np.array(vals))
    return out.astype(np.float32)


@lru_cache(maxsize=None)
def _on(key, fn, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """The host table ``fn(*key)`` as a tensor of ``dtype`` on ``device``,
    copied once per (table, dtype, device)."""
    return torch.as_tensor(fn(*key), dtype=dtype, device=device)


# ---------------------------------------------------------------------------
# strided-layout helpers (uniform multiplicity)
# ---------------------------------------------------------------------------

def _cdtype(x: torch.Tensor) -> torch.dtype:
    return torch.complex128 if x.dtype == torch.float64 else torch.complex64


def flat_to_stride(x: torch.Tensor, irreps: Irreps) -> torch.Tensor:
    """[..., sum mul*d] -> [..., mul, (lmax+1)^2] (uniform mul, sph-like
    sorted irreps covering every l up to lmax)."""
    mul = irreps[0].mul
    blocks = []
    off = 0
    for mi in irreps:
        b = x[..., off:off + mi.dim].reshape(
            x.shape[:-1] + (mul, mi.ir.dim)
        )
        blocks.append(b)
        off += mi.dim
    return torch.cat(blocks, dim=-1)


def stride_to_flat(x: torch.Tensor, irreps: Irreps) -> torch.Tensor:
    out = []
    off = 0
    for mi in irreps:
        out.append(
            x[..., off:off + mi.ir.dim].reshape(x.shape[:-2] + (mi.dim,))
        )
        off += mi.ir.dim
    return torch.cat(out, dim=-1)


def _y_flat(L: int) -> np.ndarray:
    return y_coeffs(L).reshape((L + 1) ** 2, -1)


def to_fourier(x_stride: torch.Tensor, L: int) -> torch.Tensor:
    """[..., (L+1)^2] (strided trailing ir axis) -> [..., 2L+1, 2L+1]
    complex Fourier coefficient grids."""
    cd = _cdtype(x_stride)
    Y = _on((L,), _y_flat, cd, x_stride.device)
    out = torch.einsum('...i,ij->...j', x_stride.to(cd), Y)
    return out.reshape(x_stride.shape[:-1] + (2 * L + 1, 2 * L + 1))


def to_spherical(grid: torch.Tensor, L: int, L_max: int) -> torch.Tensor:
    """[..., 2L+1, 2L+1] coefficient grids -> [..., (L_max+1)^2] real."""
    Z = _on((L, L_max), z_coeffs, grid.dtype, grid.device)
    flat = grid.reshape(grid.shape[:-2] + ((2 * L + 1) ** 2,))
    return torch.einsum('...u,ui->...i', flat, Z).real


def _real_samples(grid: torch.Tensor, Lg: int, L: int) -> torch.Tensor:
    """Centered coefficient grid [..., 2Lg+1, 2Lg+1] of a REAL spherical
    function -> its REAL sample grid [..., M, M], M = 2L+1.

    The coefficients are reversal-Hermitian (F[i, j] =
    conj(F[2Lg-i, 2Lg-j])), so after zero-padding to M and rolling the
    zero frequency to index 0 the grid is wrapped-Hermitian and its DFT
    is real: samples = M^2 * irfft2(conj(wrapped)[..., :L+1]) -- one
    real FFT instead of a complex one (reference:
    sevenn/nn/gaunt_util.py:279-313, convolution.py:261-403).  M is odd,
    and ``s=(M, M)`` is always passed: without it irfft2 takes an even
    last length."""
    M = 2 * L + 1
    n = grid.shape[-1]
    padded = torch.nn.functional.pad(grid, (0, M - n, 0, M - n))
    wrapped = torch.roll(padded, (-Lg, -Lg), dims=(-2, -1))
    half = torch.conj(wrapped)[..., :, :L + 1]
    return (M * M) * torch.fft.irfft2(half, s=(M, M))


def _coeffs_from_real_samples(S: torch.Tensor, L: int) -> torch.Tensor:
    """Real product samples [..., M, M] -> centered convolution
    coefficient grid [..., M, M] (complex), via one rfft2 + Hermitian
    reconstruction of the missing half."""
    M = 2 * L + 1
    F = torch.fft.rfft2(S)                     # [..., M, L+1]
    left = torch.conj(F) / (M * M)
    rows_rev = torch.roll(torch.flip(F, dims=(-2,)), 1, dims=-2)
    right = torch.flip(rows_rev[..., :, 1:L + 1], dims=(-1,)) / (M * M)
    G = torch.cat([left, right], dim=-1)
    return torch.roll(G, (L, L), dims=(-2, -1))


def gaunt_product_grids(a: torch.Tensor, b: torch.Tensor, La: int, Lb: int
                        ) -> torch.Tensor:
    """2D convolution of coefficient grids via FFT: inputs
    [..., 2La+1, 2La+1] and [..., 2Lb+1, 2Lb+1] -> [..., 2L+1, 2L+1]
    (L = La + Lb)."""
    L = La + Lb
    size = (2 * L + 1, 2 * L + 1)
    fa = torch.fft.fft2(a, s=size)
    fb = torch.fft.fft2(b, s=size)
    # inputs indexed from u=-La at 0: convolution support starts at
    # -(La+Lb) at index 0 -- already centered for a (2L+1) grid
    return torch.fft.ifft2(fa * fb)


# ---------------------------------------------------------------------------
# Gaunt convolution (the message function)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class GauntConvSpec:
    irreps_x: Irreps           # uniform mul, sph-like, sorted/simplified
    irreps_filter: Irreps      # mul-1 SH
    irreps_out: Irreps
    radial_hs: Tuple[int, ...]
    act_radial: str

    @property
    def mul(self) -> int:
        return self.irreps_x[0].mul

    @property
    def L_x(self) -> int:
        return self.irreps_x.lmax

    @property
    def L_f(self) -> int:
        return self.irreps_filter.lmax

    @property
    def L_out(self) -> int:
        return self.irreps_out.lmax

    @property
    def weight_numel(self) -> int:
        return self.mul * len(self.irreps_out)


def gaunt_conv_spec(
    irreps_x: Irreps,
    irreps_filter: Irreps,
    irreps_out: Irreps,
    radial_hidden: Tuple[int, ...],
    bessel_num: int,
    act_radial: str,
) -> GauntConvSpec:
    irreps_x = Irreps(irreps_x)
    irreps_out = Irreps(irreps_out)
    mul = irreps_x[0].mul
    assert all(mi.mul == mul for mi in irreps_x)
    assert all(mi.mul == mul for mi in irreps_out)
    assert all(mi.mul == 1 for mi in irreps_filter)
    for irr in (irreps_x, irreps_out):
        if len(irr) != irr.lmax + 1:
            raise ValueError(
                f'gaunt ops need contiguous l coverage 0..lmax, got {irr!r}'
                ' (is_parity: true is required so odd-l irreps survive the'
                " 'sph' parity filter)"
            )
    return GauntConvSpec(
        irreps_x, Irreps(irreps_filter), irreps_out,
        radial_hs=(bessel_num,) + tuple(radial_hidden),
        act_radial=act_radial,
    )


@lru_cache(maxsize=None)
def _aligned_path_weights(spec: GauntConvSpec) -> np.ndarray:
    """a_w with e3nn path weights sqrt(2l+1) and the Gaunt/CGTP ratio
    folded in (reference: sevenn/nn/convolution.py:184-194)."""
    a_w = weight_align_matrix(spec.L_out)
    path_w = np.array(
        [np.sqrt(mi.ir.dim) for mi in spec.irreps_out], np.float32
    )
    path_w = path_w * fit_gaunt_to_w3j(spec.L_x, spec.L_f)[:spec.L_out + 1]
    return (a_w.T * path_w).T  # (L_out+1, (L_out+1)^2)


def _gather_src(values: torch.Tensor, edge_src, src_perm, src_inv):
    """values[edge_src] of a real or complex [N, ...] tensor through
    ``gather_rows`` (a complex tensor as its real view), so that the
    backward's scatter is the sorted segment sum."""
    cplx = values.is_complex()
    flat = torch.view_as_real(values) if cplx else values
    shape = flat.shape[1:]
    got = gather_rows(flat.reshape(flat.shape[0], -1), edge_src, src_perm,
                      src_inv).reshape((-1,) + shape)
    return torch.view_as_complex(got) if cplx else got


# ---------------------------------------------------------------------------
# the coupling table: the FFT formulation as (k, i, j, c) couplings
# ---------------------------------------------------------------------------

def _fft_products(spec: GauntConvSpec, x_stride, edge_attr, gather, rfft):
    """The FFT formulation's per-edge product, before the radial weights:
    node features ``x_stride`` [N, mul, d_x] (strided), harmonics
    ``edge_attr`` [E, d_f]; ``gather`` takes a per-node grid [N, ...] to
    its edges.  Returns [E, mul, d_out]."""
    L = spec.L_x + spec.L_f
    size = (2 * L + 1, 2 * L + 1)
    x_four = to_fourier(x_stride, spec.L_x)            # [N, mul, u, v]
    filt_four = to_fourier(edge_attr[:, None, :], spec.L_f)  # [E,1,u,v]
    if rfft:
        # Hermitian fast path: both operands are coefficient grids of
        # REAL spherical functions, so the pointwise product happens on
        # REAL sample grids (two irfft2 + one rfft2 instead of three
        # complex FFTs, and a real-valued product)
        s_x = _real_samples(x_four, spec.L_x, L)
        s_f = _real_samples(filt_four, spec.L_f, L)
        conv = _coeffs_from_real_samples(gather(s_x) * s_f, L)
    else:
        x_fft = torch.fft.fft2(x_four, s=size)
        filt_fft = torch.fft.fft2(filt_four, s=size)
        conv = torch.fft.ifft2(gather(x_fft) * filt_fft)
    return to_spherical(conv, L, spec.L_out)           # [E, mul, d_out]


@lru_cache(maxsize=None)
def _coupling(spec: GauntConvSpec):
    """(the ``CGLayout`` of ``gaunt_layout``, the output irrep of each of
    its paths in path order)."""
    x = torch.eye((spec.L_x + 1) ** 2, dtype=torch.float64)[:, None, :]
    f = torch.eye((spec.L_f + 1) ** 2, dtype=torch.float64)
    # unit features against unit harmonics: T[i, j, k], every product of
    # the complex-FFT formulation at once (an "edge" for each (i, j))
    T = _fft_products(spec, x, f, lambda v: v[:, None],
                      rfft=False)[:, :, 0].numpy()
    C = T * _aligned_path_weights(spec).astype(np.float64).sum(0)
    tol = 1e-12 * np.abs(C).max()

    def comps(irreps):
        ends = np.cumsum([mi.ir.dim for mi in irreps])
        return [slice(e - mi.ir.dim, e) for mi, e in zip(irreps, ends)]

    mul = spec.mul
    groups, outs, msg_off = [], [], 0
    for mx, sx, cx in zip(spec.irreps_x, spec.irreps_x.slices(),
                          comps(spec.irreps_x)):
        for mf, sf, cf in zip(spec.irreps_filter,
                              spec.irreps_filter.slices(),
                              comps(spec.irreps_filter)):
            paths = []
            for c, (mo, co) in enumerate(zip(spec.irreps_out,
                                             comps(spec.irreps_out))):
                blk = C[cx, cf, co]
                nnz = tuple((k, i, j, float(blk[i, j, k]))
                            for i in range(mx.ir.dim)
                            for j in range(mf.ir.dim)
                            for k in range(mo.ir.dim)
                            if abs(blk[i, j, k]) > tol)
                if nnz:
                    paths.append(CGPath(msg_off=msg_off, d_out=mo.ir.dim,
                                        w_off=len(outs) * mul, nnz=nnz))
                    outs.append(c)
                    msg_off += mo.ir.dim * mul
            if paths:
                groups.append(CGGroup(x_off=sx.start, d1=mx.ir.dim, mul=mul,
                                      sh_off=sf.start, d2=mf.ir.dim,
                                      paths=tuple(paths)))
    layout = CGLayout(dim_x=spec.irreps_x.dim, dim_sh=spec.irreps_filter.dim,
                      dim_w=len(outs) * mul, dim_msg=msg_off,
                      groups=tuple(groups))
    return layout, tuple(outs)


def gaunt_layout(spec: GauntConvSpec) -> CGLayout:
    """The Gaunt convolution as a uvu coupling layout (the stride layout
    of ``ops/fused_conv``): the complex-FFT formulation evaluated in
    float64 on unit inputs (``fit_gaunt_to_w3j`` included, as that path
    has it), times ``_aligned_path_weights``, its entries above 1e-12 of
    the largest kept.  A group per (feature irrep, harmonic irrep), a path
    per output irrep it reaches, each path its own [mul] weight slice (in
    path order) and its own [d_out, mul] message chunk; the paths into
    one output irrep are summed at the nodes."""
    return _coupling(spec)[0]


def _path_mlp(spec: GauntConvSpec, outs, weights):
    """The radial MLP's weights with the last layer's columns taken per
    path (``outs``: each path's output irrep): path p's weight of channel
    u is column (u, outs[p]) of the spec's per-(channel, l_out) output,
    so the MLP gives the layout's [E, n_path * mul] weights and autograd
    sums the paths' cotangents back into the shared columns."""
    *hidden, last = weights
    per_l = last.reshape(last.shape[0], spec.mul, len(spec.irreps_out))
    return [*hidden, torch.cat([per_l[:, :, c] for c in outs], dim=1)]


def _paths_to_e3nn(spec: GauntConvSpec, outs, agg: torch.Tensor
                   ) -> torch.Tensor:
    """Node sums [N, dim_msg] (a [d_out, mul] chunk a path, ``outs`` each
    path's output irrep) -> flat e3nn features of ``spec.irreps_out``:
    each output irrep the sum of its paths' chunks, in path order."""
    n = agg.shape[0]
    chunks = [[] for _ in spec.irreps_out]
    off = 0
    for c in outs:
        d = spec.irreps_out[c].dim
        chunks[c].append(agg[:, off:off + d])
        off += d
    parts = []
    for ch, mi in zip(chunks, spec.irreps_out):
        if not ch:
            parts.append(agg.new_zeros((n, mi.dim)))
            continue
        summed = reduce(operator.add, ch)
        parts.append(summed.reshape(n, mi.ir.dim, mi.mul).transpose(1, 2)
                     .reshape(n, mi.dim))
    return torch.cat(parts, dim=1)


# ---------------------------------------------------------------------------
# the convolution
# ---------------------------------------------------------------------------

@lru_cache(maxsize=None)
def gaunt_family(spec: GauntConvSpec) -> ConvFamily:
    """The Gaunt convolution for ``convolve``: ``gaunt_layout``, the radial
    MLP's last-layer columns taken per path (``_path_mlp``), each output
    irrep the sum of its paths (``_paths_to_e3nn``), in the span
    ``gaunt.conv`` (``mul``, ``M``: the FFT formulation's grid side)."""
    layout, outs = _coupling(spec)
    M = 2 * (spec.L_x + spec.L_f) + 1
    return ConvFamily(layout, spec.act_radial, partial(_path_mlp, spec, outs),
                      partial(_paths_to_e3nn, spec, outs),
                      ('gaunt.conv', dict(mul=spec.mul, M=M)))


def apply_gaunt_conv(
    spec: GauntConvSpec,
    weight_nn_params,
    x_flat: torch.Tensor,
    edge_attr: torch.Tensor,
    emb: torch.Tensor,
    edge_src: torch.Tensor,
    edge_dst: torch.Tensor,
    n_node: int,
    denominator: torch.Tensor,
    sorted_dst: bool = False,
    src_perm=None,
    src_inv=None,
    dst_sort=None,
) -> torch.Tensor:
    """Messages by pointwise product on the sphere, contracted through
    ``gaunt_layout(spec)``: the model's convolution (``convolve`` over
    ``gaunt_family(spec)``, inside the span ``gaunt.conv`` with ``edges``,
    ``mul`` and ``M``) on flat e3nn node features; returns flat node
    features of ``spec.irreps_out``.  ``sorted_dst``: ``edge_dst`` is
    ascending.  The port-only arguments: ``src_perm`` / ``src_inv``
    (collate's EDGE_SRC_PERM and its inverse; the stable sort of
    ``edge_src`` is taken when not given) and, for an unsorted
    ``edge_dst``, ``dst_sort`` (its ``scatter.sort_perm``, taken once per
    call when not given)."""
    edges = dict(src=edge_src, dst=edge_dst, emb=emb, sh=edge_attr,
                 perm=src_perm, inv=src_inv,
                 dst_sort=None if sorted_dst else dst_sort or (None, None))
    return convolve(gaunt_family(spec), weight_nn_params,
                    [(e3nn_to_stride(spec.irreps_x, x_flat), edges)], n_node,
                    denominator)


def gaunt_conv_fft(
    spec: GauntConvSpec,
    weight_nn_params,
    x_flat: torch.Tensor,
    edge_attr: torch.Tensor,
    emb: torch.Tensor,
    edge_src: torch.Tensor,
    edge_dst: torch.Tensor,
    n_node: int,
    denominator: torch.Tensor,
    sorted_dst: bool = False,
    rfft: bool = True,
    src_perm=None,
    src_inv=None,
    dst_sort=None,
) -> torch.Tensor:
    """``apply_gaunt_conv`` by the FFT formulation: per-edge products of
    torus sample grids, the source of ``gaunt_layout`` and the reference
    the coupling path is held against.  ``rfft``: its Hermitian variant
    (True) or the complex one (False).

    Inside the span ``gaunt.conv`` (``edges``, ``mul``, ``M``); the
    counter ``gaunt.grid_bytes`` adds the bytes of one per-edge sample
    grid, E x mul x M^2 elements."""
    M = 2 * (spec.L_x + spec.L_f) + 1
    E = edge_src.shape[0]
    tracing.count('gaunt.grid_bytes', E * spec.mul * M * M
                  * x_flat.element_size())
    with tracing.span('gaunt.conv', edges=E, mul=spec.mul, M=M):
        return _gaunt_conv(spec, weight_nn_params, x_flat, edge_attr, emb,
                           edge_src, edge_dst, n_node, denominator,
                           sorted_dst, rfft, src_perm, src_inv, dst_sort)


def _gaunt_conv(spec, weight_nn_params, x_flat, edge_attr, emb, edge_src,
                edge_dst, n_node, denominator, sorted_dst, rfft, src_perm,
                src_inv, dst_sort):
    x_stride = flat_to_stride(x_flat, spec.irreps_x)   # [N, mul, d]
    msg_stride = _fft_products(
        spec, x_stride, edge_attr,
        lambda v: _gather_src(v, edge_src, src_perm, src_inv),
        rfft)                                          # [E, mul, d_out]

    w = mlp_apply(weight_nn_params, emb, spec.act_radial)
    w = w.reshape(w.shape[:-1] + (spec.mul, len(spec.irreps_out)))
    a_w = _on((spec,), _aligned_path_weights, x_flat.dtype, x_flat.device)
    msg_stride = msg_stride * torch.einsum('...ul,li->...ui', w, a_w)

    # the strided [E, mul, d] layout folds to [E, mul*d] for the sorted
    # segment sum and unfolds after
    E, mul, d_out = msg_stride.shape
    perm, inv = (None, None) if dst_sort is None else dst_sort
    agg = aggregate_messages(
        msg_stride.reshape(E, mul * d_out), edge_dst, n_node, sorted_dst,
        perm, inv).reshape(n_node, mul, d_out)
    agg = agg / denominator
    return stride_to_flat(agg, spec.irreps_out)


# ---------------------------------------------------------------------------
# Gaunt product basis (self tensor power)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class GauntProductBasisSpec:
    irreps_x: Irreps
    irreps_out: Irreps
    correlation: int
    with_weight: bool = True

    @property
    def mul(self) -> int:
        return self.irreps_x[0].mul

    @property
    def L_x(self) -> int:
        return self.irreps_x.lmax

    @property
    def L_true(self) -> int:
        return self.correlation * self.L_x


def gaunt_pb_spec(irreps_x: Irreps, irreps_out: Irreps, correlation: int,
                  with_weight: bool = True) -> GauntProductBasisSpec:
    irreps_x = Irreps(irreps_x)
    irreps_out = Irreps(irreps_out)
    mul = irreps_x[0].mul
    assert all(mi.mul == mul for mi in irreps_x)
    assert all(mi.mul == mul for mi in irreps_out)
    assert irreps_out.lmax <= correlation * irreps_x.lmax
    return GauntProductBasisSpec(irreps_x, irreps_out, correlation,
                                 with_weight)


def init_gaunt_pb(spec: GauntProductBasisSpec, rng: np.random.Generator):
    if not spec.with_weight:
        return {}
    return {
        f'w{i}': rng.standard_normal(
            (spec.mul, spec.L_x + 1)
        ).astype(np.float32)
        for i in range(spec.correlation)
    }


def gaunt_pb_shapes(spec: GauntProductBasisSpec):
    """Name -> shape of ``init_gaunt_pb``'s weights."""
    if not spec.with_weight:
        return {}
    return {f'w{i}': (spec.mul, spec.L_x + 1)
            for i in range(spec.correlation)}


@lru_cache(maxsize=None)
def _pb_path_weights(spec: GauntProductBasisSpec) -> np.ndarray:
    """Per-component path weights: sqrt(2l+1) x accumulated Gaunt ratios
    (reference: sevenn/nn/gaunt_product_basis.py:57-75)."""
    L_out = spec.irreps_out.lmax
    path_w = np.array(
        [np.sqrt(mi.ir.dim) for mi in spec.irreps_out], np.float64
    )
    ratio = np.ones(L_out + 1)
    base_l = spec.L_x
    for _ in range(spec.correlation - 1):
        r = fit_gaunt_to_w3j(base_l, spec.L_x)
        n = min(len(r), len(ratio))
        ratio[:n] *= r[:n]
        base_l += spec.L_x
    path_w = path_w * ratio
    idx = [l for l in range(L_out + 1) for _ in range(2 * l + 1)]
    return path_w[idx].astype(np.float32)


def apply_gaunt_pb(
    spec: GauntProductBasisSpec,
    params,
    x_flat: torch.Tensor,
) -> torch.Tensor:
    """x -> sum_v (weighted x)^(x v), Fourier-accumulated then projected
    (reference: sevenn/nn/gaunt_product_basis.py:84-129), inside the span
    ``gaunt.pb`` (``nodes``, ``correlation``)."""
    with tracing.span('gaunt.pb', nodes=x_flat.shape[0],
                      correlation=spec.correlation):
        return _gaunt_pb(spec, params, x_flat)


def _gaunt_pb(spec, params, x_flat):
    L_x, L_out = spec.L_x, spec.L_true
    n = 2 * L_out + 1
    size = (n, n)
    a_w = _on((L_x,), weight_align_matrix, x_flat.dtype, x_flat.device)

    x_stride = flat_to_stride(x_flat, spec.irreps_x)

    def weighted(i):
        if not spec.with_weight:
            return x_stride
        w = params[f'w{i}'].to(x_flat.dtype)
        return x_stride * torch.einsum('ul,li->ui', w, a_w)

    def placed(grid, c):
        # grid [..., r, r] added at [c:c+r, c:c+r] of an n x n grid
        r = grid.shape[-1]
        return torch.nn.functional.pad(grid, (c, n - c - r, c, n - c - r))

    x0_four = to_fourier(weighted(0), L_x)
    base = torch.fft.fft2(x0_four, s=size)
    out = placed(x0_four, L_out - L_x)

    for i, v in enumerate(range(2, spec.correlation + 1)):
        r = 2 * L_x * v + 1
        xv = torch.fft.fft2(to_fourier(weighted(i + 1), L_x), s=size)
        base = base * xv
        out = out + placed(torch.fft.ifft2(base)[..., :r, :r],
                           L_out - L_x * v)

    y = to_spherical(out, L_out, spec.irreps_out.lmax)
    y = y * _on((spec,), _pb_path_weights, x_flat.dtype, x_flat.device)
    return stride_to_flat(y, spec.irreps_out)
