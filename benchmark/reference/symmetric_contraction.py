"""MACE-style symmetric contraction (higher-order product basis).

Frozen copy of the port's plain ``ops/symmetric_contraction.py`` for the
benchmark's reference, which imports nothing of the program (that module
is a port of the JAX package's ``ops/symmetric_contraction.py``) (MACE,
Batatia et al., arXiv:2206.07697, Eq. 10-11; reference:
sevenn/nn/equivariant_product_basis.py:43-327): node features x in a
strided layout [batch, channel, dim] are raised to the correlation-nu
tensor power and contracted against precomputed symmetrized coupling
bases (U tensors) with per-element weights, via the Horner-like
recursion over nu.

The U tensors are built on the host in float64 numpy from the package's
Wigner-3j tables (component normalization: each coupling step scales by
sqrt(2l_out+1)), cached per (coupling, output irrep, nu), and copied to a
device once per (dtype, device).  The contractions are ``torch.einsum``
in the JAX module's order; the JAX package computes them outside any
Pallas kernel too.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache
from typing import List, Tuple

import numpy as np
import torch

from .irreps import Irrep, Irreps
from .wigner import wigner_3j


@lru_cache(maxsize=None)
def _wigner_nj(coupling: Irreps, nu: int) -> Tuple[Tuple[Irrep, np.ndarray],
                                                   ...]:
    """All couplings of nu copies of the (mul-1) coupling irreps:
    [(ir_out, C[dim_out, d, d, ..., d])] with component normalization."""
    d = coupling.dim
    if nu == 1:
        out = []
        e = np.eye(d)
        i = 0
        for mi in coupling:
            assert mi.mul == 1, 'coupling irreps must have multiplicity 1'
            ir = mi.ir
            out.append((ir, e[i:i + ir.dim].reshape(ir.dim, d)))
            i += ir.dim
        return tuple(out)

    prev = _wigner_nj(coupling, nu - 1)
    ret: List[Tuple[Irrep, np.ndarray]] = []
    for ir_left, C_left in prev:
        i = 0
        for mi in coupling:
            ir = mi.ir
            for ir_out in ir_left * ir:
                C = wigner_3j(ir_out.l, ir_left.l, ir.l).copy()
                C *= np.sqrt(ir_out.dim)  # component normalization
                # couple: C[k, j, l] x C_left[j, d^(nu-1)]
                C2 = np.einsum(
                    'kjl,jm->kml', C, C_left.reshape(ir_left.dim, -1)
                ).reshape((ir_out.dim,) + (d,) * (nu - 1) + (ir.dim,))
                E = np.zeros((ir_out.dim,) + (d,) * nu)
                E[..., i:i + ir.dim] = C2
                ret.append((ir_out, E))
            i += ir.dim
    return tuple(sorted(ret, key=lambda t: t[0]._key()))


@lru_cache(maxsize=None)
def u_matrix(coupling: Irreps, ir_out: Irrep, nu: int) -> np.ndarray:
    """Stack of coupling paths: shape (dim_out, d, ..., d [nu], n_paths);
    the leading axis is dropped for scalar outputs (reference squeeze)."""
    paths = [
        C for ir, C in _wigner_nj(coupling, nu) if ir == ir_out
    ]
    if not paths:
        shape = (ir_out.dim,) + (coupling.dim,) * nu + (0,)
        U = np.zeros(shape)
    else:
        U = np.stack(paths, axis=-1)
    if ir_out.l == 0:
        U = U[0]
    return np.ascontiguousarray(U, dtype=np.float64)


@lru_cache(maxsize=None)
def _u_tensor(coupling: Irreps, ir_out: Irrep, nu: int, dtype: torch.dtype,
              device: torch.device) -> torch.Tensor:
    """``u_matrix`` as a tensor of ``dtype`` on ``device``, copied once."""
    return torch.as_tensor(u_matrix(coupling, ir_out, nu), dtype=dtype,
                           device=device)


# index letters for the nu tensor-power axes (disjoint from b/c/k/e/M)
_AX = 'wxvnzrtyuops'


@dataclass(frozen=True)
class SymContractionSpec:
    """One Contraction per output irrep entry (shared channel count)."""

    irreps_in: Irreps          # strided features: all muls equal
    irreps_out: Irreps
    correlation: int
    num_elements: int

    @property
    def num_features(self) -> int:
        return self.irreps_in[0].mul

    @property
    def coupling(self) -> Irreps:
        return Irreps([(1, mi.ir) for mi in self.irreps_in])


def sym_contraction_spec(
    irreps_in: Irreps,
    irreps_out: Irreps,
    correlation: int,
    num_elements: int,
) -> SymContractionSpec:
    irreps_in = Irreps(irreps_in)
    mul = irreps_in[0].mul
    assert all(mi.mul == mul for mi in irreps_in), (
        'symmetric contraction expects uniform multiplicity'
    )
    return SymContractionSpec(irreps_in, Irreps(irreps_out), correlation,
                              num_elements)


def init_sym_contraction(spec: SymContractionSpec,
                         rng: np.random.Generator):
    """Weights per output irrep and per nu: [num_elements, n_paths, C],
    init randn/n_paths, drawn as the JAX package draws them (reference:
    equivariant_product_basis.py:244-301)."""
    params = {}
    for oi, mo in enumerate(spec.irreps_out):
        for nu in range(1, spec.correlation + 1):
            U = u_matrix(spec.coupling, mo.ir, nu)
            k = U.shape[-1]
            params[f'o{oi}_nu{nu}'] = (
                rng.standard_normal(
                    (spec.num_elements, k, spec.num_features)
                ) / max(k, 1)
            ).astype(np.float32)
    return params


def sym_contraction_shapes(spec: SymContractionSpec):
    """Name -> shape of ``init_sym_contraction``'s weights."""
    return {f'o{oi}_nu{nu}': (spec.num_elements,
                              u_matrix(spec.coupling, mo.ir, nu).shape[-1],
                              spec.num_features)
            for oi, mo in enumerate(spec.irreps_out)
            for nu in range(1, spec.correlation + 1)}


def apply_sym_contraction(
    spec: SymContractionSpec,
    params,
    x_flat: torch.Tensor,
    node_attr: torch.Tensor,
) -> torch.Tensor:
    """x_flat: [..., irreps_in.dim] (flat [mul, m] blocks);
    node_attr: [..., num_elements] one-hot.  Returns [..., irreps_out.dim].

    Each three-operand product of the JAX module is taken here as two
    einsums, the weights with x first, so that no intermediate spans the
    whole U tensor times the batch."""
    dtype, device = x_flat.dtype, x_flat.device
    C = spec.num_features
    # flat -> strided [batch, C, d]
    blocks = []
    offset = 0
    for mi in spec.irreps_in:
        b = x_flat[..., offset:offset + mi.dim].reshape(
            x_flat.shape[:-1] + (C, mi.ir.dim)
        )
        blocks.append(b)
        offset += mi.dim
    x = torch.cat(blocks, dim=-1)  # [..., C, d]

    outs = []
    for oi, mo in enumerate(spec.irreps_out):
        nu_max = spec.correlation
        m_ax = 'M' if mo.ir.l > 0 else ''

        # per-element weights -> per-node: W[b, k, c]
        def wnode(nu):
            w = params[f'o{oi}_nu{nu}'].to(dtype)
            return torch.einsum('be,ekc->bkc', node_attr, w)

        def u(nu):
            return _u_tensor(spec.coupling, mo.ir, nu, dtype, device)

        # main term (nu = nu_max):
        # U[(M), i1..inu, k] W[b,k,c] x[b,c,i_nu] -> [b, c, (M), i1..i_{nu-1}]
        idx = _AX[:nu_max]                      # i1..inu
        wx = torch.einsum(f'bkc,bc{idx[-1]}->bc{idx[-1]}k', wnode(nu_max), x)
        out = torch.einsum(f'{m_ax}{idx}k,bc{idx[-1]}k->bc{m_ax}{idx[:-1]}',
                           u(nu_max), wx)
        for nu in range(nu_max - 1, 0, -1):
            idx = _AX[:nu]
            c_tensor = torch.einsum(
                f'{m_ax}{idx}k,bkc->bc{m_ax}{idx}', u(nu), wnode(nu))
            c_tensor = c_tensor + out
            out = torch.einsum(
                f'bc{m_ax}{idx},bc{idx[-1]}->bc{m_ax}{idx[:-1]}',
                c_tensor, x)
        # out: [b, c] or [b, c, M] -> flat [b, c*dim_out]
        outs.append(out.reshape(out.shape[0], -1))
    return torch.cat(outs, dim=-1)
