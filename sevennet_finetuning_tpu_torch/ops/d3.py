"""Grimme DFT-D3 dispersion correction (PyTorch, autograd forces/stress).

Port of ``sevennet_finetuning_tpu/ops/d3.py`` (Grimme et al., J. Chem.
Phys. 132, 154104 (2010); BJ damping: Grimme et al., J. Comput. Chem.
32, 1456 (2011)).  The energy is one function of the edge vectors, and
forces and stress come from ``torch.autograd.grad`` -- the
coordination-number and C6-interpolation gradients included.  The JAX
version is plain XLA with no Pallas kernel, so this one is plain PyTorch
on the caller's device, except that its sums over edges into atoms (the
coordination number over i, the force reduces over i and j, and the
backward of every gather by i or j) run on the sorted segment sum of
``ops/scatter`` (the ``segment_sum`` kernel on the card), in a fixed
order, never through ``index_add_`` atomics.

Reference data (covalent radii, <r2>/<r4>, R0AB, C6AB reference systems)
are Grimme's published dftd3 tables: the package's own copy of
``data/d3_params.npz``.  Every table is float32 here (the JAX package
keeps ``rcov`` in float64 when ``jax_enable_x64`` is on).
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from .scatter import gather_rows, scatter_rows, sort_perm

K1 = 16.0
K3 = -4.0
AU_TO_ANG = 0.52917726
HARTREE_TO_EV = 27.21138505
MAXC = 5

_TABLES = None

# (rs6, s18, rs18[, s6]) -- Grimme's published parametrizations
ZERO_DAMPING_PARAMS: Dict[str, Tuple[float, ...]] = {
    'b-lyp': (1.094, 1.682, 1.0),
    'b-p': (1.139, 1.683, 1.0),
    'b97-d': (0.892, 0.909, 1.0),
    'revpbe': (0.923, 1.010, 1.0),
    'pbe': (1.217, 0.722, 1.0),
    'pbesol': (1.345, 0.612, 1.0),
    'rpbe': (0.872, 0.514, 1.0),
    'tpss': (1.166, 1.105, 1.0),
    'b3-lyp': (1.261, 1.703, 1.0),
    'pbe0': (1.287, 0.928, 1.0),
    'hse06': (1.129, 0.109, 1.0),
    'scan': (1.324, 0.0, 1.0),
}

BJ_DAMPING_PARAMS: Dict[str, Tuple[float, float, float]] = {
    # a1 (rs6), s8 (s18), a2 (rs18)
    'b-p': (0.3946, 3.2822, 4.8516),
    'b-lyp': (0.4298, 2.6996, 4.2359),
    'revpbe': (0.5238, 2.3550, 3.5016),
    'rpbe': (0.1820, 0.8318, 4.0094),
    'b97-d': (0.5545, 2.2609, 3.2297),
    'pbe': (0.4289, 0.7875, 4.4407),
    'rpw86-pbe': (0.4613, 1.3845, 4.5062),
    'b3-lyp': (0.3981, 1.9889, 4.4211),
    'tpss': (0.4535, 1.9435, 4.4752),
    'hf': (0.3385, 0.9171, 2.8830),
    'tpss0': (0.3768, 1.2576, 4.5865),
    'pbe0': (0.4145, 1.2177, 4.8593),
    'hse06': (0.383, 2.310, 5.685),
    'pbesol': (0.4466, 2.9491, 6.1742),
    'scan': (0.538, 0.0, 5.42),
}


def _load_tables():
    global _TABLES
    if _TABLES is None:
        path = os.path.join(
            os.path.dirname(os.path.dirname(__file__)), 'data',
            'd3_params.npz',
        )
        _TABLES = dict(np.load(path))
    return _TABLES


@dataclass(frozen=True)
class D3Spec:
    """Static per-species D3 data (built once per species set)."""

    zs: Tuple[int, ...]                  # atomic numbers per type index
    damping: str                         # 'zero' | 'bj'
    s6: float
    s18: float
    rs6: float
    rs18: float
    alp: float = 14.0
    cutoff: float = 50.2                 # Bohr, pair cutoff (sqrt(rthr))
    cn_cutoff: float = 21.2              # Bohr, coordination cutoff


def d3_spec(
    atomic_numbers,
    functional: str = 'pbe',
    damping: str = 'bj',
    params: Optional[Tuple[float, ...]] = None,
    cutoff: float = 50.2,
    cn_cutoff: float = 21.2,
) -> D3Spec:
    if params is not None:
        rs6, s18, rs18 = params[:3]
        s6 = params[3] if len(params) > 3 else 1.0
    elif damping == 'zero':
        rs6, s18, rs18 = ZERO_DAMPING_PARAMS[functional]
        s6 = 1.0
    elif damping == 'bj':
        rs6, s18, rs18 = BJ_DAMPING_PARAMS[functional]
        s6 = 1.0
    else:
        raise ValueError(damping)
    return D3Spec(
        zs=tuple(int(z) for z in atomic_numbers),
        damping=damping, s6=s6, s18=s18, rs6=rs6, rs18=rs18,
        cutoff=cutoff, cn_cutoff=cn_cutoff,
    )


def d3_static_arrays(spec: D3Spec, device=None) -> Dict[str, torch.Tensor]:
    """Per-type constant tables (float32 tensors on ``device``)."""
    t = _load_tables()
    zs = np.array(spec.zs)
    n = len(zs)
    rcov = t['rcov'][zs - 1]
    r2r4 = t['r2r4'][zs - 1]
    # the R0AB table is in Angstrom; every distance in the energy is in
    # Bohr, so convert at load exactly like the reference
    # (pair_d3.cu:359: r0ab_table[...] / AU_TO_ANG)
    r0ab = t['r0ab'][np.ix_(zs - 1, zs - 1)] / AU_TO_ANG

    # c6ab reference grids per species pair
    c6ref = np.full((n, n, MAXC, MAXC), -1.0)
    cn1ref = np.zeros((n, n, MAXC, MAXC))
    cn2ref = np.zeros((n, n, MAXC, MAXC))
    table = t['c6ab']
    # the grid position is packed into the z columns: column value =
    # z + 100 * (grid_index - 1) (reference:
    # sevenn/pair_e3gnn/pair_d3.cu:369-383, 389-416)
    for row in table:
        c6, z1p, z2p, cn1, cn2 = row
        z1p, z2p = int(z1p), int(z2p)
        gi, z1 = (z1p - 1) // 100 + 1, (z1p - 1) % 100 + 1
        gj, z2 = (z2p - 1) // 100 + 1, (z2p - 1) % 100 + 1
        i1 = np.where(zs == z1)[0]
        i2 = np.where(zs == z2)[0]
        if len(i1) == 0 or len(i2) == 0:
            continue
        for a in i1:
            for b in i2:
                c6ref[a, b, gi - 1, gj - 1] = c6
                cn1ref[a, b, gi - 1, gj - 1] = cn1
                cn2ref[a, b, gi - 1, gj - 1] = cn2
                c6ref[b, a, gj - 1, gi - 1] = c6
                cn1ref[b, a, gj - 1, gi - 1] = cn2
                cn2ref[b, a, gj - 1, gi - 1] = cn1
    arrays = dict(rcov=rcov, r2r4=r2r4, r0ab=r0ab, c6ref=c6ref,
                  cn1ref=cn1ref, cn2ref=cn2ref)
    return {k: torch.as_tensor(np.asarray(v, np.float32), device=device)
            for k, v in arrays.items()}


def edge_sorts(edge_idx: torch.Tensor):
    """((perm_i, inv_i), (perm_j, inv_j)): the stable sorts of both ends
    of the edges (``scatter.sort_perm``), which every gather and scatter
    by i or j uses.  A caller that evaluates one edge list many times
    (the MD segment) builds them once."""
    return sort_perm(edge_idx[0]), sort_perm(edge_idx[1])


def d3_energy(
    spec: D3Spec,
    arrays,
    pos_ang: torch.Tensor,          # [N, 3] Angstrom
    types: torch.Tensor,            # [N] species index
    edge_idx: torch.Tensor,         # [2, E] directed pairs (both ways)
    edge_shift: torch.Tensor,       # [E, 3]
    cell_ang: torch.Tensor,         # [3, 3]
    edge_mask: torch.Tensor,        # [E]
    node_mask: torch.Tensor,        # [N]
    sorts=None,
) -> torch.Tensor:
    """Total D3 dispersion energy in eV.  Differentiable in positions
    (the gathers' backward is the sorted scatter over i and j).

    The edge list must cover the D3 cutoff (spec.cutoff, Bohr) --
    typically much larger than the GNN cutoff.  ``sorts``: the edges'
    ``edge_sorts``, built here when not given."""
    if sorts is None:
        sorts = edge_sorts(edge_idx)
    (pi, ii), (pj, ij) = sorts
    vec = (
        gather_rows(pos_ang, edge_idx[1], pj, ij)
        - gather_rows(pos_ang, edge_idx[0], pi, ii)
        + edge_shift @ cell_ang
    ) / AU_TO_ANG
    return d3_energy_from_vec(spec, arrays, vec, types, edge_idx,
                              edge_mask, sorts)


def d3_energy_from_vec(
    spec: D3Spec,
    arrays,
    vec_bohr: torch.Tensor,         # [E, 3] edge vectors, Bohr
    types: torch.Tensor,
    edge_idx: torch.Tensor,
    edge_mask: torch.Tensor,
    sorts=None,
) -> torch.Tensor:
    if sorts is None:
        sorts = edge_sorts(edge_idx)
    (pi, ii), (pj, ij) = sorts
    i, j = edge_idx[0], edge_idx[1]
    n = types.shape[0]
    vec = vec_bohr
    r2 = torch.sum(vec * vec, dim=-1)
    # clamp at 0.5 Bohr (0.26 A): no physical pair is closer, and the
    # padded zero-vector edges of static MD batches would otherwise
    # overflow c6/r^6 to inf -- inf * 0 mask = NaN in the sum
    r = torch.sqrt(torch.clamp(r2, min=0.25))

    ti, tj = types[i.long()].long(), types[j.long()].long()

    # --- coordination numbers (reference: kernel_get_coordination_number)
    rcov_sum = arrays['rcov'][ti] + arrays['rcov'][tj]
    cn_contrib = 1.0 / (1.0 + torch.exp(-K1 * (rcov_sum / r - 1.0)))
    cn_mask = edge_mask * (r < spec.cn_cutoff).to(r.dtype)
    cn = scatter_rows((cn_contrib * cn_mask)[:, None], i, n, pi, ii)

    # --- C6 interpolation over reference systems
    c6ref = arrays['c6ref'][ti, tj]          # [E, 5, 5]
    cn1ref = arrays['cn1ref'][ti, tj]
    cn2ref = arrays['cn2ref'][ti, tj]
    valid = c6ref > -0.5
    cn_i = gather_rows(cn, i, pi, ii)[:, 0, None, None]
    cn_j = gather_rows(cn, j, pj, ij)[:, 0, None, None]
    dcn = (cn_i - cn1ref) ** 2 + (cn_j - cn2ref) ** 2
    # shift by the min before exponentiating: the Gaussian weights
    # underflow when the actual CN sits far from every reference (Hf in
    # HfO2, CN ~13 against reference CNs <= 3.9) and the naive ratio
    # collapses to c6 = 0.  The shifted form is algebraically identical
    # where the naive one is finite (the common factor cancels in Z/W,
    # gradient included) and tends to the closest reference's C6 where
    # the reference CUDA branches to its c6mem fallback (reference:
    # sevenn/pair_e3gnn/pair_d3.cu:827-884)
    inf = torch.full_like(dcn, float('inf'))
    dcn_min = torch.where(valid, dcn, inf).amin(dim=(1, 2), keepdim=True)
    zero = torch.zeros_like(dcn)
    L = torch.where(valid, torch.exp(K3 * (dcn - dcn_min)), zero)
    Z = torch.sum(L * torch.where(valid, c6ref, zero), dim=(1, 2))
    W = torch.sum(L, dim=(1, 2))
    c6 = Z / torch.clamp(W, min=1e-30)

    r42 = arrays['r2r4'][ti] * arrays['r2r4'][tj]
    c8 = 3.0 * c6 * r42

    if spec.damping == 'zero':
        r0 = arrays['r0ab'][ti, tj]
        f6 = 1.0 / (1.0 + 6.0 * (spec.rs6 * r0 / r) ** spec.alp)
        f8 = 1.0 / (1.0 + 6.0 * (spec.rs18 * r0 / r) ** (spec.alp + 2))
        e_pair = spec.s6 * c6 / r**6 * f6 + spec.s18 * c8 / r**8 * f8
    else:  # Becke-Johnson
        R0 = torch.sqrt(3.0 * r42)     # sqrt(c8/c6)
        damp = spec.rs6 * R0 + spec.rs18
        e_pair = (
            spec.s6 * c6 / (r**6 + damp**6)
            + spec.s18 * c8 / (r**8 + damp**8)
        )

    pair_mask = edge_mask * (r < spec.cutoff).to(r.dtype)
    # directed edges count each pair twice -> factor 1/2
    e_au = -0.5 * torch.sum(e_pair * pair_mask)
    return e_au * HARTREE_TO_EV


def d3_energy_forces_stress(
    spec: D3Spec,
    arrays,
    pos_ang: torch.Tensor,
    types: torch.Tensor,
    edge_idx: torch.Tensor,
    edge_shift: torch.Tensor,
    cell_ang: torch.Tensor,
    edge_mask: torch.Tensor,
    volume_ang3: float,
):
    """(energy eV, forces eV/A [N,3], stress eV/A^3 Voigt [6]), each
    detached."""
    sorts = edge_sorts(edge_idx)
    (pi, ii), (pj, ij) = sorts
    i, j = edge_idx[0], edge_idx[1]
    n = pos_ang.shape[0]
    with torch.no_grad():
        vec_ang = (pos_ang[j.long()] - pos_ang[i.long()]
                   + edge_shift @ cell_ang)
    vec_ang.requires_grad_(True)
    with torch.enable_grad():
        energy = d3_energy_from_vec(spec, arrays, vec_ang / AU_TO_ANG,
                                    types, edge_idx, edge_mask, sorts)
        fij, = torch.autograd.grad(energy, vec_ang)
    vec_ang = vec_ang.detach()
    pf = scatter_rows(fij, i, n, pi, ii)
    nf = scatter_rows(fij, j, n, pj, ij)
    forces = pf - nf
    diag = vec_ang * fij
    voigt = torch.stack([
        torch.sum(diag[:, 0]), torch.sum(diag[:, 1]), torch.sum(diag[:, 2]),
        torch.sum(vec_ang[:, 0] * fij[:, 1]),
        torch.sum(vec_ang[:, 1] * fij[:, 2]),
        torch.sum(vec_ang[:, 2] * fij[:, 0]),
    ])
    stress = -voigt / volume_ang3
    return energy.detach(), forces, stress
