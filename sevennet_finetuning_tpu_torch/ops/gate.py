"""Equivariant gated nonlinearity (e3nn-Gate-compatible).

Port of ``sevennet_finetuning_tpu/ops/gate.py``.  The layer input follows
e3nn's convention: scalars || gates || gated SORTED by irrep (stable) and
simplified; a static permutation regroups it inside the gate.  Scalars
pass through parity-matched normalized activations; the l>0 'gated' part
is multiplied elementwise by activated scalar gates.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Tuple

import numpy as np
import torch

from ..irreps import Irrep, Irreps, MulIrrep
from .activations import get_activation


@dataclass(frozen=True)
class GateSpec:
    irreps_in: Irreps          # sorted+simplified (scalars+gates+gated)
    irreps_out: Irreps         # scalars + gated
    irreps_scalars: Irreps
    irreps_gates: Irreps
    irreps_gated: Irreps
    perm: Tuple[int, ...]      # sorted layout -> group layout indices
    act_scalars: Tuple[Callable, ...]   # one per scalar irrep entry
    act_gates: Tuple[Callable, ...]     # one per gate irrep entry


def gate_spec(
    irreps_x: Irreps,
    act_scalar_by_parity: Dict[str, str],
    act_gate_by_parity: Dict[str, str],
) -> GateSpec:
    """Build the gate for a block whose *output* irreps are ``irreps_x``:
    l>0 -> gated, l=0 -> scalars; gates are 0e if the scalars contain 0e,
    else 0o."""
    irreps_x = Irreps(irreps_x)
    pmap = {'e': 1, 'o': -1}
    acts_s = {pmap[k]: v for k, v in act_scalar_by_parity.items()}
    acts_g = {pmap[k]: v for k, v in act_gate_by_parity.items()}

    scalars = Irreps([mi for mi in irreps_x if mi.ir.l == 0])
    gated = Irreps([mi for mi in irreps_x if mi.ir.l > 0])
    gates_parity = 1 if Irrep(0, 1) in scalars else -1
    gates = Irreps([MulIrrep(mi.mul, Irrep(0, gates_parity)) for mi in gated])

    # e3nn's _Sortcut: input layout is the stable irrep-sort of
    # scalars+gates+gated; record where each group entry lands
    group_entries = list(scalars) + list(gates) + list(gated)
    cat = Irreps(group_entries)
    sorted_irreps, inv, order = cat.sort()
    sorted_offsets = np.cumsum([0] + [mi.dim for mi in sorted_irreps])[:-1]
    perm = []
    for e_idx in range(len(group_entries)):
        off = sorted_offsets[inv[e_idx]]
        perm.extend(range(off, off + group_entries[e_idx].dim))

    act_scalars = tuple(
        get_activation(acts_s[mi.ir.p], normalized=True) for mi in scalars
    )
    act_gates = tuple(
        get_activation(acts_g[mi.ir.p], normalized=True) for mi in gates
    )
    return GateSpec(
        irreps_in=sorted_irreps.simplify(),
        irreps_out=scalars + gated,
        irreps_scalars=scalars,
        irreps_gates=gates,
        irreps_gated=gated,
        perm=tuple(int(p) for p in perm),
        act_scalars=act_scalars,
        act_gates=act_gates,
    )


def apply_gate(spec: GateSpec, x: torch.Tensor) -> torch.Tensor:
    # regroup the sorted input layout into scalars || gates || gated
    perm = np.asarray(spec.perm)
    if not np.array_equal(perm, np.arange(len(perm))):
        x = x[..., torch.as_tensor(perm, device=x.device)]
    d_s = spec.irreps_scalars.dim
    d_g = spec.irreps_gates.dim
    scalars = x[..., :d_s]
    gates = x[..., d_s:d_s + d_g]
    gated = x[..., d_s + d_g:]

    out = []
    for sl, act in zip(spec.irreps_scalars.slices(), spec.act_scalars):
        out.append(act(scalars[..., sl]))

    acted_gates = []
    for sl, act in zip(spec.irreps_gates.slices(), spec.act_gates):
        acted_gates.append(act(gates[..., sl]))

    for mi, sl, g in zip(
        spec.irreps_gated, spec.irreps_gated.slices(), acted_gates
    ):
        v = gated[..., sl].reshape(x.shape[:-1] + (mi.mul, mi.ir.dim))
        v = v * g[..., None]
        out.append(v.reshape(x.shape[:-1] + (mi.dim,)))
    return torch.cat(out, dim=-1)
