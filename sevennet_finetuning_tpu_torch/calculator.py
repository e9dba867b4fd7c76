"""Single-point calculator: structures -> energy / forces / stress.

Port of ``sevennet_finetuning_tpu/calculator.py``: builds a padded graph
per call (bucketed capacities, as the JAX package does) and runs the
model on the calculator's device -- ``cuda`` unless the caller passes
``device='cpu'``.  The model runs with its weights frozen, so autograd
tracks only the edge vectors the forces come from.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from . import keys as K
from . import resolve_device
from .data.vasp import Structure
from .model.graph import bucket_capacity, collate, structure_to_graph
from .model.nequip import (
    ModelSpec,
    NequIP,
    apply_model,
    batch_to_torch,
    load_jax_params,
)

STRESS_COEFF_KBAR = 1602.1766208


class Calculator:
    def __init__(self, spec: ModelSpec, params, device=None,
                 dispersion: Optional[Dict] = None):
        """``params``: the JAX package's parameter dict (numpy arrays)."""
        if dispersion is not None:
            raise NotImplementedError(
                'D3 dispersion is not ported yet (a later slice of the port)')
        self.device = resolve_device(device)
        self.spec = spec
        self.type_map = dict(spec.type_map)
        self.model = load_jax_params(NequIP(spec), params).to(self.device)
        self.model.requires_grad_(False)

    @classmethod
    def from_checkpoint(cls, path: str, device=None) -> 'Calculator':
        from .model.build import build_model_spec
        from .train.checkpoint import load_checkpoint

        device = resolve_device(device)
        blob = load_checkpoint(path)
        config = blob['config']
        return cls(build_model_spec(config), blob['model_state_dict'],
                   device=device,
                   dispersion=(config or {}).get(K.DISPERSION))

    def batch(self, s: Structure) -> Dict[str, torch.Tensor]:
        """One structure as a padded batch on the calculator's device."""
        g = structure_to_graph(s, self.spec.cutoff, self.type_map)
        n_node = bucket_capacity(len(s), margin=1.0)
        n_edge = bucket_capacity(g[K.EDGE_IDX].shape[1])
        b = collate([g], n_node=n_node, n_edge=n_edge, n_graph=1)
        return batch_to_torch(b, self.device)

    def calculate(self, s: Structure) -> Dict[str, np.ndarray]:
        """energy (eV), energies (eV/atom), forces (eV/A),
        stress (eV/A^3 Voigt xx yy zz xy yz zx) and stress_kbar."""
        out = apply_model(self.model, self.batch(s))
        n = len(s)
        stress = out[K.PRED_STRESS][0].cpu().numpy()
        return {
            'energy': float(out[K.PRED_TOTAL_ENERGY][0]),
            'energies': out[K.ATOMIC_ENERGY][:n].cpu().numpy(),
            'forces': out[K.PRED_FORCE][:n].cpu().numpy(),
            'stress': stress,
            'stress_kbar': stress * STRESS_COEFF_KBAR,
        }
