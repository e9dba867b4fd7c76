"""Single-point calculator: structures -> energy / forces / stress.

Port of ``sevennet_finetuning_tpu/calculator.py``: builds a padded graph
per call (bucketed capacities, as the JAX package does) and runs the
model on the calculator's device -- ``cuda`` unless the caller passes
``device='cpu'``.  The model runs with its weights frozen, so autograd
tracks only the edge vectors the forces come from.  ``d3=`` adds Grimme
D3 dispersion (``ops/d3.py``) on the same device.  ``from_checkpoint``
reads pickle checkpoints and the npz deploy artifact;
``from_deployed_torchscript`` and the ASE adapter are not ported
(ROADMAP A.10, A.6).
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
                 d3: Optional[Dict] = None):
        """``params``: the JAX package's parameter dict (numpy arrays).
        d3: optional dispersion settings, e.g.
        dict(functional='pbe', damping='bj'[, cutoff=..., cn_cutoff=...])
        -- adds Grimme D3 energy/forces/stress on top of the GNN
        (reference: sevenn/pair_e3gnn/README.md)."""
        self.device = resolve_device(device)
        self.spec = spec
        self.type_map = dict(spec.type_map)
        self.model = load_jax_params(NequIP(spec), params).to(self.device)
        self.model.requires_grad_(False)
        self.d3 = None
        if d3 is not None:
            from .ops.d3 import AU_TO_ANG, d3_spec, d3_static_arrays

            zs = [z for z, _ in sorted(self.type_map.items(),
                                       key=lambda kv: kv[1])]
            d3_s = d3_spec(zs, **d3)
            self.d3 = {'spec': d3_s,
                       'arrays': d3_static_arrays(d3_s, self.device),
                       'cutoff_ang': d3_s.cutoff * AU_TO_ANG}

    @classmethod
    def from_checkpoint(cls, path: str, device=None) -> 'Calculator':
        from .model.build import build_model_spec
        from .train.checkpoint import load_checkpoint

        device = resolve_device(device)
        blob = load_checkpoint(path)
        config = blob['config']
        # dispersion travels with the checkpoint config (model section
        # key 'dispersion') so deployed potentials keep their D3 terms
        return cls(build_model_spec(config), blob['model_state_dict'],
                   device=device, d3=(config or {}).get(K.DISPERSION))

    @classmethod
    def from_deployed(cls, path: str, device=None) -> 'Calculator':
        """Load an npz+json deploy artifact (safe: no pickle)."""
        from .train.checkpoint import model_from_deployed

        spec, params, _ = model_from_deployed(path)
        return cls(spec, params, device=device)

    @classmethod
    def from_deployed_torchscript(cls, path: str, config_overrides=None,
                                  device=None) -> 'Calculator':
        raise NotImplementedError(
            'importing a reference TorchScript artifact needs '
            'compat/torchscript_import, not ported yet: ROADMAP A.10')

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
        energy = float(out[K.PRED_TOTAL_ENERGY][0])
        forces = out[K.PRED_FORCE][:n].cpu().numpy()
        stress = out[K.PRED_STRESS][0].cpu().numpy()
        if self.d3 is not None:
            e_d3, f_d3, s_d3 = self._d3_terms(s)
            energy += e_d3
            forces = forces + f_d3
            stress = stress + s_d3
        return {
            'energy': energy,
            'energies': out[K.ATOMIC_ENERGY][:n].cpu().numpy(),
            'forces': forces,
            'stress': stress,
            'stress_kbar': stress * STRESS_COEFF_KBAR,
        }

    def d3_terms(self, s: Structure):
        """(energy eV, forces, stress Voigt) of the D3 term alone."""
        return self._d3_terms(s)

    def _d3_terms(self, s: Structure):
        from .data.neighborlist import neighbor_list
        from .ops.d3 import d3_energy_forces_stress

        i, j, shift, _ = neighbor_list(
            s.pos, s.cell, s.pbc, self.d3['cutoff_ang']
        )
        types = np.array(
            [self.type_map[int(z)] for z in s.atomic_numbers], np.int32
        )
        dev = self.device

        def t(a, dtype=torch.float32):
            return torch.as_tensor(np.asarray(a), dtype=dtype, device=dev)

        e, f, st = d3_energy_forces_stress(
            self.d3['spec'], self.d3['arrays'], t(s.pos), t(types, torch.int32),
            t(np.stack([i, j]), torch.int32), t(shift), t(s.cell),
            torch.ones(len(i), dtype=torch.float32, device=dev),
            float(s.volume),
        )
        return float(e), f.cpu().numpy(), st.cpu().numpy()


class SevenNetASECalculator:
    """The JAX package's ase adapter (reference: sevenn/sevennet_calculator.py:
    17-157): not ported, since ase is on neither machine the port runs on."""

    def __init__(self, model, **kwargs):
        raise NotImplementedError(
            'SevenNetASECalculator is not ported yet: ROADMAP A.6')
