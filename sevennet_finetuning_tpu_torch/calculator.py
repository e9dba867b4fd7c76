"""Single-point calculator: structures -> energy / forces / stress.

Port of ``sevennet_finetuning_tpu/calculator.py``: builds a padded graph
per call (bucketed capacities, as the JAX package does) and runs the
model on the calculator's device -- ``cuda`` unless the caller passes
``device='cpu'``.  On a CUDA calculator the card builds the request's
edges (``ops/neighbor.py``'s cell list, as MD's rebuild does); on the
CPU the host's neighbor list and ``collate`` build them.  The model runs
with its weights frozen, so autograd tracks only the edge vectors the
forces come from.  ``d3=`` adds Grimme D3 dispersion (``ops/d3.py``) on
the same device, its neighbor list built on the host.  ``from_checkpoint``
reads pickle checkpoints of either package, reference torch ``.pth``
files and the npz deploy artifact; ``from_deployed_torchscript`` imports
the weights of a reference frozen TorchScript (``compat/
torchscript_import``).  ``get_potential_energy`` / ``get_forces`` /
``get_stress`` are JAX's ASE-like getters over ``calculate``.
``SevenNetASECalculator`` adapts the calculator to ``ase`` (imported
lazily: only usable where ase is installed).
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from . import keys as K
from . import resolve_device, tracing
from .data.vasp import Structure
from .model.build import build_model
from .model.graph import (
    bucket_capacity,
    collate,
    structure_nodes,
    structure_to_graph,
)
from .model.nequip import (
    EDGE_SRC_INV_PERM,
    ModelSpec,
    apply_model,
    batch_to_torch,
    load_jax_params,
)
from .ops.neighbor import CellList, nearest_edges, pack_edges

STRESS_COEFF_KBAR = 1602.1766208


def node_batch(s: Structure, type_map: Dict[int, int],
               device) -> Dict[str, torch.Tensor]:
    """The node and per-graph keys of ``s``'s padded batch on ``device``
    (``collate`` of the structure without edges), ``K.POS`` the float32
    positions padded with zeros to ``bucket_capacity(n, margin=1.0)``."""
    g = structure_nodes(s, type_map)
    g[K.EDGE_IDX] = np.zeros((2, 0), np.int32)
    g[K.CELL_SHIFT] = np.zeros((0, 3), np.float32)
    b = collate([g], n_node=bucket_capacity(len(s), margin=1.0), n_edge=0,
                n_graph=1)
    out = batch_to_torch(b, device)
    for k in (K.EDGE_IDX, K.CELL_SHIFT, K.EDGE_MASK, K.EDGE_SRC_PERM,
              EDGE_SRC_INV_PERM):
        del out[k]
    return out


def with_edges(nodes: Dict[str, torch.Tensor], n_live: int,
               fill) -> Dict[str, torch.Tensor]:
    """``nodes`` and the edge keys of ``n_live`` edges grouped by
    ascending destination: ``fill(edge_idx, shift)`` writes them into
    slots [0, n_live) of new buffers of ``bucket_capacity(n_live)`` slots
    (the host path's rule), and ``pack_edges`` pads the rest as
    ``collate`` does and sorts the sources."""
    dev = nodes[K.POS].device
    n_node = nodes[K.NODE_MASK].shape[0]
    cap = bucket_capacity(n_live)
    idx = torch.empty((2, cap), dtype=torch.int32, device=dev)
    shift = torch.empty((cap, 3), dtype=torch.float32, device=dev)
    mask = torch.empty(cap, dtype=torch.float32, device=dev)
    fill(idx, shift)
    perm, inv = pack_edges(idx, shift, mask, n_live, n_node)
    return dict(nodes, **{K.EDGE_IDX: idx, K.CELL_SHIFT: shift,
                          K.EDGE_MASK: mask, K.EDGE_SRC_PERM: perm,
                          EDGE_SRC_INV_PERM: inv})


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
        self.model = load_jax_params(build_model(spec), params).to(self.device)
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
        """The weights of a reference ``deployed_serial.pt`` (frozen
        TorchScript), served by this package's model on ``device``."""
        from .compat.torchscript_import import import_deployed_serial

        device = resolve_device(device)
        spec, params, _, _ = import_deployed_serial(path, config_overrides)
        return cls(spec, params, device=device)

    def batch(self, s: Structure) -> Dict[str, torch.Tensor]:
        """One structure as a padded batch on the calculator's device: on a
        CUDA calculator its edges built on the card (``_card_batch``),
        elsewhere by the host's neighbor list, ``collate`` and the copies
        of ``batch_to_torch``."""
        with tracing.span('graph.build'):
            if self.device.type == 'cuda':
                return self._card_batch(s)
            g = structure_to_graph(s, self.spec.cutoff, self.type_map,
                                   self.spec.max_neighbors)
            n_node = bucket_capacity(len(s), margin=1.0)
            n_edge = bucket_capacity(g[K.EDGE_IDX].shape[1])
            b = collate([g], n_node=n_node, n_edge=n_edge, n_graph=1)
            return batch_to_torch(b, self.device)

    def _card_batch(self, s: Structure) -> Dict[str, torch.Tensor]:
        """The card build: the node keys, a ``CellList`` of the request
        (dropped on return, before the model runs), its count pass and
        one read of the edge total, then ``with_edges`` over its fill
        pass."""
        nodes = node_batch(s, self.type_map, self.device)
        cells = CellList(s.cell, s.pbc, self.spec.cutoff, s.pos, self.device)
        k = self.spec.max_neighbors
        n_live, reads = cells.count(nodes[K.POS], cap=k)
        tracing.count('host_syncs', reads)
        tracing.count('graph.build.device')
        if k is None:
            return with_edges(nodes, n_live, cells.fill)
        with tracing.span('graph.cap'):
            tracing.count('graph.cap.candidates', cells.candidates)
            tracing.count('graph.cap.edges', n_live)
            return with_edges(nodes, n_live,
                              self._nearest_fill(cells, nodes[K.POS], s, k,
                                                 n_live))

    def _nearest_fill(self, cells: CellList, pos: torch.Tensor,
                      s: Structure, k: int, n_live: int):
        """The fill of a capped card build: the candidates into buffers
        of their own, then each atom's ``k`` nearest (``nearest_edges``)."""
        def fill(edge_idx, shift):
            n_cand = cells.candidates
            idx = torch.empty((2, n_cand), dtype=torch.int32,
                              device=self.device)
            sh = torch.empty((n_cand, 3), dtype=torch.float32,
                             device=self.device)
            cells.fill(idx, sh)
            cell = torch.as_tensor(np.asarray(s.cell, np.float64),
                                   device=self.device)
            nearest_edges(idx, sh, pos, cell, cells.bufs['atom_cnt'],
                          cells.bufs['atom_off'], k, edge_idx, shift, n_live)
        return fill

    def calculate(self, s: Structure) -> Dict[str, np.ndarray]:
        """energy (eV), energies (eV/atom), forces (eV/A),
        stress (eV/A^3 Voigt xx yy zz xy yz zx) and stress_kbar."""
        n = len(s)
        with tracing.span('calc.request', unit=True, n_atoms=n) as req:
            batch = self.batch(s)
            req.set(edge_capacity=int(batch[K.EDGE_IDX].shape[1]))
            out = apply_model(self.model, batch)
            with tracing.span('calc.fetch.wait'):
                energy = float(out[K.PRED_TOTAL_ENERGY][0])
                forces = out[K.PRED_FORCE][:n].cpu().numpy()
                stress = out[K.PRED_STRESS][0].cpu().numpy()
                energies = out[K.ATOMIC_ENERGY][:n].cpu().numpy()
                tracing.count('host_syncs', 4)
        if self.d3 is not None:
            e_d3, f_d3, s_d3 = self._d3_terms(s)
            energy += e_d3
            forces = forces + f_d3
            stress = stress + s_d3
        return {
            'energy': energy,
            'energies': energies,
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

    # ASE-like conveniences
    def get_potential_energy(self, s: Structure) -> float:
        return self.calculate(s)['energy']

    def get_forces(self, s: Structure) -> np.ndarray:
        return self.calculate(s)['forces']

    def get_stress(self, s: Structure) -> np.ndarray:
        return self.calculate(s)['stress']


class SevenNetASECalculator:
    """ase.calculators adapter over :class:`Calculator` (the reference's
    SevenNetCalculator surface, reference: sevenn/sevennet_calculator.py:
    17-157).  Imported lazily: only usable where ase is installed.
    ``model``: a ``Calculator`` or a checkpoint path (served on
    ``device``, cuda unless asked otherwise)."""

    implemented_properties = ('energy', 'energies', 'forces', 'stress',
                              'free_energy')

    def __init__(self, model, device=None, **kwargs):
        from ase.calculators.calculator import Calculator as AseBase

        if isinstance(model, str):
            model = Calculator.from_checkpoint(model, device=device)
        self._inner = model

        outer = self

        class _Impl(AseBase):
            implemented_properties = list(
                SevenNetASECalculator.implemented_properties
            )

            def calculate(self, atoms=None, properties=('energy',),
                          system_changes=None):
                super().calculate(atoms, properties, system_changes)
                s = Structure(
                    species=list(atoms.get_chemical_symbols()),
                    pos=np.asarray(atoms.get_positions(), float),
                    cell=np.asarray(atoms.get_cell()[:], float),
                    pbc=tuple(bool(p) for p in atoms.get_pbc()),
                )
                res = outer._inner.calculate(s)
                self.results = {
                    'energy': float(res['energy']),
                    'free_energy': float(res['energy']),
                    'energies': np.asarray(res['energies']),
                    'forces': np.asarray(res['forces']),
                    # ase Voigt order xx yy zz yz xz xy, sign flipped
                    'stress': -np.asarray(res['stress'])[
                        [0, 1, 2, 4, 5, 3]
                    ],
                }

        self.ase_calculator = _Impl(**kwargs)

    def __getattr__(self, name):
        return getattr(self.ase_calculator, name)
