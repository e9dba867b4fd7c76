"""Molecular dynamics driver: velocity-Verlet NVE (and Langevin NVT).

Port of ``sevennet_finetuning_tpu/md.py`` (the counterpart of the
reference's LAMMPS pair-style integration, reference:
example_inputs/md_serial_example/in.lmp, sevenn/pair_e3gnn/*.cpp).
Forces come from the port's ``Calculator``, on its device (``cuda``
unless the calculator was built with ``device='cpu'``).

Two execution modes:

- ``run``: host loop, one force evaluation (and one device round trip)
  per step -- NVE, or NVT through the BAOAB Langevin splitting on the
  same host numpy generator as the JAX package, so a seeded run follows
  the same noise.
- ``run_device``: segments of up to ``seg_steps`` velocity-Verlet steps
  with positions, velocities, forces and the per-step energy buffers on
  the device.  The neighbor list is built at cutoff + skin and stays
  valid while no atom has moved more than skin/2 since the build; the
  envelope zeroes the edges beyond the cutoff.  PyTorch has no device
  while-loop, so the host reads one flag a step (the largest squared
  displacement against (skin/2)^2) and stops before the step that would
  use stale edges, where the JAX ``lax.while_loop`` stops: the steps per
  segment (``MDResult.segments``) are the same.  The host fetches
  positions and the energy buffers once per segment.  The first force of
  a segment is the last of the previous one.  D3 dispersion (a
  calculator built with ``d3=``) adds ``ops.d3.d3_energy`` on its own
  skin-padded edge list.

The multi-device halo path (``halo=``, ``run_device_halo``) is not
ported (ROADMAP A.8).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch

from .data.vasp import Structure

# eV, Angstrom, atomic mass units; 1 eV/A / amu = 9.648533e27 A/s^2
# time in femtoseconds: a [A/fs^2] = f/m * 9.6485332e-3
ACC_UNIT = 9.6485332e-3
KB_EV = 8.617333262e-5

ATOMIC_MASSES = {
    'H': 1.008, 'He': 4.0026, 'Li': 6.94, 'Be': 9.0122, 'B': 10.81,
    'C': 12.011, 'N': 14.007, 'O': 15.999, 'F': 18.998, 'Ne': 20.18,
    'Na': 22.99, 'Mg': 24.305, 'Al': 26.982, 'Si': 28.085, 'P': 30.974,
    'S': 32.06, 'Cl': 35.45, 'Ar': 39.948, 'K': 39.098, 'Ca': 40.078,
    'Ti': 47.867, 'Cr': 51.996, 'Mn': 54.938, 'Fe': 55.845, 'Ni': 58.693,
    'Cu': 63.546, 'Zn': 65.38, 'Zr': 91.224, 'Nb': 92.906, 'Mo': 95.95,
    'Ag': 107.87, 'Hf': 178.49, 'Ta': 180.95, 'W': 183.84, 'Pt': 195.08,
    'Au': 196.97, 'Pb': 207.2,
}

# neighbor-list capacity rule of the device loop (the JAX package's):
# 15% headroom over the edge count, rounded to a quantum, plus one
# quantum of slack whenever the capacity grows
EDGE_HEADROOM = 1.15
EDGE_QUANTUM = 512
D3_QUANTUM = 4096


def masses_of(species: List[str]) -> np.ndarray:
    return np.array([ATOMIC_MASSES.get(sp, 50.0) for sp in species])


@dataclass
class MDResult:
    energies: List[float] = field(default_factory=list)
    kinetic: List[float] = field(default_factory=list)
    temperatures: List[float] = field(default_factory=list)
    # steps taken by each run_device segment (port-only record; the JAX
    # package logs them as 'segment:' lines)
    segments: List[int] = field(default_factory=list)

    @property
    def total(self) -> List[float]:
        return [e + k for e, k in zip(self.energies, self.kinetic)]


def _halo_not_ported():
    return NotImplementedError(
        'halo-parallel MD (halo=, run_device_halo) is not ported yet: '
        'ROADMAP A.8')


class VelocityVerlet:
    def __init__(
        self,
        structure: Structure,
        calculator=None,
        dt_fs: float = 1.0,
        halo: Optional[Dict] = None,
        skin: float = 0.5,
    ):
        """``calculator``: the port's ``Calculator``; ``halo`` (the JAX
        package's multi-device spatial decomposition) is not ported."""
        if halo is not None:
            raise _halo_not_ported()
        self.s = Structure(
            species=list(structure.species),
            pos=np.array(structure.pos, float),
            cell=np.array(structure.cell, float),
            pbc=structure.pbc,
        )
        self.calc = calculator
        self.dt = dt_fs
        self.masses = masses_of(self.s.species)
        self.vel = np.zeros_like(self.s.pos)
        self.skin = skin
        self.result = MDResult()
        self._cap_edge = 0
        self._cap_d3 = 0

    def set_temperature(self, T: float, seed: int = 0):
        rng = np.random.default_rng(seed)
        sigma = np.sqrt(KB_EV * T / self.masses)[:, None]
        # velocity in A/fs: v = sqrt(kT/m) with unit conversion
        self.vel = rng.normal(size=self.s.pos.shape) * sigma \
            * np.sqrt(ACC_UNIT)
        self.vel -= self.vel.mean(axis=0)

    def _forces_energy(self):
        out = self.calc.calculate(self.s)
        return out['forces'], out['energy']

    def _halo_forces_energy(self):
        raise _halo_not_ported()

    def kinetic_energy(self) -> float:
        v2 = np.sum(self.vel ** 2, axis=1)
        return float(0.5 * np.sum(self.masses * v2) / ACC_UNIT)

    def temperature(self) -> float:
        dof = 3 * len(self.s.pos) - 3
        return 2 * self.kinetic_energy() / (dof * KB_EV)

    def _device_batch(self) -> Dict[str, torch.Tensor]:
        """The current structure as a padded batch on the calculator's
        device, its edges built at cutoff + skin under the capacity rule;
        with D3, its own skin-padded edge list and that list's sorts."""
        from . import keys as K
        from .model.graph import bucket_capacity, collate, structure_to_graph
        from .model.nequip import batch_to_torch

        calc = self.calc
        skin = float(self.skin)
        g = structure_to_graph(self.s, calc.spec.cutoff + skin,
                               calc.type_map)
        # headroom + monotone growth: neighbor counts creep between
        # rebuilds, and one quantum of slack absorbs the next creep
        need = bucket_capacity(int(g[K.EDGE_IDX].shape[1] * EDGE_HEADROOM),
                               quantum=EDGE_QUANTUM)
        if need > self._cap_edge:
            self._cap_edge = need + (EDGE_QUANTUM if self._cap_edge else 0)
        b = collate([g], n_node=bucket_capacity(len(self.s), margin=1.0),
                    n_edge=self._cap_edge, n_graph=1)
        out = batch_to_torch(b, calc.device)
        if calc.d3 is not None:
            from .data.neighborlist import neighbor_list
            from .ops.d3 import edge_sorts

            i3, j3, s3, _ = neighbor_list(
                self.s.pos, self.s.cell, self.s.pbc,
                calc.d3['cutoff_ang'] + skin)
            self._cap_d3 = max(
                self._cap_d3,
                bucket_capacity(int(len(i3) * EDGE_HEADROOM),
                                quantum=D3_QUANTUM))
            cap = self._cap_d3
            idx3 = np.zeros((2, cap), np.int32)
            shift3 = np.zeros((cap, 3), np.float32)
            mask3 = np.zeros(cap, np.float32)
            idx3[0, :len(i3)] = i3
            idx3[1, :len(i3)] = j3
            shift3[:len(i3)] = s3
            mask3[:len(i3)] = 1.0
            dev = calc.device
            out['d3_edge_idx'] = torch.as_tensor(idx3, device=dev)
            out['d3_shift'] = torch.as_tensor(shift3, device=dev)
            out['d3_mask'] = torch.as_tensor(mask3, device=dev)
            out['d3_sorts'] = edge_sorts(out['d3_edge_idx'])
        return out

    def _device_forces(self, batch, pos):
        """(forces [n_node, 3], potential energy []) at ``pos``, both on
        the device; padded nodes get zero force."""
        from . import keys as K
        from .model.nequip import apply_model

        calc = self.calc
        mask = batch[K.NODE_MASK][:, None]
        out = apply_model(calc.model, dict(batch, **{K.POS: pos}))
        f = out[K.PRED_FORCE] * mask
        e = out[K.PRED_TOTAL_ENERGY][0]
        if calc.d3 is not None:
            from .ops.d3 import d3_energy

            p = pos.detach().requires_grad_(True)
            with torch.enable_grad():
                e3 = d3_energy(
                    calc.d3['spec'], calc.d3['arrays'], p,
                    batch[K.ATOM_TYPE], batch['d3_edge_idx'],
                    batch['d3_shift'], batch[K.CELL][0],
                    batch['d3_mask'], batch[K.NODE_MASK],
                    sorts=batch['d3_sorts'])
                g3, = torch.autograd.grad(e3, p)
            e = e + e3.detach()
            f = f - g3 * mask
        return f, e

    def run_device(self, n_steps: int, seg_steps: int = 50,
                   logger=None) -> MDResult:
        """NVE with the state on the device: segments of up to
        ``seg_steps`` velocity-Verlet steps, each ending early when any
        atom has moved more than skin/2 since the segment's neighbor
        build.  Requires a single-device Calculator (thermostats use
        ``run``).

        The neighbor list is built at cutoff + skin so the edge set stays
        a superset for the whole segment (the reference's pair style
        delegates the same skin logic to LAMMPS neighbor lists)."""
        if self.calc is None:
            raise ValueError('run_device needs a single-device Calculator')
        from . import keys as K

        n = len(self.s.pos)
        dt = float(self.dt)
        thr = (float(self.skin) / 2) ** 2
        dev = self.calc.device

        batch = self._device_batch()
        n_node = batch[K.POS].shape[0]
        masses = np.ones(n_node)
        masses[:n] = self.masses
        m = torch.as_tensor(masses, dtype=torch.float32,
                            device=dev)[:, None]
        vel = np.zeros((n_node, 3), np.float32)
        vel[:n] = self.vel
        vel = torch.as_tensor(vel, device=dev)
        f = None
        dof = 3 * n - 3
        remaining = n_steps
        with torch.no_grad():
            while remaining > 0:
                n_active = min(seg_steps, remaining)
                pos0 = batch[K.POS]
                node_mask = batch[K.NODE_MASK]
                if f is None:
                    f = self._device_forces(batch, pos0)[0]
                e_buf = torch.full((seg_steps,), float('nan'),
                                   device=dev)
                ke_buf = torch.full((seg_steps,), float('nan'),
                                    device=dev)
                pos = pos0
                done = 0
                while done < n_active:
                    # stop BEFORE stepping once edges may be stale, so
                    # the host rebuilds and re-runs from this state
                    disp = torch.max(torch.sum((pos - pos0) ** 2, -1)
                                     * node_mask)
                    if not bool(disp <= thr):
                        break
                    a = f / m * ACC_UNIT
                    v1 = vel + 0.5 * dt * a
                    pos = pos + dt * v1
                    f, e1 = self._device_forces(batch, pos)
                    vel = v1 + 0.5 * dt * f / m * ACC_UNIT
                    e_buf[done] = e1
                    ke_buf[done] = 0.5 * torch.sum(m * vel * vel) / ACC_UNIT
                    done += 1
                # the single fetch per segment: positions and energies
                packed = torch.cat([pos.reshape(-1), e_buf,
                                    ke_buf]).cpu().numpy()
                pos_flat = packed[:3 * n_node]
                e_np = packed[3 * n_node:3 * n_node + seg_steps][:done]
                ke_np = packed[3 * n_node + seg_steps:][:done]
                self.result.energies.extend(float(x) for x in e_np)
                self.result.kinetic.extend(float(x) for x in ke_np)
                self.result.temperatures.extend(
                    float(2 * k / (dof * KB_EV)) for k in ke_np)
                self.result.segments.append(done)
                if logger is not None and done:
                    logger.writeline(
                        f'segment: {done:4d} steps  '
                        f'E_pot {e_np[-1]:14.6f}  E_kin {ke_np[-1]:10.6f}'
                    )
                if done == 0:
                    raise RuntimeError(
                        'MD segment made no progress (skin trip at step 0 '
                        'after a fresh rebuild should be impossible)'
                    )
                remaining -= done
                self.s.pos = pos_flat.reshape(n_node, 3)[:n].astype(float)
                if remaining > 0:
                    # neighbor rebuild (or segment exhausted): fresh edge
                    # set; the carried force is exact under it (every
                    # pair within cutoff is in both lists, the envelope
                    # zeroes the rest)
                    batch = self._device_batch()
        self.vel = vel[:n].cpu().numpy().astype(float)
        return self.result

    def run_device_halo(self, n_steps: int, seg_steps: int = 50,
                        logger=None) -> MDResult:
        raise _halo_not_ported()

    def run(self, n_steps: int, log_every: int = 1,
            logger=None, thermostat: Optional[Dict] = None,
            seed: int = 0) -> MDResult:
        """NVE by default.  ``thermostat=dict(kind='langevin', T=300,
        gamma_per_fs=0.01)`` runs NVT via the BAOAB Langevin splitting
        (the capability LAMMPS `fix langevin` provides in the reference's
        MD examples).  The friction may be given as a rate
        ``gamma_per_fs`` [1/fs] or a damping time ``tau_fs`` [fs]
        (= 1/gamma, the convention of LAMMPS `fix langevin`'s damp
        argument); ``gamma_fs`` is a deprecated alias of
        ``gamma_per_fs``."""
        rng = np.random.default_rng(seed)
        gamma = c1 = sigma = None
        if thermostat is not None:
            if thermostat.get('kind', 'langevin') != 'langevin':
                raise ValueError('only langevin thermostat is implemented')
            if 'tau_fs' in thermostat:
                gamma = 1.0 / float(thermostat['tau_fs'])
            else:
                gamma = float(
                    thermostat.get(
                        'gamma_per_fs', thermostat.get('gamma_fs', 0.01)
                    )
                )  # friction rate, 1/fs
            if gamma * self.dt > 2.0:
                import warnings

                warnings.warn(
                    f'langevin friction gamma*dt = {gamma * self.dt:.3g} '
                    '> 2: extremely overdamped -- gamma_per_fs is a RATE '
                    '(1/fs); pass tau_fs for a damping time in fs'
                )
            c1 = np.exp(-gamma * self.dt)
            # v-scale noise: sqrt((1-c1^2) kT/m) in A/fs
            sigma = np.sqrt(
                (1.0 - c1 * c1) * KB_EV * float(thermostat['T'])
                / self.masses * ACC_UNIT
            )[:, None]
        f, e = self._forces_energy()
        for step in range(n_steps):
            a = f / self.masses[:, None] * ACC_UNIT
            self.vel += 0.5 * self.dt * a
            if thermostat is None:
                self.s.pos += self.dt * self.vel
            else:
                # BAOAB: half drift, O-step (exact OU), half drift
                self.s.pos += 0.5 * self.dt * self.vel
                self.vel = c1 * self.vel + sigma * rng.normal(
                    size=self.vel.shape
                )
                self.s.pos += 0.5 * self.dt * self.vel
            f, e = self._forces_energy()
            a = f / self.masses[:, None] * ACC_UNIT
            self.vel += 0.5 * self.dt * a
            if step % log_every == 0:
                ke = self.kinetic_energy()
                self.result.energies.append(e)
                self.result.kinetic.append(ke)
                self.result.temperatures.append(self.temperature())
                if logger is not None:
                    logger.writeline(
                        f'step {step:6d}  E_pot {e:14.6f}  '
                        f'E_kin {ke:10.6f}  '
                        f'E_tot {e + ke:14.6f}  T {self.temperature():8.2f}'
                    )
        return self.result
