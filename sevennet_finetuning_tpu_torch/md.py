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
  positions and the energy buffers once per segment.  On a CUDA
  calculator the rebuild runs on the card (``ops.neighbor``: the host
  core's cell list as a kernel, from the segment's last device
  positions), with one read of the edge count.  The first force of
  a segment is the last of the previous one.  D3 dispersion (a
  calculator built with ``d3=``) adds ``ops.d3.d3_energy`` on its own
  skin-padded edge list.

With ``halo=dict(n_dev=D)`` the forces come from the spatially
decomposed halo forward (``parallel.halo``) over D ranks: all D
partitions in this process, or one per process of a ``torch.distributed``
group of D ranks (``torchrun --nproc_per_node D``; every rank holds the
whole structure and builds the same plan).  ``run`` then gathers every
rank's forces each step; ``run_device_halo`` is the device loop over the
partitions, rebuilding the plan at a skin trip.  Both device loops run
their steps through one velocity-Verlet segment (``vv_segment``) and
record them through one helper (``VelocityVerlet._record_segment``).  D3
dispersion is serial-only, as in JAX (the reference's D3 pair style is
single-GPU).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch

from . import tracing
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


def _all_ranks(fwd, t: torch.Tensor) -> np.ndarray:
    """[R, n_local, c] rows of the ranks ``fwd`` holds -> every rank's
    [D, n_local, c] on the host (all-gathered across processes)."""
    if fwd.distributed:
        from .parallel import data_parallel as dp

        return torch.cat(dp.all_gather(t)).cpu().numpy()
    return t.cpu().numpy()


def _held(fwd, arr: np.ndarray, fill: float = 0.0) -> torch.Tensor:
    """[n, ...] global -> [R, n_local, ...] of ``fwd``'s ranks, on its
    device."""
    from .parallel.halo import scatter_positions

    return torch.as_tensor(scatter_positions(fwd.plan, arr, fill, fwd.ranks),
                           device=fwd.device)


def vv_segment(forces, pos, vel, m, f, node_mask, dt: float, thr: float,
               n_active: int, n_seg: int, reduce=None):
    """Up to ``n_active`` (<= ``n_seg``) velocity-Verlet steps on the
    device in the caller's layout (masses [..., 1]; padded rows: mass 1,
    zero velocity and force); ``forces(pos)`` -> (forces, energy).  Stops
    before a step once the largest squared displacement of the
    ``node_mask`` rows since the start, through ``reduce`` (over
    processes), passes ``thr``: one host read a step.  Returns (pos, vel,
    f, done, energies [n_seg], kinetic energies [n_seg])."""
    e_buf = torch.full((n_seg,), float('nan'), device=pos.device)
    ke_buf = torch.full((n_seg,), float('nan'), device=pos.device)
    pos0 = pos
    done = 0
    while done < n_active:
        with tracing.span('md.step', unit=True) as step:
            # stop BEFORE stepping once edges may be stale, so the host
            # rebuilds and re-runs from this state
            with tracing.span('md.skin.wait'):
                disp = torch.max(torch.sum((pos - pos0) ** 2, -1)
                                 * node_mask)
                if reduce is not None:
                    disp = reduce(disp)
                fresh = bool(disp <= thr)
                tracing.count('host_syncs')
            if not fresh:
                step.set(skin_trip=True)
                break
            with tracing.span('md.integrate'):
                a = f / m * ACC_UNIT
                v1 = vel + 0.5 * dt * a
                pos = pos + dt * v1
            f, e1 = forces(pos)
            with tracing.span('md.integrate'):
                vel = v1 + 0.5 * dt * f / m * ACC_UNIT
                e_buf[done] = e1
                ke_buf[done] = 0.5 * torch.sum(m * vel * vel) / ACC_UNIT
        done += 1
    return pos, vel, f, done, e_buf, ke_buf


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
    # seconds run_device_halo spent in the halo swaps, counted while
    # parallel.halo.DistTransport.timed is set (port-only)
    transport_seconds: float = 0.0

    @property
    def total(self) -> List[float]:
        return [e + k for e, k in zip(self.energies, self.kinetic)]


def _refuse_capped(spec, loop: str):
    """A device MD loop keeps a skin list at cutoff + skin for a segment;
    a graph of each atom's nearest neighbours changes within it."""
    if spec.max_neighbors is not None:
        raise NotImplementedError(
            f'{loop}: a model with max_neighbors ({spec.max_neighbors}) '
            'needs each step\'s nearest-neighbour graph, which a skin list '
            'cannot hold; MD with it is not implemented')


class VelocityVerlet:
    def __init__(
        self,
        structure: Structure,
        calculator=None,
        dt_fs: float = 1.0,
        halo: Optional[Dict] = None,
        skin: float = 0.5,
    ):
        """``calculator``: the port's ``Calculator`` (its model and device
        serve the halo path too); ``halo=dict(n_dev=D)`` switches the
        force evaluation to the D-rank spatial decomposition (JAX's
        ``halo`` dict names the spec, parameters and mesh; here the
        calculator carries the first two and the process group, if any,
        takes the mesh's place)."""
        if halo is not None and (calculator is None
                                 or calculator.d3 is not None):
            raise ValueError('halo MD needs a Calculator without D3 '
                             '(D3 is serial-only)')
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
        self.halo_cfg = halo
        self._halo_fwd = None
        self._pos_at_build = None
        self.result = MDResult()
        self._cap_edge = 0
        self._cap_d3 = 0
        # the card rebuild's node keys and cell list
        self._nodes = None
        self._cells = None
        self._hcaps: Dict = {}

    def set_temperature(self, T: float, seed: int = 0):
        rng = np.random.default_rng(seed)
        sigma = np.sqrt(KB_EV * T / self.masses)[:, None]
        # velocity in A/fs: v = sqrt(kT/m) with unit conversion
        self.vel = rng.normal(size=self.s.pos.shape) * sigma \
            * np.sqrt(ACC_UNIT)
        self.vel -= self.vel.mean(axis=0)

    def _forces_energy(self):
        if self.halo_cfg is None:
            out = self.calc.calculate(self.s)
            return out['forces'], out['energy']
        return self._halo_forces_energy()

    def _halo_forces_energy(self):
        """Forces and energy from the halo forward, the plan rebuilt at
        cutoff + skin once an atom moved more than skin/2 since its
        build; every rank's forces gathered into global order."""
        from .parallel.halo import (build_halo_plan, gather_forces,
                                    make_halo_forward)

        spec = self.calc.spec
        rebuild = self._halo_fwd is None or (
            np.abs(self.s.pos - self._pos_at_build).max() > self.skin / 2
        )
        if rebuild:
            plan = build_halo_plan(self.s, spec.cutoff + self.skin,
                                   dict(spec.type_map),
                                   self.halo_cfg['n_dev'])
            self._halo_fwd = make_halo_forward(self.calc.model, plan)
            self._pos_at_build = self.s.pos.copy()
        fwd = self._halo_fwd
        e, f, _ = fwd(_held(fwd, self.s.pos))
        return (gather_forces(fwd.plan, _all_ranks(fwd, f)), float(e))

    def kinetic_energy(self) -> float:
        v2 = np.sum(self.vel ** 2, axis=1)
        return float(0.5 * np.sum(self.masses * v2) / ACC_UNIT)

    def temperature(self) -> float:
        dof = 3 * len(self.s.pos) - 3
        return 2 * self.kinetic_energy() / (dof * KB_EV)

    def _device_pos(self) -> torch.Tensor:
        """``self.s.pos`` on the calculator's device, float32, padded with
        zeros to the batch's nodes (as ``collate`` pads them)."""
        from .model.graph import bucket_capacity

        host = np.zeros((bucket_capacity(len(self.s), margin=1.0), 3),
                        np.float32)
        host[:len(self.s)] = self.s.pos
        return torch.as_tensor(host, device=self.calc.device)

    def _device_batch(self, pos: torch.Tensor) -> Dict[str, torch.Tensor]:
        """The current structure as a padded batch on the calculator's
        device, its edges built at cutoff + skin under the capacity rule;
        with D3, its own skin-padded edge list and that list's sorts.

        ``pos``: ``self.s.pos`` on the device, padded (``_device_pos``, or
        a segment's last positions).  On a CUDA calculator the card builds
        the edges from it; elsewhere the host builds the graph from
        ``self.s.pos`` and copies it in."""
        calc = self.calc
        with tracing.span('md.rebuild'):
            if calc.device.type == 'cuda':
                out = self._card_edges(pos)
            else:
                out = self._host_edges()
            if calc.d3 is not None:
                from .data.neighborlist import neighbor_list
                from .model.graph import bucket_capacity
                from .ops.d3 import edge_sorts

                i3, j3, s3, _ = neighbor_list(
                    self.s.pos, self.s.cell, self.s.pbc,
                    calc.d3['cutoff_ang'] + float(self.skin))
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

    def _grow_edge_capacity(self, n_edge: int) -> bool:
        """Apply the capacity rule to ``n_edge`` live edges; True where the
        capacity grew.  Headroom + monotone growth: neighbor counts creep
        between rebuilds, and one quantum of slack absorbs the next creep."""
        from .model.graph import bucket_capacity

        need = bucket_capacity(int(n_edge * EDGE_HEADROOM),
                               quantum=EDGE_QUANTUM)
        if need <= self._cap_edge:
            return False
        self._cap_edge = need + (EDGE_QUANTUM if self._cap_edge else 0)
        return True

    def _host_edges(self) -> Dict[str, torch.Tensor]:
        """The host rebuild: the native neighbor list, ``collate`` and the
        copies of ``batch_to_torch``."""
        from . import keys as K
        from .model.graph import bucket_capacity, collate, structure_to_graph
        from .model.nequip import batch_to_torch

        calc = self.calc
        with tracing.span('graph.build'):
            g = structure_to_graph(self.s, calc.spec.cutoff + float(self.skin),
                                   calc.type_map)
            self._grow_edge_capacity(g[K.EDGE_IDX].shape[1])
            b = collate([g], n_node=bucket_capacity(len(self.s), margin=1.0),
                        n_edge=self._cap_edge, n_graph=1)
            return batch_to_torch(b, calc.device)

    def _node_keys(self) -> Dict[str, torch.Tensor]:
        """The batch's node and per-graph keys on the calculator's device
        (``collate`` of the structure without edges), which no rebuild
        changes."""
        from . import keys as K
        from .model.graph import bucket_capacity, collate, structure_nodes
        from .model.nequip import EDGE_SRC_INV_PERM, batch_to_torch

        calc = self.calc
        g = structure_nodes(self.s, calc.type_map)
        g[K.EDGE_IDX] = np.zeros((2, 0), np.int32)
        g[K.CELL_SHIFT] = np.zeros((0, 3), np.float32)
        b = collate([g], n_node=bucket_capacity(len(self.s), margin=1.0),
                    n_edge=0, n_graph=1)
        out = batch_to_torch(b, calc.device)
        for k in (K.POS, K.EDGE_IDX, K.CELL_SHIFT, K.EDGE_MASK,
                  K.EDGE_SRC_PERM, EDGE_SRC_INV_PERM):
            del out[k]
        return out

    def _card_edges(self, pos: torch.Tensor) -> Dict[str, torch.Tensor]:
        """The card rebuild (``ops.neighbor``): the count pass, one read
        of the edge total, the capacity rule, the fill pass, then the
        padding and the src sort.  The edge tensors are new each rebuild
        (the caching allocator's): a batch handed out earlier keeps its
        edges."""
        from . import keys as K
        from .model.nequip import EDGE_SRC_INV_PERM
        from .ops.neighbor import CellList, pack_edges

        calc = self.calc
        dev = calc.device
        if self._nodes is None:
            self._nodes = self._node_keys()
            self._cells = CellList(self.s.cell, self.s.pbc,
                                   calc.spec.cutoff + float(self.skin),
                                   self.s.pos, dev)
        n_node = self._nodes[K.NODE_MASK].shape[0]
        with tracing.span('md.rebuild.wait'):
            n_edge, reads = self._cells.count(pos)
            tracing.count('host_syncs', reads)
        if self._grow_edge_capacity(n_edge):
            tracing.count('md.rebuild.grow')
        cap = self._cap_edge
        idx = torch.empty((2, cap), dtype=torch.int32, device=dev)
        shift = torch.empty((cap, 3), dtype=torch.float32, device=dev)
        mask = torch.empty(cap, dtype=torch.float32, device=dev)
        self._cells.fill(idx, shift)
        perm, inv = pack_edges(idx, shift, mask, n_edge, n_node)
        tracing.count('md.rebuild.device')
        return dict(self._nodes, **{
            K.POS: pos, K.EDGE_IDX: idx, K.CELL_SHIFT: shift,
            K.EDGE_MASK: mask, K.EDGE_SRC_PERM: perm, EDGE_SRC_INV_PERM: inv})

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
        _refuse_capped(self.calc.spec, 'run_device')
        from . import keys as K

        n = len(self.s.pos)
        thr = (float(self.skin) / 2) ** 2
        dev = self.calc.device

        batch = self._device_batch(self._device_pos())
        n_node = batch[K.POS].shape[0]
        masses = np.ones(n_node)
        masses[:n] = self.masses
        m = torch.as_tensor(masses, dtype=torch.float32,
                            device=dev)[:, None]
        vel = np.zeros((n_node, 3), np.float32)
        vel[:n] = self.vel
        vel = torch.as_tensor(vel, device=dev)
        f = None
        remaining = n_steps
        with torch.no_grad():
            while remaining > 0:
                with tracing.span('md.segment'):
                    pos = batch[K.POS]
                    if f is None:
                        f = self._device_forces(batch, pos)[0]
                    pos, vel, f, done, e_buf, ke_buf = vv_segment(
                        lambda p: self._device_forces(batch, p), pos, vel,
                        m, f, batch[K.NODE_MASK], float(self.dt), thr,
                        min(seg_steps, remaining), seg_steps)
                    # the single fetch per segment: positions and energies
                    with tracing.span('md.fetch.wait'):
                        packed = torch.cat([pos.reshape(-1), e_buf,
                                            ke_buf]).cpu().numpy()
                        tracing.count('host_syncs')
                    self._record_segment(packed[3 * n_node:], seg_steps,
                                         done, logger, '')
                    remaining -= done
                    self.s.pos = packed[:3 * n_node].reshape(
                        n_node, 3)[:n].astype(float)
                    if remaining > 0:
                        # neighbor rebuild (or segment exhausted): fresh edge
                        # set; the carried force is exact under it (every
                        # pair within cutoff is in both lists, the envelope
                        # zeroes the rest)
                        batch = self._device_batch(pos)
        with tracing.span('md.fetch.wait'):
            self.vel = vel[:n].cpu().numpy().astype(float)
            tracing.count('host_syncs')
        return self.result

    def _record_segment(self, energies: np.ndarray, n_seg: int, done: int,
                        logger, prefix: str):
        """Record a segment of ``done`` steps from its energy buffers (the
        potential's then the kinetic's, ``n_seg`` each); ``prefix`` opens
        its log line and the error of a segment without progress."""
        e_np = energies[:n_seg][:done]
        ke_np = energies[n_seg:2 * n_seg][:done]
        dof = 3 * len(self.s.pos) - 3
        self.result.energies.extend(float(x) for x in e_np)
        self.result.kinetic.extend(float(x) for x in ke_np)
        self.result.temperatures.extend(
            float(2 * k / (dof * KB_EV)) for k in ke_np)
        self.result.segments.append(done)
        if logger is not None and done:
            logger.writeline(
                f'{prefix}segment: {done:4d} steps  '
                f'E_pot {e_np[-1]:14.6f}  E_kin {ke_np[-1]:10.6f}'
            )
        if done == 0:
            raise RuntimeError(
                f'{prefix}MD segment made no progress (skin trip at step 0 '
                'after a fresh rebuild should be impossible)'
            )

    def run_device_halo(self, n_steps: int, seg_steps: int = 50,
                        logger=None) -> MDResult:
        """NVE over the halo decomposition with the state on the device
        (JAX ``run_device_halo``): segments of up to ``seg_steps``
        velocity-Verlet steps in plan layout (``vv_segment``, JAX
        ``make_halo_md_segment``), each ending early once the global
        largest displacement since the segment's plan passes skin/2 (one
        all-reduce MAX a step keeps the processes in step); the host then
        rebuilds the plan from every rank's positions.  Per segment the
        energies are summed over processes and the state gathered once.

        Capacity hysteresis: plan capacities only grow (cap_hints floors
        with 15% headroom), so the padded shapes -- and the kernels'
        launch plans -- stay the same across a trajectory's rebuilds."""
        if self.halo_cfg is None:
            raise ValueError('run_device_halo needs halo=dict(...)')
        import torch.distributed as dist

        from .parallel import data_parallel as dp
        from .parallel.halo import (build_halo_plan, gather_forces,
                                    make_halo_forward)

        spec = self.calc.spec
        _refuse_capped(spec, 'run_device_halo')
        n_dev = self.halo_cfg['n_dev']
        skin = float(self.skin)

        def qpad(x, q=8):
            return max(q, int(np.ceil(x / q)) * q)

        def build_plan():
            plan = build_halo_plan(
                self.s, spec.cutoff + skin, dict(spec.type_map), n_dev,
                cap_hints=self._hcaps or None,
            )
            got = dict(
                n_local=plan.n_local, n_edge=plan.n_edge,
                loc=plan.edge_loc['idx'].shape[2],
                gh=plan.edge_gh['idx'].shape[2],
                stage=[st.cap for st in plan.stages],
            )
            grown = False
            for k in ('n_local', 'n_edge', 'loc', 'gh'):
                if got[k] > self._hcaps.get(k, 0):
                    self._hcaps[k] = qpad(int(got[k] * 1.15))
                    grown = True
            old_st = self._hcaps.get('stage', [])
            new_st = []
            for i, c in enumerate(got['stage']):
                prev = old_st[i] if i < len(old_st) else 0
                if c > prev:
                    new_st.append(qpad(int(c * 1.15)))
                    grown = True
                else:
                    new_st.append(prev)
            self._hcaps['stage'] = new_st
            if grown:
                # bake the headroom into the padded shapes so the next
                # thermal creep is absorbed without a new shape
                plan = build_halo_plan(
                    self.s, spec.cutoff + skin, dict(spec.type_map),
                    n_dev, cap_hints=self._hcaps,
                )
            return make_halo_forward(self.calc.model, plan)

        fwd = build_plan()
        f_glob = None
        remaining = n_steps
        thr = (skin / 2) ** 2

        def forces(pos):
            e, f, _ = fwd.energy_forces(pos)
            return f, e

        def max_over_ranks(disp):
            return dp.all_reduce_(disp.reshape(1), dist.ReduceOp.MAX)

        with torch.no_grad():
            while remaining > 0:
                pos = _held(fwd, self.s.pos)
                vel = _held(fwd, self.vel)
                m = _held(fwd, self.masses[:, None], fill=1.0)
                # the previous segment's last forces, carried through the
                # global layout (atoms may have changed bricks): exact
                # under the fresh skin-padded edge list
                f = (fwd.energy_forces(pos)[1] if f_glob is None
                     else _held(fwd, f_glob))
                pos, vel, f, done, e_buf, ke_buf = vv_segment(
                    forces, pos, vel, m, f,
                    fwd.node_mask.reshape(pos.shape[:-1]), float(self.dt),
                    thr, min(seg_steps, remaining), seg_steps,
                    max_over_ranks if fwd.distributed else None)
                # the segment's one sum over processes and one host copy
                energies = torch.cat([e_buf, ke_buf])
                if fwd.distributed:
                    dp.all_reduce_(energies)
                self._record_segment(energies.cpu().numpy(), seg_steps,
                                     done, logger, 'halo ')
                remaining -= done
                self.result.transport_seconds += fwd.transport.seconds
                state = gather_forces(fwd.plan, _all_ranks(
                    fwd, torch.cat([pos, vel, f], dim=-1)))
                self.s.pos = state[:, :3].astype(float)
                self.vel = state[:, 3:6].astype(float)
                f_glob = state[:, 6:]
                if remaining > 0:
                    fwd = build_plan()
        return self.result

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
