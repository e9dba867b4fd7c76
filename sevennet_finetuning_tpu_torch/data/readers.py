"""Structure file readers beyond OUTCAR: POSCAR, extended XYZ, ase.

Copy of ``sevennet_finetuning_tpu/data/readers.py``: ``read_poscar``,
``write_extxyz`` / ``read_extxyz`` (internal stress = negated Voigt, xx
yy zz xy yz zx, eV/A^3; the files carry the ASE 3x3 convention),
``read_ase`` and ``read_atoms_pkl`` (ase imported only when called).
"""

from __future__ import annotations

import re
from typing import List, Optional

import numpy as np

from .vasp import Structure


def read_poscar(path: str) -> Structure:
    """VASP POSCAR/CONTCAR (v5+: symbol line present).  Unlabeled
    (no energy/forces) -- inference / MD input."""
    with open(path) as f:
        lines = [ln.rstrip('\n') for ln in f]
    scale = float(lines[1].split()[0])
    cell = np.array([[float(x) for x in lines[2 + k].split()[:3]]
                     for k in range(3)])
    if scale < 0:  # negative scale = target volume
        vol = abs(np.linalg.det(cell))
        scale = (-scale / vol) ** (1.0 / 3.0)
    cell = cell * scale

    symbols = lines[5].split()
    if symbols and symbols[0].isdigit():
        raise ValueError(
            f'{path}: VASP4 POSCAR without symbol line is not supported'
        )
    counts = [int(x) for x in lines[6].split()]
    species: List[str] = []
    for sym, cnt in zip(symbols, counts):
        species.extend([sym] * cnt)
    n = len(species)

    i = 7
    if lines[i].strip() and lines[i].strip()[0] in 'sS':
        i += 1  # selective dynamics
    direct = lines[i].strip()[0] in 'dD'
    i += 1
    pos = np.array([[float(x) for x in lines[i + k].split()[:3]]
                    for k in range(n)])
    if direct:
        pos = pos @ cell
    else:
        pos = pos * scale
    return Structure(species=species, pos=pos, cell=cell,
                     info={'file': path})


def _internal_stress_to_matrix(s: np.ndarray) -> np.ndarray:
    """Internal 6-component stress (negated, xx yy zz xy yz zx order;
    reference: sevenn/train/dataload.py:104-105) -> standard ASE 3x3
    stress matrix in eV/A^3."""
    s = np.asarray(s, float)
    return -np.array([
        [s[0], s[3], s[5]],
        [s[3], s[1], s[4]],
        [s[5], s[4], s[2]],
    ])


def _matrix_to_internal_stress(m: np.ndarray) -> np.ndarray:
    return -np.array([m[0, 0], m[1, 1], m[2, 2],
                      m[0, 1], m[1, 2], m[2, 0]])


def write_extxyz(path: str, structures: List[Structure]) -> None:
    """Write frames in standard extended XYZ (Lattice / Properties /
    energy / 9-component ``stress=`` in the ASE convention, eV/A^3) --
    interoperable with ase.io.read; ``read_extxyz`` converts back to the
    internal (negated Voigt) convention on load."""
    with open(path, 'w') as f:
        for s in structures:
            f.write(f'{len(s)}\n')
            lat = ' '.join(f'{x:.10f}' for x in np.asarray(s.cell).ravel())
            kv = [f'Lattice="{lat}"']
            props = 'species:S:1:pos:R:3'
            if s.forces is not None:
                props += ':forces:R:3'
            kv.append(f'Properties={props}')
            if s.energy is not None:
                kv.append(f'energy={s.energy:.10f}')
            if s.stress is not None:
                m = _internal_stress_to_matrix(s.stress)
                kv.append('stress="' + ' '.join(
                    f'{x:.10f}' for x in m.ravel()) + '"')
            kv.append('pbc="' + ' '.join(
                'T' if p else 'F' for p in s.pbc) + '"')
            f.write(' '.join(kv) + '\n')
            for a in range(len(s)):
                row = f'{s.species[a]} ' + ' '.join(
                    f'{x:.10f}' for x in s.pos[a])
                if s.forces is not None:
                    row += ' ' + ' '.join(
                        f'{x:.10f}' for x in s.forces[a])
                f.write(row + '\n')


def read_ase(path: str, **fmt_args) -> List[Structure]:
    """Arbitrary-format reader through ``ase.io.read`` (the reference's
    default dispatch for unknown formats with ``data_format_args``
    passthrough, reference: sevenn/train/dataload.py:330-344).  Lazy ase
    import: only usable where ase is installed."""
    import ase.io

    fmt_args.setdefault('index', ':')
    atoms_list = ase.io.read(path, **fmt_args)
    if not isinstance(atoms_list, list):
        atoms_list = [atoms_list]
    return atoms_list_to_structures(atoms_list, path)


def atoms_list_to_structures(atoms_list, path: str) -> List[Structure]:
    """ase.Atoms frames -> labeled Structures (energy/forces/stress
    pulled from each frame's calculator when present; warns when frames
    come back unlabeled)."""
    out: List[Structure] = []
    n_no_energy = n_no_forces = 0
    for atoms in atoms_list:
        energy = forces = stress = None
        try:
            energy = float(atoms.get_potential_energy(force_consistent=True))
        except Exception:
            try:
                energy = float(atoms.get_potential_energy())
            except Exception:
                pass
        try:
            forces = np.asarray(atoms.get_forces(apply_constraint=False),
                                float)
        except Exception:
            pass
        try:
            # ase Voigt (xx yy zz yz xz xy) -> ours (xx yy zz xy yz zx),
            # sign flipped (reference: sevenn/train/dataload.py:104-105)
            sv = np.asarray(atoms.get_stress(voigt=True), float)
            stress = -sv[[0, 1, 2, 5, 3, 4]]
        except Exception:
            pass
        n_no_energy += energy is None
        n_no_forces += forces is None
        out.append(Structure(
            species=list(atoms.get_chemical_symbols()),
            pos=np.asarray(atoms.get_positions(), float),
            cell=np.asarray(atoms.get_cell()[:], float),
            pbc=tuple(bool(p) for p in atoms.get_pbc()),
            energy=energy, forces=forces, stress=stress,
            info={'file': path},
        ))
    if n_no_energy or n_no_forces:
        import warnings

        warnings.warn(
            f'{path}: {n_no_energy}/{len(out)} frames without energy, '
            f'{n_no_forces}/{len(out)} without forces -- these cannot be '
            'used as labeled training data (check data_format/calculator)'
        )
    return out


def read_atoms_pkl(path: str) -> List[Structure]:
    """Pickled list of ase.Atoms (reference ``data_format: pkl``,
    reference: sevenn/train/dataload.py:199-210).  Only unpickle files
    you trust -- pickle executes arbitrary code by design."""
    import pickle

    with open(path, 'rb') as f:
        atoms_list = pickle.load(f)
    if not isinstance(atoms_list, list):
        raise TypeError(f'{path}: pkl content is not a list')
    try:
        import ase

        ok = not atoms_list or isinstance(atoms_list[0], ase.Atoms)
    except ImportError:  # ase-free: accept Atoms-like duck types
        ok = not atoms_list or all(
            hasattr(atoms_list[0], m)
            for m in ('get_positions', 'get_chemical_symbols', 'get_cell')
        )
    if not ok:
        raise TypeError(f'{path}: pkl content is not a list of ase.Atoms')
    return atoms_list_to_structures(atoms_list, path)


_KV_RE = re.compile(
    r'(\w+)=(?:"([^"]*)"|(\S+))'
)


def read_extxyz(path: str) -> List[Structure]:
    """Extended XYZ: all frames, with Lattice / Properties / energy /
    stress parsed from the comment line when present."""
    out: List[Structure] = []
    with open(path) as f:
        lines = f.readlines()
    i = 0
    while i < len(lines):
        if not lines[i].strip():
            i += 1
            continue
        n = int(lines[i].split()[0])
        comment = lines[i + 1]
        kv = {m.group(1): (m.group(2) if m.group(2) is not None
                           else m.group(3))
              for m in _KV_RE.finditer(comment)}

        cell = np.eye(3)
        pbc = (False, False, False)
        if 'Lattice' in kv:
            vals = [float(x) for x in kv['Lattice'].split()]
            cell = np.array(vals).reshape(3, 3)
            pbc = (True, True, True)
        if 'pbc' in kv:
            pbc = tuple(t in ('T', 'True', '1') for t in kv['pbc'].split())

        # column layout from Properties=species:S:1:pos:R:3:forces:R:3...
        cols = []
        props = kv.get('Properties', 'species:S:1:pos:R:3')
        toks = props.split(':')
        for k in range(0, len(toks) - 2, 3):
            cols.append((toks[k], int(toks[k + 2])))

        species: List[str] = []
        pos = np.zeros((n, 3))
        forces: Optional[np.ndarray] = None
        if any(name == 'forces' for name, _ in cols):
            forces = np.zeros((n, 3))
        for a in range(n):
            parts = lines[i + 2 + a].split()
            c = 0
            for name, width in cols:
                if name == 'species':
                    species.append(parts[c])
                elif name == 'pos':
                    pos[a] = [float(x) for x in parts[c:c + 3]]
                elif name == 'forces' and forces is not None:
                    forces[a] = [float(x) for x in parts[c:c + 3]]
                c += width

        energy = None
        for ekey in ('energy', 'free_energy'):
            if ekey in kv:
                energy = float(kv[ekey])
                break
        stress = None
        if 'stress' in kv:
            sv = np.array([float(x) for x in kv['stress'].split()])
            if sv.size == 9:  # row-major 3x3, ASE convention, eV/A^3
                stress = _matrix_to_internal_stress(sv.reshape(3, 3))
            elif sv.size == 6:
                # 6-component stress is this repo's LEGACY on-disk form:
                # the internal convention verbatim (negated virial, order
                # xx yy zz xy yz zx -- what the pre-round-4 write_extxyz
                # emitted).  It must stay readable as written: briefly
                # interpreting it as ASE Voigt silently sign-flipped and
                # permuted the off-diagonals of every legacy file
                # (round-3 advisor finding).  ASE-convention Voigt input
                # must carry an explicit tag to be treated as such; the
                # current writer always emits the unambiguous 9-component
                # matrix form.
                if kv.get('stress_convention') == 'ase_voigt':
                    # tagged ASE Voigt (xx yy zz yz xz xy, positive)
                    stress = -sv[[0, 1, 2, 5, 3, 4]]
                else:
                    stress = sv
        out.append(Structure(
            species=species, pos=pos, cell=cell, pbc=pbc, energy=energy,
            forces=forces, stress=stress, info={'file': path},
        ))
        i += 2 + n
    return out
