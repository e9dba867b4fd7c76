"""Minimal VASP OUTCAR reader + structure_list files (host-side).

Copy of ``sevennet_finetuning_tpu/data/vasp.py``: ``Structure``,
``replicate``, ``read_outcar``, ``brace_expand``, ``_parse_index`` and
``read_structure_list``, unchanged.  ``read_outcar`` extracts, per ionic
step: species, cell, positions, forces, free energy (TOTEN,
force-consistent) and stress, taken from the "in kB" line (already in
the xx, yy, zz, xy, yz, zx order and sign convention the reference
trains on) and converted from kbar to eV/A^3.
"""

from __future__ import annotations

import os
import re
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

from .elements import symbol_to_z

KBAR_PER_EV_A3 = 1602.1766208

_FLOAT_RE = re.compile(r'[-+]?\d+\.\d*(?:[eE][-+]?\d+)?|[-+]?\d+')


def _floats(line: str) -> List[float]:
    """All floats on a line, robust to VASP's run-together fixed columns
    (e.g. '0.000000000-10.371119000')."""
    return [float(t) for t in _FLOAT_RE.findall(line)]


@dataclass
class Structure:
    """One atomic configuration with (optionally) labels."""

    species: List[str]
    pos: np.ndarray                     # (N, 3) Angstrom, cartesian
    cell: np.ndarray                    # (3, 3)
    pbc: tuple = (True, True, True)
    energy: Optional[float] = None      # eV (free energy TOTEN)
    forces: Optional[np.ndarray] = None  # (N, 3) eV/A
    stress: Optional[np.ndarray] = None  # (6,) eV/A^3, xx yy zz xy yz zx
    info: Dict = field(default_factory=dict)

    def __len__(self):
        return len(self.species)

    @property
    def atomic_numbers(self) -> np.ndarray:
        return np.array([symbol_to_z(s) for s in self.species])

    @property
    def volume(self) -> float:
        return float(abs(np.linalg.det(self.cell)))


def replicate(s: Structure, nx: int, ny: int, nz: int) -> Structure:
    """Periodic supercell (like LAMMPS 'replicate', reference:
    example_inputs/md_serial_example/in.lmp)."""
    reps = []
    shifts = []
    for ix in range(nx):
        for iy in range(ny):
            for iz in range(nz):
                shifts.append(np.array([ix, iy, iz], float) @ s.cell)
    pos = np.concatenate([s.pos + sh for sh in shifts])
    species = list(s.species) * len(shifts)
    cell = s.cell * np.array([[nx], [ny], [nz]])
    forces = (
        None if s.forces is None
        else np.concatenate([s.forces] * len(shifts))
    )
    energy = None if s.energy is None else s.energy * len(shifts)
    return Structure(species=species, pos=pos, cell=cell, pbc=s.pbc,
                     energy=energy, forces=forces, stress=s.stress,
                     info=dict(s.info))


def read_outcar(path: str) -> List[Structure]:
    """All ionic steps of an OUTCAR as labeled Structures."""
    with open(path) as f:
        lines = f.readlines()

    # species from POTCAR headers (first block only; VASP prints it twice)
    potcar_syms: List[str] = []
    ions_per_type: List[int] = []
    for ln in lines:
        if ln.strip().startswith('POTCAR:'):
            # e.g. "POTCAR:    PAW_PBE Hf 20Jan2003"
            tok = ln.split()[2]
            potcar_syms.append(tok.split('_')[0])
        elif 'ions per type' in ln:
            ions_per_type = [int(x) for x in ln.split('=')[1].split()]
            break
    # VASP prints the POTCAR list twice; keep the first half
    if len(ions_per_type) and len(potcar_syms) >= 2 * len(ions_per_type):
        potcar_syms = potcar_syms[: len(potcar_syms) // 2]
    species: List[str] = []
    for sym, cnt in zip(potcar_syms, ions_per_type):
        species.extend([sym] * cnt)
    natoms = len(species)

    structures: List[Structure] = []
    cell = None
    stress = None
    i = 0
    while i < len(lines):
        ln = lines[i]
        if 'direct lattice vectors' in ln:
            cell = np.array(
                [_floats(lines[i + 1 + k])[:3] for k in range(3)]
            )
            i += 4
            continue
        if ln.strip().startswith('in kB'):
            vals = _floats(ln)[:6]
            stress = np.array(vals) / KBAR_PER_EV_A3
            i += 1
            continue
        if 'POSITION' in ln and 'TOTAL-FORCE' in ln:
            pos = np.zeros((natoms, 3))
            frc = np.zeros((natoms, 3))
            for k in range(natoms):
                row = _floats(lines[i + 2 + k])
                pos[k] = row[:3]
                frc[k] = row[3:6]
            i += 2 + natoms
            # energy follows within the same ionic-step block
            energy = None
            j = i
            while j < len(lines) and j < i + 60:
                if 'free  energy   TOTEN' in lines[j]:
                    energy = float(lines[j].split('=')[1].split()[0])
                    break
                j += 1
            structures.append(
                Structure(
                    species=list(species),
                    pos=pos,
                    cell=cell.copy() if cell is not None else np.eye(3),
                    energy=energy,
                    forces=frc,
                    stress=None if stress is None else stress.copy(),
                    info={'file': os.path.abspath(path)},
                )
            )
            stress = None
            continue
        i += 1
    return structures


def brace_expand(expr: str) -> List[str]:
    """bash-style {a..b} and {a,b,c} expansion (single pass, nested ok)."""
    m = re.search(r'\{([^{}]*)\}', expr)
    if m is None:
        return [expr]
    body = m.group(1)
    pre, post = expr[: m.start()], expr[m.end():]
    rng = re.fullmatch(r'(-?\d+)\.\.(-?\d+)', body)
    if rng:
        a, b = int(rng.group(1)), int(rng.group(2))
        step = 1 if b >= a else -1
        parts = [str(v) for v in range(a, b + step, step)]
    else:
        parts = body.split(',')
    out = []
    for p in parts:
        out.extend(brace_expand(pre + p + post))
    return out


def _parse_index(expr: str) -> slice:
    """':', '2', '1:10', '::2' -> slice (ase string2index equivalent)."""
    expr = expr.strip()
    if ':' not in expr:
        v = int(expr)
        return slice(v, v + 1 if v != -1 else None)
    parts = expr.split(':')
    vals = [int(p) if p.strip() else None for p in parts]
    while len(vals) < 3:
        vals.append(None)
    return slice(*vals[:3])


def read_structure_list(path: str) -> Dict[str, List[Structure]]:
    """Parse a structure_list file: [label] headers followed by
    'file_glob : index' lines (reference: sevenn/train/dataload.py:213-300).
    Paths are relative to the structure_list file's directory."""
    base = os.path.dirname(os.path.abspath(path))
    out: Dict[str, List[Structure]] = {}
    label = 'Default'
    with open(path) as f:
        for raw in f:
            ln = raw.strip()
            if not ln:
                continue
            if ln.startswith('['):
                if not ln.endswith(']'):
                    raise ValueError(f'bad structure_list label: {ln}')
                label = ln[1:-1]
                out.setdefault(label, [])
                continue
            toks = ln.split()
            fexpr = toks[0]
            index = _parse_index(toks[1]) if len(toks) > 1 and toks[1] != ':' \
                else slice(None)
            for fname in brace_expand(fexpr):
                full = fname if os.path.isabs(fname) \
                    else os.path.join(base, fname)
                structs = read_outcar(full)[index]
                out.setdefault(label, []).extend(structs)
    return out
