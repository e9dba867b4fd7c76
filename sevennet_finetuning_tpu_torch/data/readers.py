"""Extended XYZ reader (host-side numpy).

Copy of ``read_extxyz`` from ``sevennet_finetuning_tpu/data/readers.py``;
parsing and the stress convention (internal = negated Voigt, xx yy zz xy
yz zx, eV/A^3) are unchanged.
"""

from __future__ import annotations

import re
from typing import List, Optional

import numpy as np

from .vasp import Structure


def _matrix_to_internal_stress(m: np.ndarray) -> np.ndarray:
    return -np.array([m[0, 0], m[1, 1], m[2, 2],
                      m[0, 1], m[1, 2], m[2, 0]])


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
                # 6 components: this repo's legacy on-disk form, the
                # internal convention verbatim, unless tagged as ASE Voigt
                if kv.get('stress_convention') == 'ase_voigt':
                    stress = -sv[[0, 1, 2, 5, 3, 4]]
                else:
                    stress = sv
        out.append(Structure(
            species=species, pos=pos, cell=cell, pbc=pbc, energy=energy,
            forces=forces, stress=stress, info={'file': path},
        ))
        i += 2 + n
    return out
