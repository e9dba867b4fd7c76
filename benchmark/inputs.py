"""The benchmark's inputs: structures read from the repository's extxyz
files by the benchmark's own reader, replicated and rattled from a seed.

A structure is a dict of numpy arrays and builtins: ``numbers`` (atomic
numbers), ``symbols``, ``pos`` [N, 3] A, ``cell`` [3, 3] (rows are the
lattice vectors), ``pbc``, and where the file has them the labels
``energy`` (eV), ``forces`` [N, 3] (eV/A) and ``stress`` (6,) (eV/A^3,
xx yy zz xy yz zx, the negated virial: the 9-component ASE stress of the
file, negated).  The same dicts go to the program (as its ``Structure``)
and to the reference.
"""

from __future__ import annotations

import re
from pathlib import Path
from typing import Dict, List

import numpy as np

SYMBOLS = (
    'X H He Li Be B C N O F Ne Na Mg Al Si P S Cl Ar K Ca Sc Ti V Cr Mn Fe '
    'Co Ni Cu Zn Ga Ge As Se Br Kr Rb Sr Y Zr Nb Mo Tc Ru Rh Pd Ag Cd In Sn '
    'Sb Te I Xe Cs Ba La Ce Pr Nd Pm Sm Eu Gd Tb Dy Ho Er Tm Yb Lu Hf Ta W '
    'Re Os Ir Pt Au Hg Tl Pb Bi Po At Rn Fr Ra Ac Th Pa U Np Pu Am Cm Bk Cf '
    'Es Fm').split()
Z_OF = {s: z for z, s in enumerate(SYMBOLS)}
# standard atomic weights (amu) of the elements the cells hold
MASSES = {'H': 1.008, 'O': 15.999, 'Si': 28.085, 'Hf': 178.49}

_KV = re.compile(r'(\w+)=(?:"([^"]*)"|(\S+))')


def read_extxyz(path) -> List[Dict]:
    """Every frame of an extended-XYZ file (Lattice, Properties with
    species, pos and forces, energy, a 9-component stress)."""
    lines = Path(path).read_text().splitlines()
    out, i = [], 0
    while i < len(lines):
        if not lines[i].strip():
            i += 1
            continue
        n = int(lines[i].split()[0])
        kv = {m.group(1): m.group(2) if m.group(2) is not None
              else m.group(3) for m in _KV.finditer(lines[i + 1])}
        toks = kv.get('Properties', 'species:S:1:pos:R:3').split(':')
        cols, c = {}, 0
        for k in range(0, len(toks) - 2, 3):
            cols[toks[k]] = (c, int(toks[k + 2]))
            c += int(toks[k + 2])
        rows = [lines[i + 2 + a].split() for a in range(n)]
        sym = [r[cols['species'][0]] for r in rows]
        c0 = cols['pos'][0]
        s = {'symbols': sym,
             'numbers': np.array([Z_OF[x] for x in sym], np.int64),
             'pos': np.array([[float(v) for v in r[c0:c0 + 3]]
                              for r in rows]),
             'cell': np.array([float(v) for v in kv['Lattice'].split()]
                              ).reshape(3, 3),
             'pbc': (True, True, True)}
        if 'forces' in cols:
            f0 = cols['forces'][0]
            s['forces'] = np.array([[float(v) for v in r[f0:f0 + 3]]
                                    for r in rows])
        if 'energy' in kv:
            s['energy'] = float(kv['energy'])
        if 'stress' in kv:
            m = np.array([float(v) for v in kv['stress'].split()]
                         ).reshape(3, 3)
            s['stress'] = -np.array([m[0, 0], m[1, 1], m[2, 2], m[0, 1],
                                     m[1, 2], m[2, 0]])
        out.append(s)
        i += 2 + n
    return out


def replicate(s: Dict, reps) -> Dict:
    """The periodic supercell of ``s``, ``reps`` = (nx, ny, nz) copies
    (unlabelled)."""
    nx, ny, nz = reps
    shifts = [np.array([a, b, c], float) @ s['cell']
              for a in range(nx) for b in range(ny) for c in range(nz)]
    return {'symbols': list(s['symbols']) * len(shifts),
            'numbers': np.tile(s['numbers'], len(shifts)),
            'pos': np.concatenate([s['pos'] + sh for sh in shifts]),
            'cell': s['cell'] * np.array([[nx], [ny], [nz]], float),
            'pbc': s['pbc']}


def rattle(s: Dict, sigma: float, rng: np.random.Generator) -> Dict:
    out = dict(s)
    out['pos'] = s['pos'] + rng.normal(scale=sigma, size=s['pos'].shape)
    return out


def to_program(s: Dict):
    """``s`` as the program's ``Structure``."""
    from sevennet_finetuning_tpu_torch.data.vasp import Structure

    return Structure(species=list(s['symbols']), pos=np.array(s['pos']),
                     cell=np.array(s['cell']), pbc=tuple(s['pbc']),
                     energy=s.get('energy'), forces=s.get('forces'),
                     stress=s.get('stress'))
