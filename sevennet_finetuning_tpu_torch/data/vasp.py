"""The Structure record of the data layer (host-side).

Copy of ``Structure`` from ``sevennet_finetuning_tpu/data/vasp.py``; the
OUTCAR and structure_list readers there are not ported yet.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

from .elements import symbol_to_z


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
