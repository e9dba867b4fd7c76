"""Plain reference of a velocity-Verlet step, checked on three consecutive
positions of a trajectory.

With a = F / m and the half-kick / drift / half-kick of velocity Verlet,
two consecutive steps satisfy x_{k+1} = 2 x_k - x_{k-1} + dt^2 a(x_k), and
the velocity after step k is (x_k - x_{k-1}) / dt + dt a(x_k) / 2.  The
reference computes a(x_k) from its own forces at x_k (its own neighbor
list, within the cutoff) and compares the next position, the kinetic
energy, the potential energy and the forces that the program reported.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

# 1 eV / A / amu in A / fs^2
ACC_UNIT = 9.6485332e-3


def reference_step(ref, structure: Dict, type_map, masses: np.ndarray,
                   dt: float, x_prev: np.ndarray, x_k: np.ndarray):
    """The reference at x_k: (potential energy, forces, the next position
    2 x_k - x_{k-1} + dt^2 a, the kinetic energy after the step, the
    largest |dt^2 a|), in float64 from float32 positions."""
    from .graph import batch_graphs

    s = dict(structure, pos=np.asarray(x_k, np.float64))
    g = batch_graphs([s], ref.spec.cutoff, type_map, ref.device)
    g['pos'] = torch.as_tensor(np.asarray(x_k, np.float32), device=ref.device)
    energy, forces, _ = ref.evaluate(g)
    F = forces.double().cpu().numpy()
    m = np.asarray(masses, np.float64)[:, None]
    a = F / m * ACC_UNIT
    x_prev, x_k = (np.asarray(v, np.float64) for v in (x_prev, x_k))
    vel = (x_k - x_prev) / dt + 0.5 * dt * a
    return (float(energy[0]), F, 2 * x_k - x_prev + dt * dt * a,
            float(0.5 * np.sum(m * vel * vel) / ACC_UNIT),
            float(np.abs(dt * dt * a).max()))


def gaps(got, want) -> Dict[str, float]:
    """Relative gaps of (energy, forces, next position, kinetic energy)
    ``got`` against the reference step ``want``."""
    e, f, x_next, ke = got
    E, F, pred, KE, step = want
    return {
        'energy': abs(e - E) / abs(E),
        'forces': float(np.abs(np.asarray(f, np.float64) - F).max()
                        / np.abs(F).max()),
        'position': float(np.abs(pred - np.asarray(x_next, np.float64)
                                 ).max() / step),
        'kinetic': abs(ke - KE) / KE,
    }
