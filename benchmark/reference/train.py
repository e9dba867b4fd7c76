"""Plain reference of the reEWC fine-tune step: the loss terms, their
gradient through the force pass (a double backward of the reference
model) and one adam update, written out.

Loss (per batch of real structures): Huber(delta) of the per-atom energy,
mean over structures; of each force component, mean over atoms and
components; of each stress component in kbar, mean over structures and
components; energy weight 1, force and stress weights from the recipe;
plus lambda / 2 * sum_i F_i (theta_i - theta*_i)^2 over the leaves the
Fisher file holds.  Adam: m = b1 m + (1 - b1) g, v = b2 v + (1 - b2) g^2,
theta -= lr * m / (1 - b1^t) / (sqrt(v / (1 - b2^t)) + eps).
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

TO_KBAR = 1602.1766208


def huber(a: torch.Tensor, delta: float) -> torch.Tensor:
    a = a.abs()
    return torch.where(a < delta, 0.5 * a * a, delta * (a - 0.5 * delta))


def batch_labels(structures: List[Dict], device) -> Dict[str, torch.Tensor]:
    """The labels as float32 tensors (the precision the data holds on the
    device): energy [B], forces [N, 3], stress [B, 6], atoms [B]."""
    f32 = np.float32
    return {
        'energy': torch.tensor([f32(s['energy']) for s in structures],
                               device=device),
        'forces': torch.tensor(np.concatenate(
            [np.asarray(s['forces'], f32) for s in structures]),
            device=device),
        'stress': torch.tensor(np.stack(
            [np.asarray(s['stress'], f32) for s in structures]),
            device=device),
        'natoms': torch.tensor([float(len(s['numbers'])) for s in structures],
                               device=device),
    }


class ReferenceTrainer:
    """Adam over every leaf of ``ref`` (a ``model.Reference``) under the
    recipe: ``recipe`` holds delta, force_weight, stress_weight,
    ewc_lambda, lr, betas and eps; ``fisher`` / ``anchor`` are nested
    dicts of numpy arrays."""

    def __init__(self, ref, recipe: Dict, fisher, anchor):
        self.ref = ref
        self.r = recipe
        dev = ref.device
        self.leaves = ref.leaves()
        for _, _, v in self.leaves:
            v.requires_grad_(True)
        self.fisher = {
            (g, n): torch.tensor(np.asarray(fisher[g][n], np.float32),
                                 device=dev)
            for g, n, _ in self.leaves
            if n in fisher.get(g, {}) and n in anchor.get(g, {})}
        self.anchor = {k: torch.tensor(np.asarray(anchor[k[0]][k[1]],
                                                  np.float32), device=dev)
                       for k in self.fisher}
        self.m = {(g, n): torch.zeros_like(v) for g, n, v in self.leaves}
        self.v = {(g, n): torch.zeros_like(v) for g, n, v in self.leaves}
        self.t = 0

    def loss(self, graph, labels):
        """(total, {term: value}) at the current parameters, with the
        graph kept for the parameter gradient."""
        r = self.r
        energy, forces, stress = self.ref.evaluate(graph, create_graph=True)
        d = r['delta']
        e_term = huber(energy / labels['natoms']
                       - labels['energy'] / labels['natoms'], d).mean()
        f_term = huber(forces - labels['forces'], d).mean()
        s_term = huber((stress - labels['stress']) * TO_KBAR, d).mean()
        ewc = sum(torch.sum(self.fisher[k] * (self.ref.p[k[0]][k[1]]
                                              - self.anchor[k]) ** 2)
                  for k in self.fisher)
        total = (e_term + r['force_weight'] * f_term
                 + r['stress_weight'] * s_term + r['ewc_lambda'] / 2 * ewc)
        return total, {'Energy': e_term, 'Force': f_term, 'Stress': s_term,
                       'EWC': ewc}

    def step(self, graph, labels):
        """One adam step; returns (total loss, {leaf: gradient})."""
        total, _ = self.loss(graph, labels)
        params = [v for _, _, v in self.leaves]
        grads = torch.autograd.grad(total, params)
        self.t += 1
        b1, b2 = self.r['betas']
        lr, eps = self.r['lr'], self.r['eps']
        out = {}
        with torch.no_grad():
            for (g, n, p), gr in zip(self.leaves, grads):
                k = (g, n)
                self.m[k] = b1 * self.m[k] + (1 - b1) * gr
                self.v[k] = b2 * self.v[k] + (1 - b2) * gr * gr
                m_hat = self.m[k] / (1 - b1 ** self.t)
                v_hat = self.v[k] / (1 - b2 ** self.t)
                p -= lr * m_hat / (torch.sqrt(v_hat) + eps)
                out[k] = gr.detach()
        return float(total.detach()), out
