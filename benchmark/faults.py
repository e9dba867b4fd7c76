"""Faults planted in the program underneath a run, to show that the
comparison deciding ``correct`` catches them: a step that returns its
state unchanged, half of the batch left out with the mean taken over the
rest, an answer altered where it is produced, and in MD the integrator's
update of positions and velocities left out or taken with the wrong time
step.  Each takes ``patch(obj,
name, value)`` (pytest's ``monkeypatch.setattr``, or ``setattr`` in a run
of ``run.py --fault``, which only reads the readings it gives)."""

from __future__ import annotations

import torch


def train_state_unchanged(patch):
    """Adam steps, then every parameter is put back."""
    step = torch.optim.Adam.step

    def unchanged(self, *a, **k):
        keep = [p.detach().clone() for g in self.param_groups
                for p in g['params']]
        out = step(self, *a, **k)
        with torch.no_grad():
            for p, k0 in zip((p for g in self.param_groups
                              for p in g['params']), keep):
                p.copy_(k0)
        return out

    patch(torch.optim.Adam, 'step', unchanged)


def train_half_batch(patch):
    """Every masked mean of the loss over the first half of its rows."""
    from sevennet_finetuning_tpu_torch.train import loss

    mean = loss._masked_mean

    def half(err, mask, weights=None):
        mask = mask.clone()
        mask[mask.shape[0] // 2:] = False
        return mean(err, mask, weights)

    patch(loss, '_masked_mean', half)


def train_answer_altered(patch):
    """The force term half as high again."""
    from sevennet_finetuning_tpu_torch.train import loss

    force = loss.force_loss
    patch(loss, 'force_loss', lambda *a, **k: force(*a, **k) * 1.5)


def serve_state_unchanged(patch):
    """Each structure size answered with its first result."""
    from sevennet_finetuning_tpu_torch.calculator import Calculator

    calc = Calculator.calculate
    first = {}

    def stale(self, s):
        if len(s) not in first:
            first[len(s)] = calc(self, s)
        return first[len(s)]

    patch(Calculator, 'calculate', stale)


def forces_altered(patch):
    """The model's forces 1% high."""
    from sevennet_finetuning_tpu_torch import calculator
    from sevennet_finetuning_tpu_torch import keys as K
    from sevennet_finetuning_tpu_torch.model import nequip

    apply = nequip.apply_model

    def altered(*a, **k):
        out = apply(*a, **k)
        out[K.PRED_FORCE] = out[K.PRED_FORCE] * 1.01
        return out

    patch(nequip, 'apply_model', altered)
    patch(calculator, 'apply_model', altered)


def md_state_unchanged(patch):
    """Forces taken at the segment's first positions."""
    from sevennet_finetuning_tpu_torch import keys as K
    from sevennet_finetuning_tpu_torch.md import VelocityVerlet

    forces = VelocityVerlet._device_forces

    def stale(self, batch, pos):
        return forces(self, batch, batch[K.POS])

    patch(VelocityVerlet, '_device_forces', stale)


def _md_time_step(patch, factor):
    from sevennet_finetuning_tpu_torch.md import VelocityVerlet

    run = VelocityVerlet.run_device

    def scaled(self, *a, **k):
        dt = self.dt
        self.dt = dt * factor
        try:
            return run(self, *a, **k)
        finally:
            self.dt = dt

    patch(VelocityVerlet, 'run_device', scaled)


def md_positions_unchanged(patch):
    """Every step with a time step of nought: the positions and the
    velocities stay as they were."""
    _md_time_step(patch, 0.0)


def md_wrong_time_step(patch):
    """Every step with a time step a tenth too long."""
    _md_time_step(patch, 1.1)


FAULTS = {
    'sevennet0.reewc_train': {'state_unchanged': train_state_unchanged,
                              'half_batch': train_half_batch,
                              'answer_altered': train_answer_altered},
    'mace_mp0_medium_widths.serve_mix': {
        'state_unchanged': serve_state_unchanged,
        'answer_altered': forces_altered},
    'sevennet0.md_nve_6144': {'state_unchanged': md_state_unchanged,
                              'positions_unchanged': md_positions_unchanged,
                              'wrong_time_step': md_wrong_time_step,
                              'answer_altered': forces_altered},
}
