"""Optimizer and LR schedulers, reference-compatible registry.

Port of ``sevennet_finetuning_tpu/train/optim.py``.  The epoch-based LR
controllers (torch scheduler semantics, reference: sevenn/train/optim.py:
6-29) are plain Python and copied as they are.  The optimizer is
``torch.optim.Adam`` over the trainable leaves only: it computes optax's
adam, lr * m_hat / (sqrt(v_hat) + eps) with eps outside the root, and a
frozen leaf (the trainable mask, ``model.nequip.trainable_mask``) is
never handed to it, so it neither moves nor keeps moments -- what
``optax.masked`` + ``set_to_zero`` arranges in the JAX package.  Other
optimizers are not ported yet and raise ``NotImplementedError``.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch

from .. import keys as K


# ---------------------------------------------------------------------------
# LR controllers (torch scheduler semantics, epoch-based)
# ---------------------------------------------------------------------------

class LRController:
    """Tracks the current LR across epochs; step() after each epoch."""

    def __init__(self, base_lr: float):
        self.base_lr = base_lr
        self.lr = base_lr
        self.epoch = 0

    def step(self, metric: Optional[float] = None):
        self.epoch += 1
        self.lr = self._lr_at(self.epoch)

    def _lr_at(self, epoch: int) -> float:
        return self.base_lr

    def state_dict(self) -> Dict:
        return {'epoch': self.epoch, 'lr': self.lr}

    def load_state_dict(self, d: Dict):
        self.epoch = d['epoch']
        self.lr = d['lr']


class ExponentialLR(LRController):
    def __init__(self, base_lr, gamma: float):
        self.gamma = gamma
        super().__init__(base_lr)

    def _lr_at(self, epoch):
        return self.base_lr * self.gamma ** epoch


class StepLR(LRController):
    def __init__(self, base_lr, step_size: int, gamma: float = 0.1):
        self.step_size = step_size
        self.gamma = gamma
        super().__init__(base_lr)

    def _lr_at(self, epoch):
        return self.base_lr * self.gamma ** (epoch // self.step_size)


class MultiStepLR(LRController):
    def __init__(self, base_lr, milestones, gamma: float = 0.1):
        self.milestones = sorted(milestones)
        self.gamma = gamma
        super().__init__(base_lr)

    def _lr_at(self, epoch):
        n = sum(1 for m in self.milestones if m <= epoch)
        return self.base_lr * self.gamma ** n


class CosineAnnealingLR(LRController):
    def __init__(self, base_lr, T_max: int, eta_min: float = 0.0):
        self.T_max = T_max
        self.eta_min = eta_min
        super().__init__(base_lr)

    def _lr_at(self, epoch):
        return self.eta_min + 0.5 * (self.base_lr - self.eta_min) * (
            1 + math.cos(math.pi * epoch / self.T_max)
        )


class LinearLR(LRController):
    def __init__(self, base_lr, start_factor: float = 1.0 / 3,
                 end_factor: float = 1.0, total_iters: int = 5):
        self.start_factor = start_factor
        self.end_factor = end_factor
        self.total_iters = total_iters
        super().__init__(base_lr)
        self.lr = self._lr_at(0)

    def _lr_at(self, epoch):
        t = min(epoch, self.total_iters) / self.total_iters
        f = self.start_factor + (self.end_factor - self.start_factor) * t
        return self.base_lr * f


class ReduceLROnPlateau(LRController):
    def __init__(self, base_lr, factor: float = 0.1, patience: int = 10,
                 threshold: float = 1e-4, min_lr: float = 0.0,
                 mode: str = 'min', **_):
        self.factor = factor
        self.patience = patience
        self.threshold = threshold
        self.min_lr = min_lr
        self.mode = mode
        self.best = None
        self.num_bad = 0
        super().__init__(base_lr)

    def step(self, metric: Optional[float] = None):
        self.epoch += 1
        if metric is None:
            return
        better = (
            self.best is None
            or (self.mode == 'min'
                and metric < self.best * (1 - self.threshold))
            or (self.mode == 'max'
                and metric > self.best * (1 + self.threshold))
        )
        if better:
            self.best = metric
            self.num_bad = 0
        else:
            self.num_bad += 1
            if self.num_bad > self.patience:
                self.lr = max(self.lr * self.factor, self.min_lr)
                self.num_bad = 0


class CosineAnnealingWarmupRestarts(LRController):
    """Warmup + cosine decay with warm restarts, matching the external
    ``cosine_annealing_warmup`` package the reference registers as
    'cosineannealingwarmuplr' (reference: sevenn/train/optim.py:4,23) --
    the scheduler of the shipped fine-tune recipe
    (example_inputs/fine_tuning/FT_w_reEWC/input_full.yaml).

    Per cycle: LR ramps linearly min_lr -> max_lr over ``warmup_steps``,
    then cosine-decays back to min_lr over the cycle remainder; cycle
    length multiplies by ``cycle_mult`` and max_lr by ``gamma`` at each
    restart.  The optimizer's own lr is ignored, as in the reference."""

    def __init__(self, base_lr, first_cycle_steps: int,
                 cycle_mult: float = 1.0, max_lr: float = 0.1,
                 min_lr: float = 0.001, warmup_steps: int = 0,
                 gamma: float = 1.0):
        assert warmup_steps < first_cycle_steps
        self.first_cycle_steps = int(first_cycle_steps)
        self.cycle_mult = float(cycle_mult)
        self.max_lr = float(max_lr)
        self.min_lr = float(min_lr)
        self.warmup_steps = int(warmup_steps)
        self.gamma = float(gamma)
        super().__init__(base_lr)
        self.lr = self._lr_at(0)

    def _lr_at(self, epoch):
        n = epoch
        cycle = 0
        cycle_steps = self.first_cycle_steps
        while n >= cycle_steps:
            n -= cycle_steps
            cycle += 1
            cycle_steps = int(
                (cycle_steps - self.warmup_steps) * self.cycle_mult
                + self.warmup_steps
            )
        cur_max = self.max_lr * self.gamma ** cycle
        if n < self.warmup_steps:
            return (cur_max - self.min_lr) * n / self.warmup_steps \
                + self.min_lr
        return self.min_lr + 0.5 * (cur_max - self.min_lr) * (
            1 + math.cos(
                math.pi * (n - self.warmup_steps)
                / (cycle_steps - self.warmup_steps)
            )
        )


SCHEDULERS = {
    'cosineannealingwarmuplr': CosineAnnealingWarmupRestarts,
    'exponentiallr': ExponentialLR,
    'steplr': StepLR,
    'multisteplr': MultiStepLR,
    'cosineannealinglr': CosineAnnealingLR,
    'linearlr': LinearLR,
    'reducelronplateau': ReduceLROnPlateau,
    'constant': LRController,
}


# ---------------------------------------------------------------------------
# optimizer
# ---------------------------------------------------------------------------

def build_optimizer(config: Dict, params: Dict[str, Dict[str, torch.nn.Parameter]],
                    trainable_mask: Dict[str, Dict[str, bool]]):
    """(torch.optim.Adam over the trainable leaves, LRController).  The
    controller's LR is written into the optimizer by ``set_lr``."""
    optim_param = dict(config.get(K.OPTIM_PARAM, {}))
    lr = float(optim_param.pop('lr', 1e-3))
    name = str(config.get(K.OPTIMIZER, 'adam')).lower()
    if name != 'adam':
        raise NotImplementedError(f'optimizer {name!r} is not ported yet '
                                  '(adam is)')
    sched_name = config.get(K.SCHEDULER, 'constant')
    sched_param = dict(config.get(K.SCHEDULER_PARAM, {}))
    controller = SCHEDULERS[sched_name.lower()](lr, **sched_param)
    leaves = [p for group, names in params.items()
              for name, p in names.items() if trainable_mask[group][name]]
    betas = tuple(optim_param.get('betas', (0.9, 0.999)))
    opt = torch.optim.Adam(leaves, lr=controller.lr, betas=betas,
                           eps=optim_param.get('eps', 1e-8))
    return opt, controller


def set_lr(optimizer: torch.optim.Optimizer, lr: float) -> None:
    """Write the controller's LR into every param group."""
    for group in optimizer.param_groups:
        group['lr'] = lr
