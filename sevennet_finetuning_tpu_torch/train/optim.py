"""Optimizers and LR schedulers, reference-compatible registry.

Port of ``sevennet_finetuning_tpu/train/optim.py``.  The epoch-based LR
controllers (torch scheduler semantics, reference: sevenn/train/optim.py:
6-29) are plain Python and copied as they are.  Every optimizer runs over
the trainable leaves only: a frozen leaf (the trainable mask,
``model.nequip.trainable_mask``) is never handed to it, so it neither
moves nor keeps state -- what ``optax.masked`` + ``set_to_zero`` arranges
in the JAX package.

- adam is ``torch.optim.Adam``: lr * m_hat / (sqrt(v_hat) + eps), eps
  outside the root, as optax computes it;
- adamw, sgd (momentum, nesterov), adagrad and radam are ``OptaxRule``,
  optax's update rules written out, because ``torch.optim`` differs:
  ``optax.adagrad`` starts its accumulator at 0.1 and puts eps inside the
  square root, ``optax.radam`` rectifies from rho >= 5 (torch: > 5) with
  rho computed in float32, and optax's sgd trace is g + momentum * trace
  from a zero trace.

``optax_state_dict`` translates a JAX checkpoint's optax state (read by
``train/checkpoint.py`` without optax) into the state dict of the
optimizer built here, so a ``continue`` keeps the moments: adam's ``mu``
/ ``nu`` and shared ``count`` become ``torch.optim.Adam``'s ``exp_avg`` /
``exp_avg_sq`` / ``step``, and the other rules take their optax state's
arrays under the same names.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import numpy as np
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
# optimizers
# ---------------------------------------------------------------------------

def _int_pow_f32(x: float, n: int) -> np.float32:
    """x ** n in float32 by binary exponentiation, the bits XLA gives for
    a float raised to an int32 count."""
    acc, base = np.float32(1), np.float32(x)
    while n:
        if n & 1:
            acc = np.float32(acc * base)
        base = np.float32(base * base)
        n >>= 1
    return acc


class OptaxRule(torch.optim.Optimizer):
    """adamw, sgd, adagrad or radam, each step as optax computes it
    (``optax.adamw`` / ``sgd`` / ``adagrad`` / ``radam`` with the
    arguments the JAX package's ``_optimizer_core`` passes)."""

    RULES = ('adamw', 'sgd', 'adagrad', 'radam')

    def __init__(self, params, rule: str, lr: float,
                 betas=(0.9, 0.999), eps: float = 1e-8,
                 weight_decay: float = 1e-2, momentum: float = 0.0,
                 nesterov: bool = False,
                 initial_accumulator_value: float = 0.1):
        if rule not in self.RULES:
            raise ValueError(f'unknown optimizer: {rule}')
        self.rule = rule
        super().__init__(params, dict(
            lr=lr, betas=tuple(betas), eps=eps, weight_decay=weight_decay,
            momentum=momentum, nesterov=nesterov,
            initial_accumulator_value=initial_accumulator_value))

    def _init_state(self, p, group):
        state = self.state[p]
        if state:
            return state
        state['step'] = 0
        if self.rule in ('adamw', 'radam'):
            state['mu'] = torch.zeros_like(p)
            state['nu'] = torch.zeros_like(p)
        elif self.rule == 'sgd':
            state['trace'] = torch.zeros_like(p)
        else:
            state['sum_of_squares'] = torch.full_like(
                p, group['initial_accumulator_value'])
        return state

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            for p in group['params']:
                if p.grad is None:
                    continue
                state = self._init_state(p, group)
                state['step'] += 1
                update = getattr(self, f'_{self.rule}')(
                    p, p.grad, state, group)
                p.add_(update * -group['lr'])

    @staticmethod
    def _moments(g, state, group):
        """optax's update_moment / _per_elem_norm and bias correction."""
        b1, b2 = group['betas']
        t = state['step']
        state['mu'] = (1 - b1) * g + b1 * state['mu']
        state['nu'] = (1 - b2) * (g * g) + b2 * state['nu']
        mu_hat = state['mu'] / np.float32(1 - np.float32(b1) ** t)
        nu_hat = state['nu'] / np.float32(1 - np.float32(b2) ** t)
        return mu_hat, nu_hat

    def _adamw(self, p, g, state, group):
        mu_hat, nu_hat = self._moments(g, state, group)
        return (mu_hat / (torch.sqrt(nu_hat) + group['eps'])
                + group['weight_decay'] * p)

    def _sgd(self, p, g, state, group):
        state['trace'] = g + group['momentum'] * state['trace']
        if group['nesterov']:
            return g + group['momentum'] * state['trace']
        return state['trace']

    def _adagrad(self, p, g, state, group):
        s = g * g + state['sum_of_squares']
        state['sum_of_squares'] = s
        inv = torch.where(s > 0, torch.rsqrt(s + group['eps']),
                          torch.zeros_like(s))
        return inv * g

    def _radam(self, p, g, state, group):
        mu_hat, nu_hat = self._moments(g, state, group)
        # rho and the rectifier in float32, as optax computes them
        # (rho = 1999 - 1993.x at step 6: the cancellation turns one ulp
        # of b2^t into 3e-3 of rho)
        f32 = np.float32
        b2 = group['betas'][1]
        ro_inf = f32(2.0 / (1.0 - b2) - 1.0)
        b2t = _int_pow_f32(b2, state['step'])
        ro = ro_inf - f32(2 * state['step']) * b2t / (f32(1) - b2t)
        if ro < f32(5.0):
            return mu_hat
        r = np.sqrt((ro - f32(4)) * (ro - f32(2)) * ro_inf
                    / ((ro_inf - f32(4)) * (ro_inf - f32(2)) * ro))
        return f32(r) * mu_hat / (torch.sqrt(nu_hat) + group['eps'])


def build_optimizer(config: Dict, params: Dict[str, Dict[str, torch.nn.Parameter]],
                    trainable_mask: Dict[str, Dict[str, bool]]):
    """(the optimizer over the trainable leaves, LRController).  The
    controller's LR is written into the optimizer by ``set_lr``."""
    optim_param = dict(config.get(K.OPTIM_PARAM, {}))
    lr = float(optim_param.pop('lr', 1e-3))
    name = str(config.get(K.OPTIMIZER, 'adam')).lower()
    sched_name = config.get(K.SCHEDULER, 'constant')
    sched_param = dict(config.get(K.SCHEDULER_PARAM, {}))
    controller = SCHEDULERS[sched_name.lower()](lr, **sched_param)
    leaves = [p for group, names in params.items()
              for name_, p in names.items() if trainable_mask[group][name_]]
    betas = tuple(optim_param.get('betas', (0.9, 0.999)))
    if name == 'adam':
        opt = torch.optim.Adam(leaves, lr=controller.lr, betas=betas,
                               eps=optim_param.get('eps', 1e-8))
    elif name in ('adamw', 'radam'):
        opt = OptaxRule(leaves, name, controller.lr, betas=betas,
                        eps=optim_param.get('eps', 1e-8),
                        weight_decay=optim_param.get('weight_decay', 1e-2))
    elif name == 'sgd':
        opt = OptaxRule(leaves, name, controller.lr,
                        momentum=optim_param.get('momentum', 0.0),
                        nesterov=optim_param.get('nesterov', False))
    elif name == 'adagrad':
        opt = OptaxRule(leaves, name, controller.lr,
                        eps=optim_param.get('eps', 1e-10))
    else:
        raise ValueError(f'unknown optimizer: {name}')
    return opt, controller


def set_lr(optimizer: torch.optim.Optimizer, lr: float) -> None:
    """Write the controller's LR into every param group."""
    for group in optimizer.param_groups:
        group['lr'] = lr


# the optax state holding each rule's arrays: (class, {field: state key})
_OPTAX_SOURCE = {
    'adam': ('ScaleByAdamState', {'mu': 'exp_avg', 'nu': 'exp_avg_sq'}),
    'adamw': ('ScaleByAdamState', {'mu': 'mu', 'nu': 'nu'}),
    'radam': ('ScaleByAdamState', {'mu': 'mu', 'nu': 'nu'}),
    'sgd': ('TraceState', {'trace': 'trace'}),
    'adagrad': ('ScaleByRssState', {'sum_of_squares': 'sum_of_squares'}),
}


def _optax_find(state, name: str):
    """The first optax state of class ``name`` in a nested optax state
    (chains are tuples, wrappers hold theirs in ``inner_state``)."""
    from .checkpoint import OptaxState

    if isinstance(state, OptaxState) and state.optax_name == name:
        return state
    if isinstance(state, tuple):
        for sub in state:
            hit = _optax_find(sub, name)
            if hit is not None:
                return hit
    return None


def optax_state_dict(optimizer: torch.optim.Optimizer,
                     params: Dict[str, Dict[str, torch.nn.Parameter]],
                     state) -> Dict:
    """The state dict of ``optimizer`` (built by ``build_optimizer`` over
    ``params``) that continues the JAX package's optax ``state``: each
    trainable leaf's arrays by its group and name, the step from the
    optax count (adam's own, else the ``inject_hyperparams`` count), and
    the LR the optax state holds (the JAX package's first epoch of a
    continue runs at it).  Raises ``ValueError`` where the state does
    not fit this optimizer (another rule, mask or shape)."""
    rule = 'adam' if isinstance(optimizer, torch.optim.Adam) \
        else getattr(optimizer, 'rule', None)
    if rule not in _OPTAX_SOURCE:
        raise ValueError(f'no optax translation for {type(optimizer)}')
    cls, fields = _OPTAX_SOURCE[rule]
    src = _optax_find(state, cls)
    outer = _optax_find(state, 'InjectStatefulHyperparamsState')
    if src is None or outer is None:
        raise ValueError(f'the optax state holds no {cls} under '
                         f'inject_hyperparams ({rule} needs one)')
    count = int(np.asarray((src if cls == 'ScaleByAdamState'
                            else outer).field('count')))
    names = {id(p): (g, n) for g, leaves in params.items()
             for n, p in leaves.items()}
    leaves = [p for group in optimizer.param_groups for p in group['params']]
    trees = {f: src.field(f) for f in fields}
    for f, tree in trees.items():
        if not isinstance(tree, dict) or not all(
                isinstance(sub, dict) for sub in tree.values()):
            raise ValueError(f'optax {cls}.{f} is not a parameter tree')
        n_arrays = sum(isinstance(v, np.ndarray) for sub in tree.values()
                       for v in sub.values())
        if n_arrays != len(leaves):
            raise ValueError(f'optax {cls}.{f} holds {n_arrays} arrays, the '
                             f'optimizer {len(leaves)} trainable leaves')
    out = {}
    for i, p in enumerate(leaves):
        g, n = names[id(p)]
        entry = {'step': (torch.tensor(float(count)) if rule == 'adam'
                          else count)}
        for f, key in fields.items():
            arr = trees[f].get(g, {}).get(n)
            if not isinstance(arr, np.ndarray) or arr.shape != tuple(
                    p.shape):
                raise ValueError(f'optax {cls}.{f} of {g}/{n}: '
                                 f'{getattr(arr, "shape", arr)}, the '
                                 f'parameter {tuple(p.shape)}')
            entry[key] = torch.tensor(np.array(arr, np.float32))
        out[i] = entry
    sd = optimizer.state_dict()
    sd['state'] = out
    hyper = outer.field('hyperparams')
    lr = hyper.get('learning_rate') if isinstance(hyper, dict) else None
    if lr is not None:
        for group in sd['param_groups']:
            group['lr'] = float(np.asarray(lr))
    return sd
