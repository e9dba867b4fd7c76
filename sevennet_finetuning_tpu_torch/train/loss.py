"""Losses: per-atom energy, force, stress (kbar), and the EWC penalty.

Port of ``sevennet_finetuning_tpu/train/loss.py`` (reference:
sevenn/train/loss.py:8-309).  Reductions are masked means over static
padded batches: the mask combines padding and NaN labels ("unlabeled",
which the reference filters out by boolean indexing -- identical in
value).  Optional per-structure data weights multiply elementwise before
the mean, as in the reference's weighted criterion.

``loss: custom`` loads a plugin (``loss_param``: path, module, function)
whose callback receives the config and returns [(term_name, weight, fn)];
``fn(params, output)`` returns a scalar tensor, with ``params`` the dict
{block: {leaf: tensor}} under the JAX package's names and ``output`` the
model's output dict of tensors.  A plugin differs between the two
packages only in its array library.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

import torch

from .. import keys as K

TO_KBAR = 1602.1766208


def _criterion(name: str, **params) -> Callable:
    name = name.lower()
    if name == 'mse':
        return lambda p, r: (p - r) ** 2
    if name == 'huber':
        delta = float(params.get('delta', 1.0))

        def huber(p, r):
            a = torch.abs(p - r)
            return torch.where(a < delta, 0.5 * a * a,
                               delta * (a - 0.5 * delta))

        return huber
    raise ValueError(f'unknown loss: {name}')


def _masked_mean(err, mask, weights=None):
    mask = mask.to(err.dtype)
    if weights is not None:
        err = err * weights
    denom = torch.clamp(mask.sum(), min=1.0)
    return (err * mask).sum() / denom


@dataclass(frozen=True)
class LossSpec:
    """One term of the training objective."""

    name: str          # 'Energy' | 'Force' | 'Stress' | 'EWC' | custom
    weight: float
    criterion: str = 'mse'
    criterion_params: Tuple[Tuple[str, float], ...] = ()
    # plugin terms (loss: 'custom'): fn(params, output_dict) -> scalar
    custom_fn: Optional[Callable] = None


def energy_loss(out: Dict, crit: Callable,
                weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    natoms = torch.clamp(out[K.NUM_ATOMS], min=1).to(
        out[K.PRED_TOTAL_ENERGY].dtype)
    pred = out[K.PRED_TOTAL_ENERGY] / natoms
    ref = out[K.ENERGY] / natoms
    mask = torch.isfinite(ref) & (out[K.NUM_ATOMS] > 0)
    ref = torch.where(mask, ref, torch.zeros_like(ref))
    return _masked_mean(crit(pred, ref), mask, weights)


def force_loss(out: Dict, crit: Callable,
               weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    ref = out[K.FORCE]
    mask = torch.isfinite(ref) & (out[K.NODE_MASK][:, None] > 0)
    ref = torch.where(mask, ref, torch.zeros_like(ref))
    w = None if weights is None else weights[out[K.BATCH].long()][:, None]
    return _masked_mean(crit(out[K.PRED_FORCE], ref), mask, w)


def stress_loss(out: Dict, crit: Callable,
                weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    pred = out[K.PRED_STRESS] * TO_KBAR
    ref = out[K.STRESS] * TO_KBAR
    mask = torch.isfinite(ref) & (out[K.NUM_ATOMS][:, None] > 0)
    ref = torch.where(mask, ref, torch.zeros_like(ref))
    w = None if weights is None else weights[:, None]
    return _masked_mean(crit(pred, ref), mask, w)


def ewc_penalty(params: Dict[str, Dict[str, torch.Tensor]],
                fisher: Dict[str, Dict[str, torch.Tensor]],
                opt_params: Dict[str, Dict[str, torch.Tensor]]
                ) -> torch.Tensor:
    """sum_i F_i (theta_i - theta*_i)^2 over every leaf present in all
    three (reference: sevenn/train/loss.py:250-265)."""
    total = None
    for group, names in params.items():
        for name, p in names.items():
            f = fisher.get(group, {}).get(name)
            o = opt_params.get(group, {}).get(name)
            if f is None or o is None:
                continue
            v = torch.sum(f * (p - o) ** 2)
            total = v if total is None else total + v
    if total is None:              # no leaf matches: no penalty
        total = torch.zeros((), device=next(iter(next(iter(
            params.values())).values())).device)
    return total


def build_loss_fn(loss_specs: Tuple[LossSpec, ...],
                  use_data_weights: bool = False, fisher=None,
                  opt_params=None):
    """The total objective sum_i w_i * L_i(output).

    Returns f(params, output_dict) -> (total, {name: value}); ``params``
    (group -> name -> tensor) enters only through the EWC term (weight
    lambda/2, reference: sevenn/train/loss.py:298-307); ``fisher`` and
    ``opt_params`` are tensors of the same layout.  With
    ``use_data_weights`` the energy, force and stress terms take the
    batch's per-graph weights (``K.DATA_WEIGHT``)."""
    crits = {ls.name: _criterion(ls.criterion, **dict(ls.criterion_params))
             for ls in loss_specs
             if ls.name != 'EWC' and ls.custom_fn is None}
    weight_key = {'Energy': K.PER_ATOM_ENERGY, 'Force': K.FORCE,
                  'Stress': K.STRESS}

    def loss_fn(params, out):
        terms = {}
        total = 0.0
        for ls in loss_specs:
            w = (out.get(K.DATA_WEIGHT, {}).get(weight_key[ls.name])
                 if use_data_weights and ls.name in weight_key else None)
            if ls.custom_fn is not None:
                v = ls.custom_fn(params, out)
            elif ls.name == 'Energy':
                v = energy_loss(out, crits[ls.name], w)
            elif ls.name == 'Force':
                v = force_loss(out, crits[ls.name], w)
            elif ls.name == 'Stress':
                v = stress_loss(out, crits[ls.name], w)
            elif ls.name == 'EWC':
                v = ewc_penalty(params, fisher, opt_params)
            else:
                raise ValueError(ls.name)
            terms[ls.name] = v
            total = total + ls.weight * v
        return total, terms

    return loss_fn


def loss_specs_from_config(config: Dict) -> Tuple[LossSpec, ...]:
    """Reference semantics: energy weight 1, force/stress weights from
    config, optional EWC with weight lambda/2 (reference:
    sevenn/train/loss.py:268-309)."""
    name = config.get(K.LOSS, 'mse')
    if str(name).lower() == 'custom':
        # plugin hook (reference: sevenn/train/loss.py:312-321)
        from ..model.build import _load_callback

        callback = _load_callback(**config.get(K.LOSS_PARAM, {}))
        specs = [LossSpec(n, float(w), 'custom', custom_fn=fn)
                 for n, w, fn in callback(config)]
        cont = config.get(K.CONTINUE, {})
        if cont.get(K.FISHER) and cont.get(K.OPT_PARAMS):
            lam = float(cont.get(K.EWC_LAMBDA, 0.0))
            specs.append(LossSpec('EWC', lam / 2.0))
        return tuple(specs)
    lp = tuple(sorted(config.get(K.LOSS_PARAM, {}).items()))
    specs: List[LossSpec] = [
        LossSpec('Energy', 1.0, name, lp),
        LossSpec('Force', float(config.get(K.FORCE_WEIGHT, 0.1)), name, lp),
    ]
    if config.get(K.IS_TRAIN_STRESS, False):
        specs.append(LossSpec(
            'Stress', float(config.get(K.STRESS_WEIGHT, 1e-6)), name, lp))
    cont = config.get(K.CONTINUE, {})
    if cont.get(K.FISHER) and cont.get(K.OPT_PARAMS):
        lam = float(cont.get(K.EWC_LAMBDA, 0.0))
        specs.append(LossSpec('EWC', lam / 2.0))
    return tuple(specs)
