"""Streaming error metrics (the reference's ErrorRecorder).

Port of ``sevennet_finetuning_tpu/train/metrics.py``.  Reference
semantics (reference: sevenn/error_recorder.py:11-432): RMSE averages the
per-entity vector squared error; ComponentRMSE and MAE average over
components; VectorMAE averages Euclidean distances; units convert via
fixed coefficients (stress -> kbar/GPa).  Each metric accumulates (sum,
count) as 0-d tensors on the device, masked instead of boolean-filtered,
so a step adds to them without a host round trip; ``fetch_accumulators``
brings every accumulator of an epoch to the host in one copy.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from .. import keys as K
from .loss import _criterion

STRESS_COEFF_KBAR = 1602.1766208
STRESS_COEFF_GPA = 160.21766208

ERROR_TYPES = {
    'TotalEnergy': dict(name='Energy', unit='eV', field='energy',
                        per_atom=False),
    'Energy': dict(name='Energy', unit='eV/atom', field='energy',
                   per_atom=True),
    'Force': dict(name='Force', unit='eV/A', field='force', vdim=3),
    'Stress': dict(name='Stress', unit='kbar', field='stress',
                   coeff=STRESS_COEFF_KBAR, vdim=6),
    'Stress_GPa': dict(name='Stress', unit='GPa', field='stress',
                       coeff=STRESS_COEFF_GPA, vdim=6),
    'TotalLoss': dict(name='TotalLoss', unit=None, field='loss'),
    'EWCLoss': dict(name='EWC', unit=None, field='ewc'),
}


@dataclass(frozen=True)
class MetricSpec:
    key: str            # display key, e.g. 'Energy_RMSE'
    err_type: str       # ERROR_TYPES key
    metric: str         # 'RMSE'|'ComponentRMSE'|'MAE'|'VectorMAE'|'Loss'
    unit: Optional[str]
    criterion: str = 'mse'          # for metric == 'Loss'
    criterion_params: tuple = ()

    @property
    def label(self) -> str:
        base = ERROR_TYPES[self.err_type]['name']
        name = base if self.metric == 'None' else f'{base}_{self.metric}'
        return f'{name} ({self.unit})' if self.unit else name


def metric_specs_from_config(config) -> Tuple[MetricSpec, ...]:
    records = config.get(
        K.ERROR_RECORD,
        [['Energy', 'RMSE'], ['Force', 'RMSE'], ['Stress', 'RMSE'],
         ['TotalLoss', 'None']],
    )
    is_stress = config.get(K.IS_TRAIN_STRESS, True)
    crit = config.get(K.LOSS, 'mse')
    crit_p = tuple(sorted((config.get(K.LOSS_PARAM) or {}).items()))
    out = []
    for err_type, metric in records:
        if not is_stress and 'Stress' in err_type:
            continue
        info = ERROR_TYPES[err_type]
        out.append(
            MetricSpec(
                key=f'{err_type}_{metric}',
                err_type=err_type,
                metric=metric,
                unit=None if metric == 'Loss' else info.get('unit'),
                criterion=crit,
                criterion_params=crit_p,
            )
        )
    return tuple(out)


def _zero_where_not(mask, ref):
    return torch.where(mask, ref, torch.zeros_like(ref))


def _field_arrays(spec: MetricSpec, out: Dict):
    """(pred, ref, element_mask[bool]) flattened views for the metric."""
    info = ERROR_TYPES[spec.err_type]
    f = info['field']
    if f == 'energy':
        pred = out[K.PRED_TOTAL_ENERGY]
        ref = out[K.ENERGY]
        if info.get('per_atom'):
            n = torch.clamp(out[K.NUM_ATOMS], min=1).to(pred.dtype)
            pred, ref = pred / n, ref / n
        mask = torch.isfinite(ref) & (out[K.NUM_ATOMS] > 0)
        return pred[:, None], _zero_where_not(mask, ref)[:, None], \
            mask[:, None]
    if f == 'force':
        pred = out[K.PRED_FORCE]
        ref = out[K.FORCE]
        mask = torch.isfinite(ref) & (out[K.NODE_MASK][:, None] > 0)
        return pred, _zero_where_not(mask, ref), mask
    if f == 'stress':
        c = info['coeff']
        pred = out[K.PRED_STRESS] * c
        ref = out[K.STRESS] * c
        mask = torch.isfinite(ref) & (out[K.NUM_ATOMS][:, None] > 0)
        return pred, _zero_where_not(mask, ref), mask
    raise ValueError(f)


def update_accumulators(
    specs: Tuple[MetricSpec, ...],
    acc: Dict[str, torch.Tensor],
    out: Dict,
    loss_terms: Optional[Dict] = None,
    loss_total=None,
) -> Dict[str, torch.Tensor]:
    """One batch's contribution, on the device (no host copy).  acc maps
    '<key>_sum'/'<key>_cnt' -> 0-d tensor; out and the loss values come
    detached."""
    acc = dict(acc)
    for spec in specs:
        field = ERROR_TYPES[spec.err_type]['field']
        if field == 'loss':
            if loss_total is not None:
                acc[f'{spec.key}_sum'] = acc[f'{spec.key}_sum'] + loss_total
                acc[f'{spec.key}_cnt'] = acc[f'{spec.key}_cnt'] + 1.0
            continue
        if field == 'ewc':
            if loss_terms is not None and 'EWC' in loss_terms:
                acc[f'{spec.key}_sum'] = (
                    acc[f'{spec.key}_sum'] + loss_terms['EWC']
                )
                acc[f'{spec.key}_cnt'] = acc[f'{spec.key}_cnt'] + 1.0
            continue
        pred, ref, mask = _field_arrays(spec, out)
        m = mask.to(pred.dtype)
        diff = (pred - ref) * m
        if spec.metric == 'RMSE':
            # per-entity vector squared error; count = entities
            se = torch.sum(diff * diff, dim=-1)
            ent = torch.any(mask, dim=-1).to(pred.dtype)
            acc[f'{spec.key}_sum'] = acc[f'{spec.key}_sum'] + torch.sum(se)
            acc[f'{spec.key}_cnt'] = acc[f'{spec.key}_cnt'] + torch.sum(ent)
        elif spec.metric == 'ComponentRMSE':
            acc[f'{spec.key}_sum'] = (
                acc[f'{spec.key}_sum'] + torch.sum(diff * diff)
            )
            acc[f'{spec.key}_cnt'] = acc[f'{spec.key}_cnt'] + torch.sum(m)
        elif spec.metric == 'MAE':
            acc[f'{spec.key}_sum'] = (
                acc[f'{spec.key}_sum'] + torch.sum(torch.abs(diff))
            )
            acc[f'{spec.key}_cnt'] = acc[f'{spec.key}_cnt'] + torch.sum(m)
        elif spec.metric == 'Loss':
            crit = _criterion(spec.criterion, **dict(spec.criterion_params))
            acc[f'{spec.key}_sum'] = (
                acc[f'{spec.key}_sum'] + torch.sum(crit(pred, ref) * m)
            )
            acc[f'{spec.key}_cnt'] = acc[f'{spec.key}_cnt'] + torch.sum(m)
        elif spec.metric == 'VectorMAE':
            d = torch.sqrt(torch.clamp(torch.sum(diff * diff, dim=-1), min=1e-24))
            ent = torch.any(mask, dim=-1).to(pred.dtype)
            acc[f'{spec.key}_sum'] = (
                acc[f'{spec.key}_sum'] + torch.sum(d * ent)
            )
            acc[f'{spec.key}_cnt'] = acc[f'{spec.key}_cnt'] + torch.sum(ent)
        else:
            raise ValueError(spec.metric)
    return acc


def init_accumulators(specs: Tuple[MetricSpec, ...], device=None) -> Dict:
    acc = {}
    for spec in specs:
        acc[f'{spec.key}_sum'] = torch.zeros((), device=device)
        acc[f'{spec.key}_cnt'] = torch.zeros((), device=device)
    return acc


def fetch_accumulators(*accs: Dict[str, torch.Tensor]) -> List[Dict]:
    """Accumulator dicts -> host numpy scalars in ONE device-to-host copy
    (one per epoch, not per step)."""
    names = [(i, k) for i, a in enumerate(accs) for k in sorted(a)]
    flat = torch.stack([accs[i][k] for i, k in names]).cpu().numpy()
    out: List[Dict] = [{} for _ in accs]
    for (i, k), v in zip(names, flat):
        out[i][k] = np.float64(v)
    return out


def finalize(specs: Tuple[MetricSpec, ...], acc: Dict) -> Dict[str, float]:
    """Accumulators -> display values (host-side, after the epoch)."""
    out = {}
    for spec in specs:
        s = float(acc[f'{spec.key}_sum'])
        c = float(acc[f'{spec.key}_cnt'])
        if c == 0:
            out[spec.key] = float('nan')
            continue
        v = s / c
        if spec.metric in ('RMSE', 'ComponentRMSE'):
            v = v ** 0.5
        out[spec.key] = v
    return out
