"""Batch inference: checkpoint + structures -> predictions + error files.

Port of ``sevennet_finetuning_tpu/scripts/inference.py`` (the
counterpart of the reference's inference script, reference:
sevenn/scripts/inference.py:185-291): evaluates energy/forces/stress on
every input format the pipeline reads and writes errors.txt, info.csv,
per_graph.csv and per_atom.csv.  The model runs on ``cuda`` unless the
caller passes ``device='cpu'``.
"""

from __future__ import annotations

import os
from typing import List, Sequence

import numpy as np

from .. import keys as K
from ..data.dataset import GraphDataset, Loader
from ..data.vasp import Structure
from ..calculator import STRESS_COEFF_KBAR, Calculator
from ..model.nequip import apply_model, batch_to_torch


def _load_inputs(paths: Sequence[str]) -> List[Structure]:
    """All reader formats the pipeline knows: structure_list, OUTCAR,
    POSCAR, extxyz, pkl (reference inference accepts the same family,
    sevenn/scripts/inference.py:185-240)."""
    from ..pipeline import load_structures

    return load_structures({K.LOAD_DATASET: list(paths)})


def inference_main(
    checkpoint: str,
    data_paths: Sequence[str],
    output_dir: str = 'sevenn_infer_result',
    batch_size: int = 5,
    dispersion=None,
    device=None,
):
    """``dispersion``: None (use the checkpoint config's 'dispersion'
    key if set) or a dict like {'functional': 'pbe', 'damping': 'bj'} --
    adds Grimme D3 to every predicted energy/force/stress."""
    from ..model.build import build_model_spec
    from ..train.checkpoint import load_checkpoint

    os.makedirs(output_dir, exist_ok=True)
    blob = load_checkpoint(checkpoint)
    config = blob['config']
    spec = build_model_spec(config)
    if dispersion is None:
        dispersion = (config or {}).get(K.DISPERSION)
    # one Calculator holds the model (and the D3 tables when asked)
    calc = Calculator(spec, blob['model_state_dict'], device=device,
                      d3=dict(dispersion) if dispersion else None)
    tm = dict(spec.type_map)
    d3_calc = calc if dispersion else None

    structures = _load_inputs(data_paths)
    ds = GraphDataset.from_structures(structures, spec.cutoff, tm)
    loader = Loader(ds, batch_size)

    rows_graph = []
    rows_atom = []
    se_e, se_f, se_s = [], [], []
    ae_e, ae_f, ae_s = [], [], []

    gidx = 0
    for batch in loader:
        out = apply_model(calc.model, batch_to_torch(batch, calc.device))
        n_graphs = int(np.sum(np.asarray(batch[K.NUM_ATOMS]) > 0))
        pe = out[K.PRED_TOTAL_ENERGY].cpu().numpy()
        pf = out[K.PRED_FORCE].cpu().numpy()
        ps = out[K.PRED_STRESS].cpu().numpy()
        if d3_calc is not None:
            na_ = np.asarray(batch[K.NUM_ATOMS])
            off = 0
            for bi in range(n_graphs):
                e3, f3, s3 = d3_calc.d3_terms(structures[gidx + bi])
                pe[bi] += e3
                pf[off:off + int(na_[bi])] += f3
                ps[bi] += s3
                off += int(na_[bi])
        na = np.asarray(batch[K.NUM_ATOMS])
        ref_e = np.asarray(batch[K.ENERGY])
        ref_f = np.asarray(batch[K.FORCE])
        ref_s = np.asarray(batch[K.STRESS])
        node_off = 0
        for bi in range(n_graphs):
            n = int(na[bi])
            rows_graph.append({
                'idx': gidx,
                'natoms': n,
                'energy': float(pe[bi]),
                'ref_energy': float(ref_e[bi]),
                'stress_kbar': (ps[bi] * STRESS_COEFF_KBAR).tolist(),
            })
            if np.isfinite(ref_e[bi]):
                de = (pe[bi] - ref_e[bi]) / n
                se_e.append(de * de)
                ae_e.append(abs(de))
            f_slice = slice(node_off, node_off + n)
            for ai in range(n):
                rows_atom.append({
                    'graph': gidx,
                    'atom': ai,
                    'fx': float(pf[node_off + ai, 0]),
                    'fy': float(pf[node_off + ai, 1]),
                    'fz': float(pf[node_off + ai, 2]),
                })
            if np.isfinite(ref_f[f_slice]).all():
                d = pf[f_slice] - ref_f[f_slice]
                se_f.extend((d * d).ravel().tolist())
                ae_f.extend(np.abs(d).ravel().tolist())
            if np.isfinite(ref_s[bi]).all():
                d = (ps[bi] - ref_s[bi]) * STRESS_COEFF_KBAR
                se_s.extend((d * d).ravel().tolist())
                ae_s.extend(np.abs(d).ravel().tolist())
            node_off += n
            gidx += 1

    def _rmse(x):
        return float(np.sqrt(np.mean(x))) if x else float('nan')

    def _mae(x):
        return float(np.mean(x)) if x else float('nan')

    with open(os.path.join(output_dir, 'errors.txt'), 'w') as f:
        f.write(f'Energy RMSE (eV/atom): {_rmse(se_e):.6f}\n')
        f.write(f'Energy MAE  (eV/atom): {_mae(ae_e):.6f}\n')
        f.write(f'Force  RMSE (eV/A):    {_rmse(se_f):.6f}\n')
        f.write(f'Force  MAE  (eV/A):    {_mae(ae_f):.6f}\n')
        f.write(f'Stress RMSE (kbar):    {_rmse(se_s):.6f}\n')
        f.write(f'Stress MAE  (kbar):    {_mae(ae_s):.6f}\n')

    import csv

    # provenance of each row in per_graph.csv (reference writes the
    # same info.csv, sevenn/scripts/inference.py:95-130)
    with open(os.path.join(output_dir, 'info.csv'), 'w',
              newline='') as f:
        w = csv.DictWriter(f, fieldnames=['idx', 'file', 'label',
                                          'natoms'])
        w.writeheader()
        for i, s in enumerate(structures):
            w.writerow({
                'idx': i,
                'file': s.info.get('file', ''),
                'label': s.info.get('label', K.LABEL_NONE),
                'natoms': len(s),
            })

    with open(os.path.join(output_dir, 'per_graph.csv'), 'w',
              newline='') as f:
        w = csv.DictWriter(f, fieldnames=list(rows_graph[0].keys()))
        w.writeheader()
        w.writerows(rows_graph)
    with open(os.path.join(output_dir, 'per_atom.csv'), 'w',
              newline='') as f:
        w = csv.DictWriter(f, fieldnames=list(rows_atom[0].keys()))
        w.writeheader()
        w.writerows(rows_atom)
    print(f'inference results written to {output_dir}/')
