"""Training / fine-tuning pipeline orchestration.

Port of ``sevennet_finetuning_tpu/pipeline.py`` for one device (the
counterpart of the reference's script layer, reference:
sevenn/scripts/train.py:97-148, processing_dataset.py:146-319,
processing_continue.py:59-150, processing_epoch.py:10-87, and the
rehearsal variants in sevenn/rehearsal/*): dataset loading and
statistics, shift/scale/denominator resolution, continue/fine-tune
handling, the epoch loop with CSV + checkpoints, Fisher estimation, and
rehearsal.

``train`` runs on ``cuda`` unless the caller passes ``device='cpu'``.
Datasets may be prebuilt ``.sevenn_data`` artifacts (either package's or
the reference's), and the ``save_dataset`` family writes them; a
``continue`` keeps the optimizer state of the port's own checkpoints and
of the JAX package's (its optax state, translated by
``train/optim.optax_state_dict``).  Not ported yet, each raising
``NotImplementedError`` with its ROADMAP item: data-parallel training
(A.8) and per-block rematerialization (A.3).
"""

from __future__ import annotations

import os
import warnings
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from . import keys as K
from .data.dataset import GraphDataset, Loader
from .data.elements import type_map_from_species, z_to_symbol
from .data.vasp import Structure, read_outcar, read_structure_list
from .logger import Logger
from .model.build import build_model_spec
from .model.nequip import NequIP, init_params, load_jax_params
from .train.checkpoint import (
    load_checkpoint,
    load_pytree,
    save_checkpoint,
    save_pytree,
)
from .train.trainer import Trainer


def _expand_paths(config: Dict, paths_key: str) -> List[str]:
    import glob as _glob

    paths: List[str] = []
    for p in config.get(paths_key) or []:
        hits = sorted(_glob.glob(p))
        paths.extend(hits if hits else [p])
    return paths


def _read_file(path: str, fmt: str,
               fmt_args: Optional[Dict] = None) -> List[Structure]:
    """One data file -> labeled structures, dispatched on the file name
    first, then the configured data_format (reference reader matrix:
    sevenn/train/dataload.py:157-300).  ``fmt_args`` passes through to
    ``ase.io.read`` for data_format 'ase' (reference
    ``data_format_args``)."""
    base = os.path.basename(path)
    if fmt == 'ase':
        from .data.readers import read_ase

        structs = read_ase(path, **(fmt_args or {}))
        for s in structs:
            s.info['label'] = os.path.abspath(path)
        return structs
    if fmt in ('pkl', 'pickle') or base.endswith(('.pkl', '.pickle')):
        from .data.readers import read_atoms_pkl

        structs = read_atoms_pkl(path)
        for s in structs:
            s.info['label'] = os.path.abspath(path)
        return structs
    if 'structure_list' in base or fmt == 'structure_list' and \
            not ('OUTCAR' in base or 'POSCAR' in base or 'CONTCAR' in base
                 or base.endswith(('.xyz', '.extxyz'))):
        out = []
        for label, structs in read_structure_list(path).items():
            for s in structs:
                s.info['label'] = label
            out.extend(structs)
        return out
    if 'OUTCAR' in base or fmt == 'outcar':
        structs = read_outcar(path)
    elif 'POSCAR' in base or 'CONTCAR' in base or fmt == 'poscar':
        from .data.readers import read_poscar

        structs = [read_poscar(path)]
    elif base.endswith(('.xyz', '.extxyz')) or fmt in ('xyz', 'extxyz'):
        from .data.readers import read_extxyz

        structs = read_extxyz(path)
    else:
        raise ValueError(
            f'unsupported data file: {path} (formats: structure_list, '
            f'OUTCAR, POSCAR, extxyz, pkl, ase, .sevenn_data)'
        )
    for s in structs:
        s.info['label'] = os.path.abspath(path)
    return structs


def load_structures(config: Dict, paths_key: str = K.LOAD_DATASET
                    ) -> List[Structure]:
    """Load labeled structures per the data config (paths may glob).
    .sevenn_data artifacts contribute their stored structures."""
    fmt = config.get(K.DATA_FORMAT, 'structure_list')
    fmt_args = config.get(K.DATA_FORMAT_ARGS) or {}
    out: List[Structure] = []
    for path in _expand_paths(config, paths_key):
        if path.endswith('.sevenn_data'):
            from .data.dataset import sevenn_data_structures

            stored = sevenn_data_structures(path)
            if stored is None:
                raise ValueError(
                    f'{path} has no stored structures; use load_dataset'
                )
            out.extend(stored)
        else:
            out.extend(_read_file(path, fmt, fmt_args))
    return out


def load_dataset(
    config: Dict,
    paths_key: str,
    cutoff: float,
    type_map: Dict,
    n_cores: int = 1,
) -> GraphDataset:
    """Paths -> GraphDataset: raw files are graph-built (optionally in
    parallel), .sevenn_data artifacts reuse their prebuilt graphs when
    cutoff/type-map match and rebuild otherwise (reference dataset-load
    path: sevenn/scripts/processing_dataset.py:146-210)."""
    from .data.dataset import load_sevenn_data

    fmt = config.get(K.DATA_FORMAT, 'structure_list')
    fmt_args = config.get(K.DATA_FORMAT_ARGS) or {}
    out = GraphDataset()
    raw: List[Structure] = []
    for path in _expand_paths(config, paths_key):
        if path.endswith('.sevenn_data'):
            out.extend(load_sevenn_data(path, cutoff, type_map,
                                        n_cores=n_cores))
        else:
            raw.extend(_read_file(path, fmt, fmt_args))
    if raw:
        out.extend(GraphDataset.from_structures(raw, cutoff, type_map,
                                                n_cores=n_cores))
    return out


def parse_dataset_weights(config: Dict) -> Optional[Dict]:
    """'load_dataset_with_weights': [[path, e_w, f_w, s_w], ...] ->
    {abspath: {weight_key: w}} and fills LOAD_DATASET (reference:
    sevenn/parse_input.py:180-202)."""
    spec = config.get(K.LOAD_DATASET_WITH_WEIGHTS)
    if not spec:
        return None
    worder = (K.PER_ATOM_ENERGY, K.FORCE, K.STRESS)
    parsed = {}
    config[K.LOAD_DATASET] = []
    for entry in spec:
        if len(entry) != 4:
            raise ValueError(
                'each load_dataset_with_weights entry must be '
                '(path, energy_w, force_w, stress_w)'
            )
        path = os.path.abspath(entry[0])
        config[K.LOAD_DATASET].append(path)
        parsed[path] = {wk: float(w) for wk, w in zip(worder, entry[1:])}
    return parsed


def resolve_statistics(
    config: Dict,
    train_set: GraphDataset,
    logger: Logger,
    from_checkpoint: Optional[Dict] = None,
) -> None:
    """Fill SHIFT / SCALE / CONV_DENOMINATOR with concrete values.

    Priority (reference: sevenn/scripts/processing_dataset.py:38-142):
    explicit numbers in config > checkpoint statistics (when continuing
    with use_statistic_values_of_checkpoint) > dataset statistics.
    """
    num_species = config[K.NUM_SPECIES]
    use_cp = bool(from_checkpoint) and config.get(K.CONTINUE, {}).get(
        K.USE_STATISTIC_VALUES_OF_CHECKPOINT, True
    )

    def resolve(key, computed_options):
        val = config.get(key)
        if isinstance(val, (int, float)) and not isinstance(val, bool):
            return float(val)
        if isinstance(val, (list, tuple)):
            return [float(v) for v in val]
        if use_cp and from_checkpoint and key in from_checkpoint:
            return from_checkpoint[key]
        if isinstance(val, str):
            if val not in computed_options:
                raise ValueError(f'unknown {key} option: {val}')
            return computed_options[val]()
        # default first option
        return next(iter(computed_options.values()))()

    config[K.SHIFT] = resolve(K.SHIFT, {
        'per_atom_energy_mean': train_set.per_atom_energy_mean,
        'elemwise_reference_energies':
            lambda: train_set.species_ref_energies(num_species).tolist(),
    })
    config[K.SCALE] = resolve(K.SCALE, {
        'force_rms': train_set.force_rms,
        'per_atom_energy_std': train_set.per_atom_energy_std,
        'elemwise_force_rms':
            lambda: train_set.species_force_rms(num_species).tolist(),
    })

    denom = config.get(K.CONV_DENOMINATOR, 'avg_num_neigh')
    if isinstance(denom, str):
        avg = (
            from_checkpoint.get(K.CONV_DENOMINATOR)
            if use_cp and from_checkpoint
            and K.CONV_DENOMINATOR in from_checkpoint
            else train_set.avg_num_neigh()
        )
        if isinstance(avg, (list, tuple)):
            config[K.CONV_DENOMINATOR] = avg
        elif denom == 'avg_num_neigh':
            config[K.CONV_DENOMINATOR] = float(avg)
        elif denom == 'sqrt_avg_num_neigh':
            config[K.CONV_DENOMINATOR] = float(np.sqrt(avg))
        else:
            raise ValueError(f'unknown conv_denominator: {denom}')

    # species-wise shift/scale must both be lists of num_species
    if isinstance(config[K.SHIFT], list) or isinstance(config[K.SCALE], list):
        if not isinstance(config[K.SHIFT], list):
            config[K.SHIFT] = [config[K.SHIFT]] * num_species
        if not isinstance(config[K.SCALE], list):
            config[K.SCALE] = [config[K.SCALE]] * num_species

    logger.statistics(
        {
            'shift': config[K.SHIFT],
            'scale': config[K.SCALE],
            'conv_denominator': config[K.CONV_DENOMINATOR],
        },
        'resolved model statistics',
    )


def setup_species(config: Dict, structures: List[Structure],
                  prebuilt_paths: Optional[List[str]] = None):
    chem = config.get(K.CHEMICAL_SPECIES, 'Auto')
    if isinstance(chem, str) and chem.lower() == 'auto':
        found = {sp for s in structures for sp in s.species}
        for path in prebuilt_paths or []:
            from .compat.sevenn_data_import import is_reference_sevenn_data
            from .data.dataset import _load_blob, sevenn_data_structures

            if is_reference_sevenn_data(path):
                found |= {sp for s in sevenn_data_structures(path)
                          for sp in s.species}
            else:
                found |= {z_to_symbol(z) for z in _load_blob(path)[
                    'type_map']}
        species = sorted(found)
    else:
        species = list(chem)
    tm = type_map_from_species(species)
    config[K.TYPE_MAP] = tm
    config[K.NUM_SPECIES] = len(tm)
    config[K.CHEMICAL_SPECIES] = [z_to_symbol(z) for z in sorted(tm)]


def _refuse_unported(config: Dict, calc_fisher: bool):
    if config.get(K.IS_DDP) and not calc_fisher:
        raise NotImplementedError(
            'data-parallel training (is_ddp) is not ported yet: ROADMAP A.8')
    if config.get(K.REMAT, 'auto') is True:
        raise NotImplementedError(
            'per-block rematerialization (remat: True) is not ported yet: '
            'ROADMAP A.3')


def train(config: Dict, working_dir: str = '.', device=None) -> Trainer:
    """Full training entry (reference: sevenn/scripts/train.py:97-148), on
    ``device`` (cuda unless the caller asks for another)."""
    # calc_fisher / loss_threshold live under continue: in reference
    # yamls (reference: sevenn/_const.py:279-283) but are also accepted
    # at the train top level
    _cont0 = config.get(K.CONTINUE) or {}
    calc_fisher = bool(
        config.get(K.CALC_FISHER) or _cont0.get(K.CALC_FISHER)
    )
    loss_thr = float(
        config.get(K.LOSS_THR, _cont0.get(K.LOSS_THR, -1.0)) or -1.0
    )
    _refuse_unported(config, calc_fisher)
    os.makedirs(working_dir, exist_ok=True)
    logger = Logger(os.path.join(working_dir, 'log.sevenn'), rank=0)
    try:
        return _train(config, working_dir, device, logger, calc_fisher,
                      loss_thr)
    finally:
        logger.close()


def _train(config, working_dir, device, logger: Logger, calc_fisher: bool,
           loss_thr: float) -> Trainer:
    logger.greeting()
    seed = config.get(K.RANDOM_SEED, 1)
    np.random.seed(seed)

    # -- continue / fine-tune --------------------------------------------
    cont = config.get(K.CONTINUE, {}) or {}
    cp_blob = None
    cp_stats = None
    if cont.get(K.CHECKPOINT):
        cp_path = cont[K.CHECKPOINT]
        if not os.path.exists(cp_path):
            from .compat.known_models import pretrained_name_to_path

            cp_path = pretrained_name_to_path(cp_path)
        logger.writeline(f'continuing from {cp_path}')
        cp_blob = load_checkpoint(cp_path)
        cp_config = cp_blob['config']
        _check_continue_compat(config, cp_config, cont, logger)
        # architecture keys must come from the checkpoint
        for key in (
            K.NODE_FEATURE_MULTIPLICITY, K.LMAX, K.NUM_CONVOLUTION,
            K.IS_PARITY, K.IRREPS_MANUAL, K.SELF_CONNECTION_TYPE,
            K.CUTOFF, K.INTERACTION_TYPE, K.TYPE_MAP, K.NUM_SPECIES,
            K._NORMALIZE_SPH, K._RESTRICT_LAST_LAYER,
            K.CUTOFF_FUNCTION, K.RADIAL_BASIS, K.LMAX_EDGE, K.LMAX_NODE,
            K.CONVOLUTION_WEIGHT_NN_HIDDEN_NEURONS, K.ACTIVATION_SCALAR,
            K.ACTIVATION_GATE, K.ACTIVATION_RADIAL, K.USE_BIAS_IN_LINEAR,
            K.READOUT_AS_FCN, K.READOUT_FCN_HIDDEN_NEURONS,
            K.READOUT_FCN_ACTIVATION, K.CORRELATION,
        ):
            if key in cp_config:
                config[key] = cp_config[key]
        cp_stats = {
            K.SHIFT: cp_config.get(K.SHIFT),
            K.SCALE: cp_config.get(K.SCALE),
            K.CONV_DENOMINATOR: cp_config.get(K.CONV_DENOMINATOR),
        }

    # -- dataset ----------------------------------------------------------
    logger.timer_start('dataset')
    data_weights = parse_dataset_weights(config)
    if data_weights is not None:
        config[K.LOAD_DATASET_WITH_WEIGHTS] = True  # enables weighted loss
    n_cores = int(config.get(K.PREPROCESS_NUM_CORES, 1) or 1)

    fmt = config.get(K.DATA_FORMAT, 'structure_list')
    fmt_args = config.get(K.DATA_FORMAT_ARGS) or {}
    paths = _expand_paths(config, K.LOAD_DATASET)
    prebuilt_paths = [p for p in paths if p.endswith('.sevenn_data')]
    structures: List[Structure] = []
    for path in paths:
        if not path.endswith('.sevenn_data'):
            structures.extend(_read_file(path, fmt, fmt_args))
    if not structures and not prebuilt_paths:
        raise ValueError(
            f'no structures loaded — check data.{K.LOAD_DATASET} '
            f'(got: {config.get(K.LOAD_DATASET)!r})'
        )
    if not cont.get(K.CHECKPOINT):
        setup_species(config, structures, prebuilt_paths)
    tm = config[K.TYPE_MAP]
    cutoff = float(config[K.CUTOFF])
    full = GraphDataset.from_structures(structures, cutoff, tm,
                                        n_cores=n_cores)
    if prebuilt_paths:
        from .data.dataset import load_sevenn_data

        for path in prebuilt_paths:
            full.extend(load_sevenn_data(path, cutoff, tm,
                                         n_cores=n_cores))

    if config.get(K.LOAD_VALIDSET):
        train_set = full
        valid_set = load_dataset(config, K.LOAD_VALIDSET, cutoff, tm,
                                 n_cores=n_cores)
    else:
        train_set, valid_set = full.divide(
            config.get(K.RATIO, 0.1), seed=seed
        )
    logger.timer_end('dataset', 'dataset build')

    # optional .sevenn_data dumps (reference:
    # sevenn/scripts/processing_dataset.py save_dataset / by_label /
    # by_train_valid flags)
    _save_datasets(config, working_dir, logger, full, train_set, valid_set,
                   cutoff, tm, structures)

    logger.statistics(
        {
            'n_train': len(train_set),
            'n_valid': len(valid_set),
            'avg_num_neigh': round(full.avg_num_neigh(), 4),
        },
        'dataset',
    )

    resolve_statistics(config, train_set, logger, from_checkpoint=cp_stats)

    # optional radial-embedding standardization (reference:
    # sevenn/scripts/train.py:45-66,117-122): std/mean of bessel x cutoff
    # over the train edges feed (emb - mean) * (1/std) into every conv
    if config.get(K.STANDARDIZE_RADIAL_EMBEDDING):
        mean, std = _radial_embedding_std_mean(config, train_set)
        config[K._RADIAL_WEIGHT_SHIFT] = mean
        config[K._RADIAL_WEIGHT_SCALE] = 1.0 / std
        logger.writeline(
            f'radial embedding standardized: mean {mean:.4f} std {std:.4f}'
        )

    # -- model + trainer --------------------------------------------------
    spec = build_model_spec(config)
    params = init_params(spec, seed=seed)
    if cp_blob is not None:
        params = {g: {n: np.asarray(v) for n, v in names.items()}
                  for g, names in cp_blob['model_state_dict'].items()}
        # statistics resolved above override stored shift/scale/denominator
        params = _override_statistics(params, spec, config)
    model = load_jax_params(NequIP(spec), params)

    fisher = opt_params = None
    if cont.get(K.FISHER) and cont.get(K.OPT_PARAMS):
        fisher = load_pytree(cont[K.FISHER])
        opt_params = load_pytree(cont[K.OPT_PARAMS])
        logger.writeline(
            f'EWC enabled: lambda={cont.get(K.EWC_LAMBDA)}'
        )

    trainer = Trainer(model, config, fisher=fisher, opt_params=opt_params,
                      device=device)
    n_par = sum(int(p.numel()) for names in trainer.params.values()
                for p in names.values())
    logger.writeline(f'# model weights: {n_par}')

    if cp_blob is not None and not calc_fisher:
        if not cont.get(K.RESET_OPTIMIZER) and cp_blob.get(
            'optimizer_state_dict'
        ) is not None:
            try:
                trainer.load_optimizer_state(cp_blob['optimizer_state_dict'])
            except ValueError as e:  # other leaves or optimizer: reinit
                logger.writeline(f'optimizer state not restored: {e}')
                warnings.warn(f'optimizer state not restored: {e}')
        if not cont.get(K.RESET_SCHEDULER) and cp_blob.get(
            'scheduler_state_dict'
        ):
            trainer.lr_controller.load_state_dict(
                cp_blob['scheduler_state_dict']
            )

    # -- fisher-only mode -------------------------------------------------
    if calc_fisher:
        logger.writeline('computing Fisher information (batch size 1)')
        loader = Loader(train_set, batch_size=1)
        fisher_mat, opt_p, count = trainer.compute_fisher_matrix(
            loader, loss_thr
        )
        save_pytree(os.path.join(working_dir, 'fisher_sevenn.pt'),
                    fisher_mat)
        save_pytree(os.path.join(working_dir, 'opt_params_sevenn.pt'),
                    opt_p)
        logger.writeline(f'fisher from {count} samples saved')
        return trainer

    # -- loaders ----------------------------------------------------------
    batch_size = config.get(K.BATCH_SIZE, 6)

    mem_set = None
    if config.get(K.REHEARSAL) and config.get(K.LOAD_MEMORY):
        mem_set = load_dataset(config, K.LOAD_MEMORY, cutoff, tm,
                               n_cores=n_cores)
        ratio = float(config.get(K.MEM_RATIO, 1.0))
        if ratio < 1.0:
            n_keep = max(1, int(len(mem_set) * ratio))
            idx = np.random.default_rng(seed).permutation(len(mem_set))
            mem_set = GraphDataset(
                [mem_set.graphs[i] for i in idx[:n_keep]]
            )
        logger.writeline(f'rehearsal memory: {len(mem_set)} structures')

    # one padded shape across train/valid/memory (the JAX package compiles
    # each shape once; here the kernels' launch plans are cached per shape)
    mem_batch = config.get(K.MEM_BATCH_SIZE, 1)
    cache = bool(config.get(K.CACHE_BATCHES, False))
    if cache:
        logger.writeline(
            'cache_batches: True -- batch membership is frozen after the '
            'first collate (only batch order reshuffles per epoch); the '
            'reference reshuffles membership every epoch'
        )
    probes = [Loader(train_set, batch_size, cache=cache),
              Loader(valid_set, batch_size, cache=cache)]
    if mem_set is not None:
        probes.append(Loader(mem_set, mem_batch, cache=cache))
    shape_kw = dict(
        n_node=max(p.n_node for p in probes),
        n_edge=max(p.n_edge for p in probes),
        n_graph=max(p.n_graph for p in probes),
    )

    train_loader = Loader(train_set, batch_size,
                          shuffle=config.get(K.TRAIN_SHUFFLE, True),
                          seed=seed, data_weights=data_weights,
                          cache=cache, **shape_kw)
    valid_loader = Loader(valid_set, batch_size, data_weights=data_weights,
                          cache=cache, **shape_kw)

    mem_loader = None
    if mem_set is not None:
        mem_loader = Loader(mem_set, mem_batch, shuffle=True, seed=seed,
                            cache=cache, **shape_kw)

    # -- epoch loop -------------------------------------------------------
    # epoch numbering continues from the checkpoint unless reset
    # (reference: sevenn/scripts/processing_continue.py:120-130)
    start_epoch = 1
    if cp_blob is not None and not cont.get(K.RESET_EPOCH):
        start_epoch = int(cp_blob.get('epoch') or 0) + 1
        if start_epoch > 1:
            logger.writeline(f'epoch continues from {start_epoch}')
    run_epochs(trainer, config, train_loader, valid_loader, logger,
               working_dir, mem_loader=mem_loader,
               start_epoch=start_epoch)
    return trainer


def _save_datasets(config: Dict, working_dir: str, logger: Logger,
                   full: GraphDataset, train_set: GraphDataset,
                   valid_set: GraphDataset, cutoff: float, tm: Dict,
                   structures: List[Structure]):
    """The save_dataset_path / save_by_label / save_by_train_valid keys:
    .sevenn_data artifacts of the whole set (with its raw structures), of
    each label, and of the train / valid split."""
    from .data.dataset import save_sevenn_data

    if config.get(K.SAVE_DATASET):
        name = config[K.SAVE_DATASET]
        if not isinstance(name, str):
            name = os.path.join(working_dir, 'total')
        if not name.endswith('.sevenn_data'):
            name += '.sevenn_data'
        save_sevenn_data(name, full, cutoff, tm, structures=structures)
        logger.writeline(f'dataset saved: {name}')
    if config.get(K.SAVE_BY_LABEL):
        by_label: Dict[str, GraphDataset] = {}
        for g in full.graphs:
            lbl = str(g.get(K.USER_LABEL, 'none')).replace('/', '_')
            by_label.setdefault(lbl, GraphDataset()).graphs.append(g)
        for lbl, ds in by_label.items():
            save_sevenn_data(os.path.join(working_dir, f'{lbl}.sevenn_data'),
                             ds, cutoff, tm)
        logger.writeline(f'dataset saved by label: {sorted(by_label)}')
    if config.get(K.SAVE_BY_TRAIN_VALID):
        for nm, ds in (('train', train_set), ('valid', valid_set)):
            save_sevenn_data(os.path.join(working_dir, f'{nm}.sevenn_data'),
                             ds, cutoff, tm)
        logger.writeline('dataset saved: train/valid .sevenn_data')


def _radial_embedding_std_mean(config: Dict, train_set: GraphDataset
                               ) -> Tuple[float, float]:
    """(mean, std) of the radial embedding over every train edge, with
    the initial bessel coefficients, in float32 on the host (reference:
    sevenn/scripts/train.py:45-66)."""
    from .ops.radial import (
        bessel_basis,
        bessel_init,
        poly_cutoff,
        xplor_cutoff,
    )

    es = build_model_spec(config).edge
    rs = []
    for g in train_set.graphs:
        pos = g[K.POS]
        idx = g[K.EDGE_IDX]
        cell = g[K.CELL].reshape(3, 3)
        vec = pos[idx[1]] - pos[idx[0]] + g[K.CELL_SHIFT] @ cell
        rs.append(np.linalg.norm(vec, axis=1))
    r = torch.as_tensor(np.concatenate(rs), dtype=torch.float32)
    coeffs = torch.as_tensor(bessel_init(es.cutoff, es.bessel_num),
                             dtype=torch.float32)
    basis = bessel_basis(r, coeffs, es.cutoff)
    if es.cutoff_function == 'poly_cut':
        env = poly_cutoff(r, es.cutoff, es.poly_cut_p)
    else:
        env = xplor_cutoff(r, es.cutoff, es.cutoff_on)
    emb = basis * env[..., None]
    # jnp.std is the population std
    return float(emb.mean()), float(emb.std(unbiased=False))


def _check_continue_compat(config: Dict, cp_config: Dict, cont: Dict,
                           logger: Logger):
    """Reject a continue run whose yaml explicitly conflicts with the
    checkpoint architecture (reference:
    sevenn/scripts/processing_continue.py:11-56).

    Our flat config cannot distinguish 'user typed the default' from
    'unset', so only values differing from BOTH the checkpoint and the
    shipped default count as explicit conflicts."""
    from .config import DEFAULT_MODEL_CONFIG

    should_be_same = (
        K.NODE_FEATURE_MULTIPLICITY, K.LMAX, K.IS_PARITY, K.CUTOFF,
        K.RADIAL_BASIS, K.CUTOFF_FUNCTION,
        K.CONVOLUTION_WEIGHT_NN_HIDDEN_NEURONS, K.NUM_CONVOLUTION,
        K.USE_BIAS_IN_LINEAR, K.SELF_CONNECTION_TYPE, K.INTERACTION_TYPE,
        K.IRREPS_MANUAL,
    )
    for key in should_be_same:
        if key not in config or key not in cp_config:
            continue
        v, cp_v = config[key], cp_config[key]
        if v == cp_v:
            continue
        if v == DEFAULT_MODEL_CONFIG.get(key):
            continue  # unset by the user; checkpoint value will be used
        if isinstance(v, dict) and isinstance(cp_v, dict) \
                and all(cp_v.get(k) == vv for k, vv in v.items()):
            continue  # user subset consistent with checkpoint
        raise ValueError(
            f'continue: {key} must match the checkpoint '
            f'({v!r} != {cp_v!r}); remove it from the yaml or retrain'
        )

    # changing what is trainable invalidates optimizer/scheduler state
    # (reference: processing_continue.py:46-56)
    if not (cont.get(K.RESET_OPTIMIZER) and cont.get(K.RESET_SCHEDULER)):
        for key in (K.TRAIN_DENOMINATOR, K.TRAIN_SHIFT_SCALE):
            if key in config and key in cp_config \
                    and config[key] != cp_config[key]:
                raise ValueError(
                    f'continue: {key} changed '
                    f'({cp_config[key]!r} -> {config[key]!r}); set '
                    f'reset_optimizer and reset_scheduler'
                )


def _override_statistics(params, spec, config: Dict):
    """Re-inject resolved shift/scale/denominator into loaded params
    (reference: sevenn/scripts/processing_continue.py:92-108)."""
    params = dict(params)
    resc = dict(params['rescale_atomic_energy'])
    resc['shift'] = np.asarray(spec.shift, np.float32)
    resc['scale'] = np.asarray(spec.scale, np.float32)
    params['rescale_atomic_energy'] = resc
    denom = config[K.CONV_DENOMINATOR]
    if not isinstance(denom, (list, tuple)):
        denom = [denom] * len(spec.blocks)
    for blk in spec.blocks:
        conv = dict(params[f'{blk.t}_convolution'])
        conv['denominator'] = np.asarray([denom[blk.t]], np.float32)
        params[f'{blk.t}_convolution'] = conv
    return params


def _save(trainer: Trainer, path: str, config: Dict, epoch: int):
    ckpt = trainer.get_checkpoint_dict()
    save_checkpoint(path, ckpt['model_state_dict'], config, epoch,
                    optimizer_state=ckpt['optimizer_state_dict'],
                    scheduler_state=ckpt['scheduler_state_dict'])


def run_epochs(
    trainer: Trainer,
    config: Dict,
    train_loader: Loader,
    valid_loader: Loader,
    logger: Logger,
    working_dir: str,
    mem_loader: Optional[Loader] = None,
    start_epoch: int = 1,
):
    """Per-epoch train/valid passes, CSV, best/periodic checkpoints
    (reference: sevenn/scripts/processing_epoch.py:10-87)."""
    total_epoch = config.get(K.EPOCH, 100)
    per_epoch = config.get(K.PER_EPOCH, 10)
    best_key_sub = config.get(K.BEST_METRIC, 'TotalLoss')
    best = float('inf')
    metrics_every = max(1, int(config.get(K.METRICS_EVERY, 1) or 1))
    if metrics_every > 1 and str(
        config.get(K.SCHEDULER, '')
    ).lower() == 'reducelronplateau':
        raise ValueError(
            'metrics_every > 1 needs a metric-free scheduler '
            '(reducelronplateau consumes the validation metric every '
            'epoch)'
        )

    sample_metrics = [s.key for s in trainer.metric_specs]
    csv_cols = ['epoch', 'lr'] + [f'train_{k}' for k in sample_metrics] \
        + [f'valid_{k}' for k in sample_metrics]
    if mem_loader is not None:
        csv_cols += [f'memory_{k}' for k in sample_metrics]
    # continue runs append to a matching log.csv instead of restarting
    # it (reference: sevenn/scripts/processing_continue.py:131-141)
    csv_path = os.path.join(working_dir, 'log.csv')
    append = False
    if start_epoch > 1 and os.path.isfile(csv_path):
        with open(csv_path) as f:
            append = f.readline().strip() == ','.join(csv_cols)
        logger.writeline(
            'log.csv will be appended' if append
            else 'metrics changed: log.csv restarted'
        )
    logger.init_csv(csv_path, csv_cols, append=append)

    for epoch in range(start_epoch, total_epoch + 1):
        logger.timer_start('epoch')
        # between metric epochs: train only, no valid pass, no fetch
        with_metrics = (
            epoch % metrics_every == 0 or epoch == total_epoch
        )
        if mem_loader is not None:
            train_m, mem_m = trainer.run_one_epoch_rehearsal(
                train_loader, mem_loader, is_train=True,
                fetch=with_metrics,
            )
        else:
            train_m = trainer.run_one_epoch(train_loader, is_train=True,
                                            fetch=with_metrics)
            mem_m = None
        if not with_metrics:
            trainer.scheduler_step(None)
            # the logged wall time is the epoch's device work, not its
            # enqueue
            trainer.synchronize()
            logger.timer_end('epoch', f'epoch {epoch} time (no metrics)')
            # periodic checkpoints do not need metrics
            if per_epoch and epoch % per_epoch == 0:
                _save(trainer, os.path.join(
                    working_dir, f'checkpoint_{epoch}.pth'), config, epoch)
            continue
        valid_m = trainer.run_one_epoch(valid_loader, is_train=False)

        # plateau metric / scheduler
        best_metric_val = _find_metric(valid_m, best_key_sub)
        trainer.scheduler_step(best_metric_val)

        sections = {'Train': train_m, 'Valid': valid_m}
        if mem_m is not None:
            sections['Memory'] = mem_m
        logger.epoch_table(epoch, total_epoch, trainer.get_lr(), sections)
        logger.timer_end('epoch', 'epoch time')

        row = {'epoch': epoch, 'lr': trainer.get_lr()}
        row.update({f'train_{k}': v for k, v in train_m.items()})
        row.update({f'valid_{k}': v for k, v in valid_m.items()})
        if mem_m is not None:
            row.update({f'memory_{k}': v for k, v in mem_m.items()})
        logger.append_csv(row)

        if best_metric_val is not None and best_metric_val < best:
            best = best_metric_val
            _save(trainer, os.path.join(working_dir, 'checkpoint_best.pth'),
                  config, epoch)
        if per_epoch and epoch % per_epoch == 0:
            _save(trainer, os.path.join(
                working_dir, f'checkpoint_{epoch}.pth'), config, epoch)


def _find_metric(metrics: Dict[str, float], substring: str
                 ) -> Optional[float]:
    """Loose substring match like the reference's best-metric tracking
    (reference: sevenn/scripts/processing_epoch.py:68-77)."""
    for k, v in metrics.items():
        if substring in k:
            return v
    if metrics:
        return next(iter(metrics.values()))
    return None
