"""The reEWC fine-tune recipe that the train golden files were made with.

``experiments/ft_reewc_900/ft900_timing_r5.yaml``: Huber delta 0.01,
force weight 1, stress weight 0.01, EWC lambda 1e5 with a Fisher and an
anchor, adam.  One change: a constant LR (1e-4 by default), because the
recipe's cosine warmup starts at min_lr = 0 and its first epoch would not
move the parameters at all.  ``chip_smoke.py`` and the CPU tests build
their trainers from this one function, so both compare against golden
files made under the same config.  ``pipeline_stages`` gives the input
files of the whole workflow (Fisher stage, then fine-tune) that the
pipeline golden was made with by the JAX CLI and that ``chip_smoke.py``
runs through the port's CLI.
"""

from __future__ import annotations

from .. import keys as K


def reewc_recipe_config(config: dict, fisher: str, opt_params: str,
                        lr: float = 1e-4) -> dict:
    """``config`` (a checkpoint's) with the reEWC recipe's loss, EWC and
    optimizer at a constant ``lr``; ``fisher`` / ``opt_params`` are the
    paths of the Fisher and anchor pickles."""
    cfg = dict(config)
    cfg.update({
        K.LOSS: 'Huber', K.LOSS_PARAM: {'delta': 0.01},
        K.FORCE_WEIGHT: 1.0, K.STRESS_WEIGHT: 0.01,
        K.IS_TRAIN_STRESS: True, K.OPTIMIZER: 'adam',
        K.OPTIM_PARAM: {'lr': lr}, K.SCHEDULER: 'constant',
        K.SCHEDULER_PARAM: {},
        K.CONTINUE: {K.FISHER: str(fisher), K.OPT_PARAMS: str(opt_params),
                     K.EWC_LAMBDA: 100000},
        K.ERROR_RECORD: [['Energy', 'RMSE'], ['Force', 'RMSE'],
                         ['Stress', 'RMSE'], ['TotalLoss', 'None'],
                         ['EWCLoss', 'None']],
    })
    return cfg


def pipeline_stages(root, fisher_dir: str, epochs: int = 3):
    """The two input files (model / train / data sections, as dicts to
    write as YAML) of the reEWC workflow of ``experiments/ft_reewc`` that
    ``golden/pipeline_ft_jax_cpu.npz`` was made with, at full width from
    ``checkpoint_best.pth``: the Fisher stage (``fisher_input.yaml``, run
    with ``-fs``) on replay.extxyz, and a reEWC fine-tune
    (``ft_input.yaml``) of ``epochs`` epochs on ft.extxyz with rehearsal
    on replay.extxyz, batch 4, a checkpoint every 2 epochs and the
    stage-1 artifacts from ``fisher_dir``.  Two changes from the files:
    the LR is held at 1e-4 (exponentiallr with gamma 1; the recipe's
    warmup starts at LR 0), and the epoch count restarts at 1 (the
    checkpoint is at epoch 387)."""
    root = str(root)
    ckpt = f'{root}/experiments/ft_reewc_900/conv_out/checkpoint_best.pth'
    ft = f'{root}/experiments/ft_reewc/data/ft.extxyz'
    replay = f'{root}/experiments/ft_reewc/data/replay.extxyz'
    # the checkpoint trains shift, scale and denominators: a stage that
    # continues from it without resetting the optimizer must say so
    model = {'chemical_species': 'auto', 'cutoff': 5.0,
             'train_shift_scale': True, 'train_denominator': True}
    fisher = {
        'model': dict(model),
        'train': {
            'random_seed': 1, 'is_train_stress': True, 'epoch': 1,
            'error_record': [['Energy', 'MAE'], ['Force', 'MAE'],
                             ['TotalLoss', 'None']],
            'continue': {'checkpoint': ckpt,
                         'use_statistic_values_of_checkpoint': True,
                         'calc_fisher': True, 'loss_threshold': -1},
        },
        'data': {'batch_size': 1, 'data_divide_ratio': 0.2,
                 'load_dataset_path': [replay]},
    }
    fine_tune = {
        'model': dict(model),
        'train': {
            'random_seed': 1, 'is_train_stress': True, 'epoch': epochs,
            'loss': 'Huber', 'loss_param': {'delta': 0.01},
            'optimizer': 'adam', 'optim_param': {'lr': 1e-4},
            'scheduler': 'exponentiallr', 'scheduler_param': {'gamma': 1.0},
            'force_loss_weight': 1.0, 'stress_loss_weight': 0.01,
            'error_record': [['Energy', 'RMSE'], ['Force', 'RMSE'],
                             ['Stress', 'RMSE'], ['Energy', 'MAE'],
                             ['Force', 'MAE'], ['Stress', 'MAE'],
                             ['TotalLoss', 'None'], ['EWCLoss', 'None']],
            'per_epoch': 2,
            'continue': {
                'checkpoint': ckpt, 'reset_optimizer': True,
                'reset_scheduler': True, 'reset_epoch': True,
                'use_statistic_values_of_checkpoint': True,
                'opt_params': f'{fisher_dir}/opt_params_sevenn.pt',
                'fisher_information': f'{fisher_dir}/fisher_sevenn.pt',
                'ewc_lambda': 100000},
        },
        'data': {'data_shuffle': True, 'batch_size': 4,
                 'data_divide_ratio': 0.2, 'load_dataset_path': [ft],
                 'rehearsal': True, 'load_memory_path': [replay],
                 'mem_batch_size': 4, 'mem_ratio': 1.0},
    }
    return fisher, fine_tune
