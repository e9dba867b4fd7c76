"""The reEWC fine-tune recipe that the train golden files were made with.

``experiments/ft_reewc_900/ft900_timing_r5.yaml``: Huber delta 0.01,
force weight 1, stress weight 0.01, EWC lambda 1e5 with a Fisher and an
anchor, adam.  One change: a constant LR (1e-4 by default), because the
recipe's cosine warmup starts at min_lr = 0 and its first epoch would not
move the parameters at all.  ``chip_smoke.py`` and the CPU tests build
their trainers from this one function, so both compare against golden
files made under the same config.
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
