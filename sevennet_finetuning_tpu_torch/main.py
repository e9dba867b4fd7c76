"""Command-line entry points.

Port of ``sevennet_finetuning_tpu/main.py`` (the counterpart of the
reference CLI family, reference: sevenn/main/*.py):

    python -m sevennet_finetuning_tpu_torch.main train input.yaml [-w dir]
    python -m sevennet_finetuning_tpu_torch.main train input.yaml -fs
    python -m sevennet_finetuning_tpu_torch.main preset <name>

``train`` runs on ``cuda`` unless ``--device`` names another device
(``--device cpu``).  ``get_model``, ``inference`` and ``graph_build``
and data-parallel training (``-d``) are not ported yet and raise
``NotImplementedError`` with their ROADMAP item.
"""

from __future__ import annotations

import argparse
import os
import sys


def cmd_train(args):
    from . import keys as K
    from .config import global_config, read_config_yaml
    from .pipeline import train

    if getattr(args, 'distributed', False):
        raise NotImplementedError(
            'data-parallel training (-d) is not ported yet: ROADMAP A.8')
    model, tr, data = read_config_yaml(args.input)
    cfg = global_config(model, tr, data)
    if args.calc_fisher:
        # Fisher mode: no rehearsal, batch 1, and no EWC term (the Fisher
        # artifacts are being produced, not consumed)
        # (reference: sevenn/main/sevenn.py:74-81)
        cfg[K.CALC_FISHER] = True
        cfg[K.REHEARSAL] = False
        cfg[K.BATCH_SIZE] = 1
        cont = dict(cfg.get(K.CONTINUE) or {})
        cont[K.FISHER] = False
        cont[K.OPT_PARAMS] = False
        cfg[K.CONTINUE] = cont
    # dataset + continue-artifact paths are relative to the yaml's
    # directory (matches the reference examples' '../estimate_Fisher/..'
    # layout, example_inputs/fine_tuning/FT_w_reEWC/input_full.yaml)
    base = os.path.dirname(os.path.abspath(args.input))
    for k in (K.LOAD_DATASET, K.LOAD_VALIDSET, K.LOAD_MEMORY):
        if cfg.get(k):
            cfg[k] = [
                p if os.path.isabs(p) else os.path.join(base, p)
                for p in cfg[k]
            ]
    cont = cfg.get(K.CONTINUE) or {}
    for k in (K.CHECKPOINT, K.FISHER, K.OPT_PARAMS):
        p = cont.get(k)
        if p and isinstance(p, str) and not os.path.isabs(p) \
                and os.path.exists(os.path.join(base, p)):
            cont[k] = os.path.join(base, p)
    return train(cfg, working_dir=args.working_dir, device=args.device)


def cmd_preset(args):
    here = os.path.join(os.path.dirname(__file__), 'presets')
    path = os.path.join(here, f'{args.name}.yaml')
    if not os.path.exists(path):
        names = sorted(
            f[:-5] for f in os.listdir(here) if f.endswith('.yaml')
        )
        sys.exit(f'unknown preset {args.name!r}; available: {names}')
    with open(path) as f:
        sys.stdout.write(f.read())


def _not_ported(item: str):
    def run(args):
        raise NotImplementedError(
            f'{args.cmd} is not ported yet: ROADMAP {item}')

    return run


def main(argv=None):
    p = argparse.ArgumentParser(prog='sevennet-ft-torch')
    sub = p.add_subparsers(dest='cmd', required=True)

    t = sub.add_parser('train', help='train or fine-tune a potential')
    t.add_argument('input', help='input.yaml')
    t.add_argument('-w', '--working-dir', default='.')
    t.add_argument('-d', '--distributed', action='store_true',
                   help='data-parallel training (not ported yet)')
    t.add_argument('-fs', '--calc-fisher', action='store_true',
                   help='estimate Fisher information then exit')
    t.add_argument('--device', default=None,
                   help="torch device (default: cuda; 'cpu' to run on "
                        'the CPU)')
    t.set_defaults(func=cmd_train)

    pr = sub.add_parser('preset', help='print a preset input yaml')
    pr.add_argument('name')
    pr.set_defaults(func=cmd_preset)

    # the JAX CLI's other subcommands, with their arguments, not ported
    for name, item, helptext in (
            ('get_model', 'A.6', 'deploy a checkpoint'),
            ('inference', 'A.7', 'batch inference on structures'),
            ('graph_build', 'A.10', 'prebuild graphs from data')):
        s = sub.add_parser(name, help=f'{helptext} (not ported yet)')
        s.add_argument('args', nargs='*')
        s.set_defaults(func=_not_ported(item))

    args = p.parse_args(argv)
    return args.func(args)


if __name__ == '__main__':
    main()
