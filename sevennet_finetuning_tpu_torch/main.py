"""Command-line entry points.

Port of ``sevennet_finetuning_tpu/main.py`` (the counterpart of the
reference CLI family, reference: sevenn/main/*.py):

    python -m sevennet_finetuning_tpu_torch.main train input.yaml [-w dir]
    python -m sevennet_finetuning_tpu_torch.main train input.yaml -fs
    python -m sevennet_finetuning_tpu_torch.main preset <name>
    python -m sevennet_finetuning_tpu_torch.main get_model <checkpoint> [-o out] [-ts [-p]]
    python -m sevennet_finetuning_tpu_torch.main inference <checkpoint> <data...>
    python -m sevennet_finetuning_tpu_torch.main graph_build <data> <cutoff> [-o out]

``train`` and ``inference`` run on ``cuda`` unless ``--device`` names
another device (``--device cpu``).  ``get_model`` writes the npz deploy
artifact, which both packages read, and with ``--torchscript`` also the
reference's TorchScript deploy format (``deployed_serial.pt``, or with
``-p`` the ``deployed_parallel_{i}.pt`` segment chain) that LAMMPS
``pair_e3gnn`` loads.  ``graph_build`` writes a ``.sevenn_data``
artifact.  Data-parallel training (``-d``) is not ported yet and raises
``NotImplementedError`` with its ROADMAP item (A.8).
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


def cmd_get_model(args):
    """Deploy a checkpoint as a self-contained potential artifact (the
    counterpart of the reference's sevenn_get_model, reference:
    sevenn/main/sevenn_get_model.py): the pickle-free npz + JSON
    artifact of ``train.checkpoint.save_deployed``; with --torchscript
    also the reference's serial TorchScript (``<out>.pt``) or, with -p,
    its parallel segment chain (``<out>_parallel/``)."""
    import numpy as np

    from . import keys as K
    from .train.checkpoint import load_checkpoint, save_deployed

    if not os.path.exists(args.checkpoint):
        # pretrained names, like the reference CLI (reference:
        # sevenn/main/sevenn_get_model.py + util.pretrained_name_to_path)
        from .compat.known_models import pretrained_name_to_path

        args.checkpoint = pretrained_name_to_path(args.checkpoint)
    blob = load_checkpoint(args.checkpoint)
    config = blob['config']
    out = args.output or (
        'deployed_parallel.sevenn' if args.parallel
        else 'deployed_serial.sevenn'
    )
    # strip training-only state; emit the pickle-free npz+json artifact
    save_deployed(out, blob['model_state_dict'], config)
    n_par = sum(
        int(np.prod(np.shape(v)))
        for g in blob['model_state_dict'].values()
        for v in (g.values() if isinstance(g, dict) else [g])
    )
    tm = config.get(K.TYPE_MAP, {})
    print(f'deployed {out}: {n_par} weights, cutoff '
          f'{config.get(K.CUTOFF)}, {len(tm)} species')
    print('load with Calculator.from_deployed(...) or '
          'Calculator.from_checkpoint(...)')
    if getattr(args, 'torchscript', False):
        from .model.build import build_model_spec

        spec = build_model_spec(config)
        params = blob['model_state_dict']
        if args.parallel:
            # reference multi-GPU LAMMPS segment chain
            # (sevenn/scripts/deploy.py:55-117)
            from .compat.torchscript_export_parallel import export_parallel

            ts_dir = os.path.splitext(out)[0] + '_parallel'
            paths = export_parallel(spec, params, ts_dir)
            print('TorchScript (reference parallel deploy format): '
                  f'{len(paths)} segments in {ts_dir}/')
        else:
            from .compat.torchscript_export import export_serial

            ts_out = os.path.splitext(out)[0] + '.pt'
            export_serial(spec, params, ts_out)
            print('TorchScript (reference serial deploy format): '
                  f'{ts_out}')


def cmd_inference(args):
    from .scripts.inference import inference_main

    dispersion = None
    if getattr(args, 'd3', None):
        parts = [p.strip() for p in args.d3.split(',')]
        dispersion = {'functional': parts[0]}
        if len(parts) > 1:
            dispersion['damping'] = parts[1]
    inference_main(args.checkpoint, args.data, output_dir=args.output,
                   batch_size=args.batch, dispersion=dispersion,
                   device=args.device)


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


def cmd_graph_build(args):
    """Prebuild the graphs of a data file into a .sevenn_data artifact,
    atoms typed by the file's own species (the JAX CLI's graph_build)."""
    from .data.dataset import GraphDataset, save_sevenn_data
    from .data.elements import type_map_from_species
    from .pipeline import _read_file

    structs = _read_file(args.source, 'structure_list')
    tm = type_map_from_species({sp for s in structs for sp in s.species})
    ds = GraphDataset.from_structures(structs, args.cutoff, tm,
                                      n_cores=args.num_cores)
    out = args.output or 'graph_built.sevenn_data'
    save_sevenn_data(out, ds, args.cutoff, tm, structures=structs)
    print(f'saved {len(ds)} graphs to {out}')


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

    gm = sub.add_parser('get_model', help='deploy a checkpoint as a '
                        'self-contained potential artifact')
    gm.add_argument('checkpoint')
    gm.add_argument('-o', '--output')
    gm.add_argument('-ts', '--torchscript', action='store_true',
                    help='also emit a reference-compatible TorchScript '
                         'deployed_serial.pt (LAMMPS interop)')
    gm.add_argument('-p', '--parallel', action='store_true',
                    help='name the artifact for parallel MD use')
    gm.set_defaults(func=cmd_get_model)

    pr = sub.add_parser('preset', help='print a preset input yaml')
    pr.add_argument('name')
    pr.set_defaults(func=cmd_preset)

    inf = sub.add_parser('inference', help='batch inference on structures')
    inf.add_argument('checkpoint')
    inf.add_argument('data', nargs='+')
    inf.add_argument('-o', '--output', default='sevenn_infer_result')
    inf.add_argument('-b', '--batch', type=int, default=5)
    inf.add_argument('--d3', default=None, metavar='FUNC,DAMP',
                     help="add Grimme D3 dispersion, e.g. 'pbe,bj' or "
                          "'pbe,zero' (overrides the checkpoint "
                          "config's 'dispersion' key)")
    inf.add_argument('--device', default=None,
                     help="torch device (default: cuda; 'cpu' to run on "
                          'the CPU)')
    inf.set_defaults(func=cmd_inference)

    g = sub.add_parser('graph_build', help='prebuild graphs from data')
    g.add_argument('source')
    g.add_argument('cutoff', type=float)
    g.add_argument('-o', '--output')
    g.add_argument('-n', '--num-cores', type=int, default=1)
    g.set_defaults(func=cmd_graph_build)

    args = p.parse_args(argv)
    return args.func(args)


if __name__ == '__main__':
    main()
