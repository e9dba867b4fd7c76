"""Full-width parity: the port's CPU Calculator against the JAX Calculator
on the in-repo SevenNet-0 checkpoint, plus the golden file and the
jax-free import check.

Tolerances: energy rel 2e-6; forces and stress max-abs rel 1e-5 (float32
sums taken in another order over ~4,300 edges and five layers).

``test_port_imports_no_jax`` serves a structure, runs its graph with the
edge slots shuffled through ``run_blocks(edges_sorted=False)``, takes
a reEWC train step continuing the checkpoint's own optax state, runs
the train CLI (also data-parallel, ``-d`` in a gloo group of one rank),
``main get_model``, MD (both loops, and both over a halo decomposition of
two partitions), a D3 calculation,
``main inference`` with D3, a full-width serve of the mace, gaunt and
gaunt_gate families, a reference ``.pth`` load, the serial and parallel
TorchScript exports, the TorchScript importer and a read of a
JAX-written ``.sevenn_data`` on the CPU in a fresh interpreter, then
checks that neither jax, optax nor the JAX package was imported.  ``test_dispersion_matches_md_golden`` holds the port's D3
terms against the MD golden file.

The golden file (energies, forces and stress for every structure of
ft.extxyz, computed by the JAX Calculator on the CPU) is what
``chip_smoke.py`` holds the GPU run against.  Regenerate it with

    python tests/test_torch_calculator.py
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
CKPT = ROOT / 'experiments/ft_reewc_900/conv_out/checkpoint_best.pth'
FT = ROOT / 'experiments/ft_reewc/data/ft.extxyz'
GOLDEN = ROOT / 'sevennet_finetuning_tpu_torch/golden/ft_extxyz_jax_cpu.npz'
FISHER = ROOT / 'experiments/ft_reewc/fisher_out/fisher_sevenn.pt'
OPT_PARAMS = ROOT / 'experiments/ft_reewc/fisher_out/opt_params_sevenn.pt'
GOLDEN_FAMILIES = (ROOT / 'sevennet_finetuning_tpu_torch/golden/'
                   'families_jax_cpu.npz')

torch.set_num_threads(2)


def _jax_results(n=None):
    from sevennet_finetuning_tpu.calculator import Calculator
    from sevennet_finetuning_tpu.data.readers import read_extxyz

    calc = Calculator.from_checkpoint(str(CKPT))
    return [calc.calculate(s) for s in read_extxyz(str(FT))[:n]]


def _rel(a, b):
    return float(np.abs(np.asarray(a) - np.asarray(b)).max()
                 / np.abs(np.asarray(b)).max())


@pytest.fixture(scope='module')
def jax_two():
    return _jax_results(2)


@pytest.fixture(scope='module')
def port_two():
    from sevennet_finetuning_tpu_torch.calculator import Calculator
    from sevennet_finetuning_tpu_torch.data.readers import read_extxyz

    calc = Calculator.from_checkpoint(str(CKPT), device='cpu')
    return [calc.calculate(s) for s in read_extxyz(str(FT))[:2]]


@pytest.mark.parametrize('i', [0, 1])
def test_full_width_matches_jax(jax_two, port_two, i):
    want, got = jax_two[i], port_two[i]
    assert abs(got['energy'] - want['energy']) <= 2e-6 * abs(want['energy'])
    assert _rel(got['forces'], want['forces']) <= 1e-5
    assert _rel(got['stress'], want['stress']) <= 1e-5
    assert _rel(got['energies'], want['energies']) <= 1e-5


def test_golden_file_matches_jax(jax_two):
    gold = np.load(GOLDEN)
    assert gold['energy'].shape == (5,) and gold['stress'].shape == (5, 6)
    for i, want in enumerate(jax_two):
        assert abs(gold['energy'][i] - want['energy']) <= 2e-6 * abs(
            want['energy'])
        assert _rel(gold[f'forces_{i}'], want['forces']) <= 1e-5
        assert _rel(gold['stress'][i], want['stress']) <= 1e-5


def test_port_imports_no_jax(tmp_path):
    # a .sevenn_data written by the JAX package (it pickles the JAX
    # package's Structure class), which the port reads without importing
    # that package
    from sevennet_finetuning_tpu.data.dataset import (
        GraphDataset, save_sevenn_data)
    from sevennet_finetuning_tpu.data.readers import read_extxyz as j_read

    jax_sevenn_data = tmp_path / 'jax.sevenn_data'
    structs = j_read(str(FT))
    save_sevenn_data(str(jax_sevenn_data), GraphDataset.from_structures(
        structs, 4.0, {8: 0, 72: 1}), 4.0, {8: 0, 72: 1},
        structures=structs)
    code = (
        'import sys\n'
        'from sevennet_finetuning_tpu_torch.calculator import Calculator\n'
        'from sevennet_finetuning_tpu_torch.data.readers import read_extxyz\n'
        f'calc = Calculator.from_checkpoint({str(CKPT)!r}, device="cpu")\n'
        f's = read_extxyz({str(FT)!r})[4]\n'
        'r = calc.calculate(s)\n'
        'assert r["forces"].shape == (len(s), 3)\n'
        # the unsorted-dst path: run_blocks on the edge slots shuffled
        'import torch\n'
        'from sevennet_finetuning_tpu_torch import keys as K\n'
        'from sevennet_finetuning_tpu_torch.model.nequip import (\n'
        '    compute_edge_vec, embed_edges, embed_nodes, graph_energy,\n'
        '    run_blocks)\n'
        'b = calc.batch(s)\n'
        'p = torch.randperm(b[K.EDGE_IDX].shape[1],\n'
        '                   generator=torch.Generator().manual_seed(0))\n'
        'idx = b[K.EDGE_IDX][:, p]\n'
        'ev = compute_edge_vec(dict(b, **{K.EDGE_IDX: idx,\n'
        '                                 K.CELL_SHIFT: b[K.CELL_SHIFT][p]}))\n'
        'sp, pr = calc.model.spec, calc.model.params\n'
        '_, emb, attr = embed_edges(sp, pr, ev, b[K.EDGE_MASK][p])\n'
        'oh, x = embed_nodes(sp, pr, b[K.ATOM_TYPE], ev.dtype)\n'
        'x = run_blocks(sp, pr, x, oh, emb, attr, idx[1], idx[0],\n'
        '               b[K.POS].shape[0], edges_sorted=False)\n'
        'e = float(graph_energy(sp, pr, x, b)[2][0])\n'
        'assert abs(e - r["energy"]) <= 1e-5 * abs(r["energy"]), (e, r)\n'
        # a reEWC train step on the CPU: trainer, loss, adam, Fisher files
        'from sevennet_finetuning_tpu_torch.data.dataset import '
        'GraphDataset, Loader\n'
        'from sevennet_finetuning_tpu_torch.train.checkpoint import '
        'load_checkpoint, load_pytree, model_from_checkpoint\n'
        'from sevennet_finetuning_tpu_torch.train.trainer import Trainer\n'
        f'model, cfg = model_from_checkpoint({str(CKPT)!r}, device="cpu")\n'
        'cfg["continue"] = {"fisher_information": "f", "opt_params": "o", '
        '"ewc_lambda": 1e5}\n'
        f'tr = Trainer(model, cfg, fisher=load_pytree({str(FISHER)!r}), '
        f'opt_params=load_pytree({str(OPT_PARAMS)!r}), device="cpu")\n'
        # a continue without reset: the checkpoint's own adam state
        f'cb = load_checkpoint({str(CKPT)!r})\n'
        'tr.load_state_dicts(cb["model_state_dict"], '
        'cb["optimizer_state_dict"], cb["scheduler_state_dict"])\n'
        'assert float(tr.optimizer.state_dict()["state"][0]["step"]) == '
        '69660\n'
        'ds = GraphDataset.from_structures([s], 5.0, dict(model.spec.type_map))\n'
        'm = tr.run_one_epoch(Loader(ds, 1), is_train=True)\n'
        'assert m["TotalLoss_None"] > 0, m\n'
        # the same step with every block rematerialized
        'tr.remat = True\n'
        'mr = tr.run_one_epoch(Loader(ds, 1), is_train=True)\n'
        'assert 0 < mr["TotalLoss_None"] < float("inf"), mr\n'
        # the measurement probes: their modules and plain versions
        'from sevennet_finetuning_tpu_torch.tools import bench_dma, '
        'hopper_feats\n'
        'pin = {k: torch.as_tensor(v) for k, v in '
        'hopper_feats.probe_inputs().items()}\n'
        'assert torch.equal(hopper_feats.transpose(pin["x"]), pin["x"].t())\n'
        'assert torch.equal(hopper_feats.split3(pin["v"])[1], pin["v"])\n'
        'dot = hopper_feats.dot_lane_contract(pin["a"], pin["b"])\n'
        'assert (dot - pin["a"].t() @ pin["b"]).abs().max() < 1e-4\n'
        'assert torch.equal(hopper_feats.window(pin["y"], pin["sel"]),\n'
        '                   pin["y"][320:384])\n'
        'slab = torch.randn(64, 64, generator=torch.Generator().manual_seed(0))\n'
        'assert torch.equal(bench_dma.copy_tiled(slab, 8), slab * bench_dma.C)\n'
        'assert torch.equal(bench_dma.copy_ring(slab, 8, 2),\n'
        '                   slab * bench_dma.C)\n'
        'assert bench_dma.colsum(slab, 8).shape == (1, 64)\n'
        # the train CLI from scratch on the CPU: config, presets, pipeline,
        # init_params, epoch loop, checkpoint writing and reading
        'import tempfile\n'
        'from pathlib import Path\n'
        'from sevennet_finetuning_tpu_torch.main import main as cli\n'
        'from sevennet_finetuning_tpu_torch.train.checkpoint import '
        'load_checkpoint\n'
        'tmp = Path(tempfile.mkdtemp())\n'
        '(tmp / "in.yaml").write_text("\\n".join([\n'
        '    "model: {chemical_species: auto, cutoff: 4.0, channel: 4, "\n'
        '    "lmax: 1, num_convolution_layer: 2, is_parity: false, "\n'
        '    "self_connection_type: linear}",\n'
        '    "train: {epoch: 1, per_epoch: 1}",\n'
        f'    "data: {{batch_size: 2, load_dataset_path: [{str(FT)}], "\n'
        '    "data_divide_ratio: 0.2}"]))\n'
        'cli(["train", str(tmp / "in.yaml"), "-w", str(tmp / "out"), '
        '"--device", "cpu"])\n'
        'blob = load_checkpoint(str(tmp / "out" / "checkpoint_1.pth"))\n'
        'assert blob["epoch"] == 1 and blob["optimizer_state_dict"]\n'
        'cli(["preset", "base"])\n'
        # MD, D3, get_model and inference on the CPU
        'from sevennet_finetuning_tpu_torch.data.vasp import Structure\n'
        'from sevennet_finetuning_tpu_torch.md import VelocityVerlet\n'
        'import numpy as np\n'
        'cli(["get_model", str(tmp / "out" / "checkpoint_1.pth"), "-o",\n'
        '     str(tmp / "dep.sevenn")])\n'
        'dep = Calculator.from_deployed(str(tmp / "dep.sevenn"), device="cpu")\n'
        'md = VelocityVerlet(s, calculator=dep, dt_fs=1.0)\n'
        'md.set_temperature(300.0, seed=0)\n'
        'md.run_device(3, seg_steps=2)\n'
        'md.run(2)\n'
        'assert np.isfinite(md.result.total).all() and md.result.segments\n'
        # halo-parallel MD over two partitions and data-parallel training
        # in a process group (a rank of one, gloo)
        'hmd = VelocityVerlet(s, calculator=dep, dt_fs=1.0,\n'
        '                     halo={"n_dev": 2})\n'
        'hmd.set_temperature(300.0, seed=0)\n'
        'hmd.run_device_halo(2, seg_steps=2)\n'
        'hmd.run(1)\n'
        'assert np.isfinite(hmd.result.total).all()\n'
        'import os, socket\n'
        'with socket.socket() as so:\n'
        '    so.bind(("localhost", 0))\n'
        '    port = so.getsockname()[1]\n'
        'os.environ.update(RANK="0", WORLD_SIZE="1", LOCAL_RANK="0",\n'
        '                  MASTER_ADDR="localhost", MASTER_PORT=str(port))\n'
        # (with every block rematerialized)
        '(tmp / "dp.yaml").write_text((tmp / "in.yaml").read_text()\n'
        '    .replace("per_epoch: 1}", "per_epoch: 1, remat: true}"))\n'
        'from sevennet_finetuning_tpu_torch.model import nequip\n'
        'calls, apply = [], nequip._RematBlock.apply\n'
        'nequip._RematBlock.apply = lambda *a: calls.append(1) or apply(*a)\n'
        'cli(["train", str(tmp / "dp.yaml"), "-w", str(tmp / "dp"), "-d",\n'
        '     "--device", "cpu"])\n'
        'nequip._RematBlock.apply = apply\n'
        'assert (tmp / "dp" / "log.csv").exists() and calls\n'
        'd3c = Calculator(dep.spec, load_checkpoint(str(tmp / "dep.sevenn"))\n'
        '                 ["model_state_dict"], device="cpu",\n'
        '                 d3={"functional": "pbe", "damping": "zero",\n'
        '                     "cutoff": 15.0, "cn_cutoff": 10.0})\n'
        'e3, f3, s3 = d3c.d3_terms(s)\n'
        'assert e3 < 0 and f3.shape == (len(s), 3)\n'
        'from sevennet_finetuning_tpu_torch.data.readers import write_extxyz\n'
        'write_extxyz(str(tmp / "s12.extxyz"), [s])\n'
        'cli(["inference", str(tmp / "dep.sevenn"), str(tmp / "s12.extxyz"),\n'
        '     "-o", str(tmp / "inf"), "--d3", "pbe,bj", "--device", "cpu"])\n'
        'assert (tmp / "inf" / "per_atom.csv").exists()\n'
        # the MACE and Gaunt families at full width: a CPU serve of each
        # configuration of the families golden
        'import json\n'
        'from sevennet_finetuning_tpu_torch.model.build import '
        'build_model_spec\n'
        'from sevennet_finetuning_tpu_torch.model.nequip import init_params\n'
        f'fam = np.load({str(GOLDEN_FAMILIES)!r})\n'
        'for name, fc in json.loads(str(fam["configs"])).items():\n'
        '    fc[K.TYPE_MAP] = {int(z): i for z, i in fc[K.TYPE_MAP]}\n'
        '    fs = build_model_spec(fc)\n'
        '    fr = Calculator(fs, init_params(fs, 0), device="cpu")'
        '.calculate(s)\n'
        '    want = float(fam[name + "/energy"][4])\n'
        '    assert abs(fr["energy"] - want) <= 2e-6 * abs(want), name\n'
        # checkpoint and deploy interop: a reference .pth, the serial and
        # parallel TorchScript exports, the TorchScript importer, a
        # JAX-written .sevenn_data
        'from sevennet_finetuning_tpu_torch.compat.state_dict_import import '
        '(\n    state_dict_from_params)\n'
        'from sevennet_finetuning_tpu_torch.compat.torchscript_export import '
        'export_serial\n'
        'from sevennet_finetuning_tpu_torch.compat.torchscript_export_parallel'
        ' import export_parallel\n'
        'from sevennet_finetuning_tpu_torch.compat.torchscript_import import '
        'import_deployed_serial\n'
        'from sevennet_finetuning_tpu_torch.data.dataset import '
        'load_sevenn_data, sevenn_data_structures\n'
        'small = load_checkpoint(str(tmp / "out" / "checkpoint_1.pth"))\n'
        'ss = build_model_spec(small["config"])\n'
        'sd = state_dict_from_params(ss, small["model_state_dict"])\n'
        'torch.save({"model_state_dict": {k: torch.from_numpy(v) for k, v '
        'in sd.items()}, "config": small["config"], "epoch": 1},\n'
        '           str(tmp / "ref.pth"))\n'
        'rb = load_checkpoint(str(tmp / "ref.pth"))\n'
        'ref_calc = Calculator.from_checkpoint(str(tmp / "ref.pth"), '
        'device="cpu")\n'
        'ts = export_serial(ss, rb["model_state_dict"], str(tmp / "ts"))\n'
        'segs = export_parallel(ss, rb["model_state_dict"], str(tmp / "par"))\n'
        'assert len(segs) == 2 and torch.jit.load(ts) is not None\n'
        'try:\n'
        '    import_deployed_serial(ts)\n'
        'except RuntimeError as e:\n'
        '    assert "weight import incomplete" in str(e)\n'
        f'jd = load_sevenn_data({str(jax_sevenn_data)!r})\n'
        f'assert len(jd) == 5 and len(sevenn_data_structures('
        f'{str(jax_sevenn_data)!r})) == 5\n'
        'bad = sorted(m for m in sys.modules if m.split(".")[0] in '
        '("jax", "jaxlib", "optax") or m.split(".")[0] == '
        '"sevennet_finetuning_tpu")\n'
        'print("BAD", bad)\n'
        'assert not bad, bad\n'
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    res = subprocess.run([sys.executable, '-c', code], cwd=str(ROOT),
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    assert 'BAD []' in res.stdout


def test_entry_points_need_cuda_unless_asked(monkeypatch):
    from sevennet_finetuning_tpu_torch import resolve_device
    from sevennet_finetuning_tpu_torch.calculator import Calculator

    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='CUDA'):
        resolve_device(None)
    with pytest.raises(RuntimeError, match='CUDA'):
        Calculator.from_checkpoint(str(CKPT))
    assert resolve_device('cpu') == torch.device('cpu')


def test_dispersion_matches_md_golden():
    """``Calculator(d3=...)`` on SevenNet-0 gives the JAX-CPU golden's D3
    terms and GNN + D3 totals for the 12-atom structure (D3 energy rel
    1e-5, forces and stress 1e-4 of max; totals at the serving limits)."""
    from sevennet_finetuning_tpu_torch.calculator import Calculator
    from sevennet_finetuning_tpu_torch.data.readers import read_extxyz
    from sevennet_finetuning_tpu_torch.model.build import build_model_spec
    from sevennet_finetuning_tpu_torch.train.checkpoint import (
        load_checkpoint)

    blob = load_checkpoint(str(CKPT))
    # the JAX checkpoint's optax state, kept without optax
    assert blob['optimizer_state_dict'].optax_name == \
        'InjectStatefulHyperparamsState'
    spec = build_model_spec(blob['config'])
    calc = Calculator(spec, blob['model_state_dict'], device='cpu',
                      d3={'functional': 'pbe', 'damping': 'bj'})
    gold = np.load(ROOT / 'sevennet_finetuning_tpu_torch/golden/'
                   'md_hfo2_jax_cpu.npz')
    s = read_extxyz(str(FT))[4]
    e3, f3, s3 = calc.d3_terms(s)
    assert abs(e3 - gold['d3_energy'][4]) <= 1e-5 * abs(gold['d3_energy'][4])
    assert _rel(f3, gold['d3_forces_4']) <= 1e-4
    assert _rel(s3, gold['d3_stress'][4]) <= 1e-4
    res = calc.calculate(s)
    assert abs(res['energy'] - gold['total_energy'][4]) <= 2e-6 * abs(
        gold['total_energy'][4])
    assert _rel(res['forces'], gold['total_forces_4']) <= 1e-4
    assert _rel(res['stress'], gold['total_stress'][4]) <= 1e-4


def _write_golden():
    res = _jax_results()
    arrays = {
        'energy': np.array([r['energy'] for r in res], np.float64),
        'stress': np.stack([np.asarray(r['stress'], np.float64)
                            for r in res]),
    }
    for i, r in enumerate(res):
        arrays[f'forces_{i}'] = np.asarray(r['forces'], np.float64)
    GOLDEN.parent.mkdir(parents=True, exist_ok=True)
    np.savez(GOLDEN, **arrays)
    print(f'wrote {GOLDEN}: energies {arrays["energy"]}')


if __name__ == '__main__':
    sys.path.insert(0, str(ROOT))
    import jax

    jax.config.update('jax_platforms', 'cpu')
    _write_golden()
