"""Checkpoint and deploy interop of the port against the JAX package, on
the CPU: ``compat/state_dict_import``, ``compat/torchscript_export`` /
``_parallel``, ``compat/torchscript_import``, their entry points
(``load_checkpoint``, ``Calculator.from_checkpoint`` /
``from_deployed_torchscript``, ``main get_model --torchscript``) and the
ASE adapter.

- state dicts: the same ``flat_schema``, the same bits from
  ``state_dict_from_params``, a bit-equal round trip, strict mode raising
  as JAX's does, and ``import_reference_checkpoint`` of a fabricated
  training ``.pth`` giving JAX's config, epoch and params;
- serial export: the port's and JAX's ``export_serial`` of the same
  params, each run through the input dict of LAMMPS ``pair_e3gnn``: the
  two artifacts agree within 1e-6 (energy, relative) and 1e-5 of max
  (forces, stress) -- they read bit-equal here -- and each meets JAX's
  ``apply_model`` at the JAX test's limits (energy 1e-4 eV/atom, forces
  2e-4 eV/A, stress 2e-5, atomic energies summing to the total);
- parallel export: the segment chain in one domain and in two domains
  with the halo exchange (the JAX test's harness), against JAX's
  ``export_parallel`` chain and ``apply_model``;
- import, function by function on one JAX-exported artifact: the same
  ``_expected_sequence``, ``_extract_weight_ops`` and
  ``_config_from_frozen``, and ``import_deployed_serial`` failing with
  JAX's ``matched k/n`` error (the exporter writes dense matrices, the
  importer reads e3nn's frozen graphs: a property of the JAX package);
- ``SevenNetASECalculator`` through a stub ``ase`` module.

Models are narrow: the JAX tests' small config (8 channels, lmax 1, 3
convolutions, species-wise shift/scale) with a linear and with an FCTP
('nequip') self-connection.  Structures: ft.extxyz structure 4 (12
atoms) and the first 8 atoms of structure 0 in its 96-atom cell.  The
JAX side runs under ``jax.enable_x64(False)``.
"""

import argparse
import functools
import sys
import types
import warnings
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
FT = ROOT / 'experiments/ft_reewc/data/ft.extxyz'
SC_TYPES = ('linear', 'nequip')

torch.set_num_threads(2)


@pytest.fixture(autouse=True, scope='module')
def _native_neighbor_list():
    with pytest.MonkeyPatch.context() as mp:
        mp.delenv('SEVENN_NO_NATIVE', raising=False)
        yield


def _small_config(**over):
    """The JAX state-dict tests' config (three species, lmax 2)."""
    from sevennet_finetuning_tpu_torch import keys as K

    cfg = {K.NUM_SPECIES: 3, K.TYPE_MAP: {8: 0, 72: 1, 1: 2},
           K.NODE_FEATURE_MULTIPLICITY: 4, K.LMAX: 2,
           K.NUM_CONVOLUTION: 2, K.CUTOFF: 4.0, K.IS_PARITY: True,
           K.CONV_DENOMINATOR: [7.0, 9.0], K.SHIFT: -1.5, K.SCALE: 2.0,
           K.SELF_CONNECTION_TYPE: 'nequip'}
    cfg.update(over)
    return cfg


def _schema_cases():
    from sevennet_finetuning_tpu_torch import keys as K

    return [{}, {K.SELF_CONNECTION_TYPE: 'linear', K.IS_PARITY: False},
            {K.USE_BIAS_IN_LINEAR: True},
            {K.READOUT_AS_FCN: True, K.READOUT_FCN_HIDDEN_NEURONS: [10, 10]},
            {K.SHIFT: [0.1, 0.2, 0.3], K.SCALE: [1.0, 2.0, 3.0]}]


def _export_config(sc):
    """The JAX export tests' ``_make_small`` config with ``sc`` as its
    self-connection."""
    from sevennet_finetuning_tpu_torch import keys as K

    return {K.NUM_SPECIES: 2, K.TYPE_MAP: {8: 0, 72: 1},
            K.NODE_FEATURE_MULTIPLICITY: 8, K.LMAX: 1,
            K.NUM_CONVOLUTION: 3, K.CUTOFF: 4.5, K.IS_PARITY: True,
            K.CONV_DENOMINATOR: 20.0, K.SHIFT: [-3.0, -2.0],
            K.SCALE: [1.1, 0.9], K.SELF_CONNECTION_TYPE: sc}


def _specs(cfg):
    from sevennet_finetuning_tpu.model.build import build_model_spec as jb
    from sevennet_finetuning_tpu_torch.model.build import build_model_spec

    return build_model_spec(cfg), jb(cfg)


def _params(cfg, seed=3):
    from sevennet_finetuning_tpu_torch.model.nequip import init_params

    return init_params(_specs(cfg)[0], seed=seed)


def _same_tree(a, b):
    assert set(a) == set(b)
    for g in a:
        assert set(a[g]) == set(b[g]), g
        for n in a[g]:
            x, y = np.asarray(a[g][n]), np.asarray(b[g][n])
            assert x.dtype == y.dtype and np.array_equal(x, y), (g, n)


def _structures():
    """ft.extxyz structure 4 (12 atoms) and the first 8 atoms of
    structure 0 in its 96-atom cell."""
    from sevennet_finetuning_tpu_torch.data.readers import read_extxyz
    from sevennet_finetuning_tpu_torch.data.vasp import Structure

    structs = read_extxyz(str(FT))
    s0 = structs[0]
    cut = Structure(species=s0.species[:8], pos=s0.pos[:8], cell=s0.cell,
                    pbc=s0.pbc)
    return [structs[4], cut]


@functools.lru_cache(maxsize=None)
def _jax_reference_of(sc, i):
    """(energy, forces, stress, graph) of JAX's apply_model for
    ``_export_config(sc)`` at ``_params``' seed on structure i of
    ``_structures()``; both structures go through one jitted call, once
    per session."""
    return _jax_references(sc)[i]


@functools.lru_cache(maxsize=None)
def _jax_references(sc):
    import jax
    import jax.numpy as jnp

    from sevennet_finetuning_tpu import keys as JK
    from sevennet_finetuning_tpu.model.graph import (
        collate, structure_to_graph)
    from sevennet_finetuning_tpu.model.nequip import apply_model

    cfg = _export_config(sc)
    spec = _specs(cfg)[1]
    structs = _structures()
    gs = [structure_to_graph(s, spec.cutoff, dict(spec.type_map))
          for s in structs]
    n = [len(s) for s in structs]
    b = collate(gs, n_node=sum(n),
                n_edge=sum(g[JK.EDGE_IDX].shape[1] for g in gs),
                n_graph=len(gs))
    with jax.enable_x64(False):
        b = {k: jnp.asarray(v) for k, v in b.items()
             if k not in (JK.INFO, JK.USER_LABEL)}
        p = jax.tree_util.tree_map(jnp.asarray, _params(cfg))
        out = jax.jit(lambda p, b: apply_model(spec, p, b))(p, b)
        forces = np.asarray(out[JK.PRED_FORCE])
        return [(float(out[JK.PRED_TOTAL_ENERGY][i]),
                 forces[sum(n[:i]):sum(n[:i + 1])],
                 np.asarray(out[JK.PRED_STRESS][i]), gs[i])
                for i in range(len(gs))]


def _pair_e3gnn_inputs(type_map, s, g):
    """The dict pair_e3gnn.cpp:205-215 builds for this cell."""
    from sevennet_finetuning_tpu_torch import keys as K

    pos = torch.tensor(np.asarray(s.pos), dtype=torch.float32,
                       requires_grad=True)
    return {
        'x': torch.tensor([type_map[z] for z in s.atomic_numbers],
                          dtype=torch.long),
        'pos': pos,
        'edge_index': torch.tensor(np.asarray(g[K.EDGE_IDX]),
                                   dtype=torch.long),
        'pbc_shift': torch.tensor(np.asarray(g[K.CELL_SHIFT]),
                                  dtype=torch.float32),
        'cell_lattice_vectors': torch.tensor(np.asarray(s.cell),
                                             dtype=torch.float32),
        'cell_volume': torch.tensor(float(s.volume)),
        'num_atoms': torch.tensor(len(s)),
    }


META_KEYS = ('chemical_symbols_to_index', 'cutoff', 'num_species',
             'model_type', 'version', 'dtype', 'time')


def _load_artifact(path, keys=META_KEYS):
    extra = dict.fromkeys(keys, '')
    model = torch.jit.load(str(path), _extra_files=extra)
    return model, {k: v.decode() if isinstance(v, bytes) else v
                   for k, v in extra.items()}


def _run_serial(model, type_map, s, g):
    out = model(_pair_e3gnn_inputs(type_map, s, g))
    return {k: v.detach().numpy() for k, v in out.items()}


def _rel(a, b):
    return float(np.abs(np.asarray(a) - np.asarray(b)).max()
                 / max(np.abs(np.asarray(b)).max(), 1e-30))


# --- state dicts -------------------------------------------------------------

@pytest.mark.parametrize('case', range(5))
def test_flat_schema_matches_jax(case):
    from sevennet_finetuning_tpu.compat import state_dict_import as J
    from sevennet_finetuning_tpu_torch.compat import state_dict_import as P

    cfg = _small_config(**_schema_cases()[case])
    spec, j_spec = _specs(cfg)
    assert P.flat_schema(spec) == J.flat_schema(j_spec)


@pytest.mark.parametrize('case', range(5))
def test_state_dict_round_trip_matches_jax(case):
    from sevennet_finetuning_tpu.compat import state_dict_import as J
    from sevennet_finetuning_tpu_torch.compat import state_dict_import as P

    cfg = _small_config(**_schema_cases()[case])
    spec, j_spec = _specs(cfg)
    params = _params(cfg)
    sd = P.state_dict_from_params(spec, params)
    j_sd = J.state_dict_from_params(j_spec, params)
    assert list(sd) == list(j_sd)
    for k in sd:
        assert sd[k].dtype == j_sd[k].dtype and np.array_equal(sd[k],
                                                               j_sd[k]), k
    _same_tree(P.params_from_state_dict(spec, sd, strict=True), params)
    _same_tree(P.params_from_state_dict(spec, sd, strict=True),
               J.params_from_state_dict(j_spec, j_sd, strict=True))


def test_strict_mode_raises_like_jax():
    from sevennet_finetuning_tpu.compat import state_dict_import as J
    from sevennet_finetuning_tpu_torch.compat import state_dict_import as P

    cfg = _small_config()
    spec, j_spec = _specs(cfg)
    sd = P.state_dict_from_params(spec, _params(cfg, 0))
    for mutate, exc, match in (
            (lambda d: d.__setitem__('bogus.layer.weight',
                                     np.zeros(3, np.float32)),
             RuntimeError, 'bogus'),
            (lambda d: d.__setitem__('0_self_interaction_1.linear.weight',
                                     np.zeros(7, np.float32)),
             ValueError, 'architecture config mismatch'),
            (lambda d: d.pop('0_self_interaction_2.linear.weight'),
             RuntimeError, 'unfilled schema keys')):
        bad = dict(sd)
        mutate(bad)
        msgs = []
        for mod, s in ((P, spec), (J, j_spec)):
            with pytest.raises(exc, match=match) as info:
                mod.params_from_state_dict(s, bad, strict=True)
            msgs.append(str(info.value))
        assert msgs[0] == msgs[1]
    # the buffers a named-parameter dump lacks take the spec's defaults
    dump = {k: v for k, v in sd.items()
            if not k.endswith(('.denominator', 'basis_function.coeffs'))}
    _same_tree(P.params_from_state_dict(spec, dump),
               J.params_from_state_dict(j_spec, dump))


def _reference_pth(tmp_path, cfg, params, epoch=5, name='checkpoint_5.pth'):
    """A reference training checkpoint: torch.save of the layout of the
    reference's trainer.py:98-107."""
    from sevennet_finetuning_tpu_torch.compat.state_dict_import import (
        state_dict_from_params)

    spec = _specs(cfg)[0]
    sd = {k: torch.from_numpy(np.asarray(v))
          for k, v in state_dict_from_params(spec, params).items()}
    path = tmp_path / name
    torch.save({'model_state_dict': sd, 'config': cfg, 'epoch': epoch,
                'optimizer_state_dict': {}, 'scheduler_state_dict': {}},
               str(path))
    return path


def test_import_reference_checkpoint_matches_jax(tmp_path):
    from sevennet_finetuning_tpu import keys as JK
    from sevennet_finetuning_tpu.compat import state_dict_import as J
    from sevennet_finetuning_tpu_torch import keys as K
    from sevennet_finetuning_tpu_torch.compat import state_dict_import as P
    from sevennet_finetuning_tpu_torch.data.elements import z_to_symbol

    cfg = _small_config()
    # the reference stores its type map by chemical symbol
    ref_cfg = dict(cfg, **{K.TYPE_MAP: {z_to_symbol(z): i for z, i in
                                        cfg[K.TYPE_MAP].items()}})
    params = _params(cfg, 11)
    path = _reference_pth(tmp_path, ref_cfg, params)
    spec, got, config, epoch = P.import_reference_checkpoint(str(path))
    j_spec, want, j_config, j_epoch = J.import_reference_checkpoint(
        str(path))
    assert epoch == j_epoch == 5
    assert config == j_config
    assert config[K.TYPE_MAP] == cfg[K.TYPE_MAP]
    assert config[K.CONV_DENOMINATOR] == [7.0, 9.0]
    assert config[K.SHIFT] == pytest.approx(-1.5)
    _same_tree(got, params)
    _same_tree(got, want)
    assert spec.num_species == j_spec.num_species == 3
    assert JK.TYPE_MAP == K.TYPE_MAP

    # a bare state dict needs the architecture from the caller
    bare = tmp_path / 'bare.pt'
    torch.save({k: torch.from_numpy(v) for k, v in
                P.state_dict_from_params(spec, params).items()}, str(bare))
    for mod in (P, J):
        with pytest.raises(ValueError, match='bare state dict'):
            mod.import_reference_checkpoint(str(bare))
    _, got, _, _ = P.import_reference_checkpoint(str(bare), cfg)
    _, want, _, _ = J.import_reference_checkpoint(str(bare), cfg)
    _same_tree(got, want)


def test_load_checkpoint_reads_reference_pth(tmp_path):
    """``load_checkpoint`` and ``Calculator.from_checkpoint`` on a
    reference .pth: JAX's blob, and JAX's model's results (energy 1e-6
    rel, forces and stress 1e-4 of max)."""
    from sevennet_finetuning_tpu.train import checkpoint as jck
    from sevennet_finetuning_tpu_torch.calculator import Calculator
    from sevennet_finetuning_tpu_torch.train import checkpoint as ck

    cfg = _export_config('linear')
    params = _params(cfg)
    path = _reference_pth(tmp_path, cfg, params, epoch=42)
    blob, j_blob = ck.load_checkpoint(str(path)), jck.load_checkpoint(
        str(path))
    assert blob['epoch'] == j_blob['epoch'] == 42
    assert blob['config'] == j_blob['config']
    assert blob['optimizer_state_dict'] is None
    _same_tree(blob['model_state_dict'], params)
    calc = Calculator.from_checkpoint(str(path), device='cpu')
    for name, p in calc.model.params.items():
        for n, v in p.items():
            assert np.array_equal(v.detach().numpy(), params[name][n])
    got = calc.calculate(_structures()[0])
    energy, forces, stress, _ = _jax_reference_of('linear', 0)
    assert abs(got['energy'] - energy) <= 1e-6 * abs(energy)
    assert _rel(got['forces'], forces) <= 1e-4
    assert _rel(got['stress'], stress) <= 1e-4


# --- serial export -----------------------------------------------------------

@pytest.fixture(scope='module')
def exported(tmp_path_factory):
    """{sc: (params, port artifact, JAX artifact)} of the narrow models."""
    from sevennet_finetuning_tpu.compat.torchscript_export import (
        export_serial as j_export)
    from sevennet_finetuning_tpu_torch.compat.torchscript_export import (
        export_serial)

    tmp = tmp_path_factory.mktemp('serial')
    out = {}
    for sc in SC_TYPES:
        cfg = _export_config(sc)
        spec, j_spec = _specs(cfg)
        params = _params(cfg)
        with warnings.catch_warnings():
            warnings.simplefilter('ignore')
            port = export_serial(spec, params, str(tmp / f'port_{sc}'))
            jax_path = j_export(j_spec, params, str(tmp / f'jax_{sc}'))
        out[sc] = (params, port, jax_path)
    return out


@pytest.mark.parametrize('sc', SC_TYPES)
def test_export_serial_matches_jax(exported, sc):
    cfg = _export_config(sc)
    params, port, jax_path = exported[sc]
    model, meta = _load_artifact(port)
    j_model, j_meta = _load_artifact(jax_path)
    for key in META_KEYS:
        if key not in ('time', 'version'):
            assert meta[key] == j_meta[key], key
    assert meta['chemical_symbols_to_index'] == 'O Hf'
    assert meta['version'].startswith('sevennet_finetuning_tpu_torch')
    tm = cfg['_type_map']
    for i, s in enumerate(_structures()):
        e_ref, f_ref, st_ref, g = _jax_reference_of(sc, i)
        got = _run_serial(model, tm, s, g)
        want = _run_serial(j_model, tm, s, g)
        e = float(got['inferred_total_energy'])
        assert abs(e - float(want['inferred_total_energy'])) <= 1e-6 * abs(e)
        for key in ('inferred_force', 'inferred_stress', 'atomic_energy'):
            assert _rel(got[key], want[key]) <= 1e-5, key
        n = len(s)
        assert abs(e - e_ref) / n < 1e-4, (e, e_ref)
        np.testing.assert_allclose(got['inferred_force'], f_ref, atol=2e-4)
        np.testing.assert_allclose(got['inferred_stress'], st_ref,
                                   atol=2e-5)
        assert abs(float(got['atomic_energy'].sum()) - e) < 1e-3


# --- parallel export ---------------------------------------------------------

def _edge_vec(s, g):
    from sevennet_finetuning_tpu_torch import keys as K

    idx = np.asarray(g[K.EDGE_IDX])
    return (np.asarray(s.pos)[idx[1]] - np.asarray(s.pos)[idx[0]]
            + np.asarray(g[K.CELL_SHIFT]) @ np.asarray(s.cell))


def _forces_from_dEdr(dE_dr, idx, n):
    f = np.zeros((n, 3))
    np.add.at(f, idx[0], dE_dr)       # dst
    np.add.at(f, idx[1], -dE_dr)      # src
    return f


def _chain_one_domain(segs, types, idx, ev_np, n):
    """The segment chain and the C++ manual backward for one domain
    without ghosts (pair_e3gnn_parallel.cpp:207-541); (energy, forces)."""
    ev = torch.tensor(ev_np, dtype=torch.float32, requires_grad=True)
    inp = {'x': torch.tensor(types, dtype=torch.long),
           'x_ghost': torch.zeros((0,), dtype=torch.long),
           'edge_index': torch.tensor(idx, dtype=torch.long),
           'edge_vec': ev, 'num_atoms': torch.tensor([n]),
           'nlocal': torch.tensor([n])}
    wrt = [[ev]]
    out = segs[0](inp)
    for seg in segs[1:]:
        e_v = out['edge_vec'].clone()
        xg = torch.zeros((0, out['x'].shape[1]), requires_grad=True)
        out = dict(out, edge_vec=e_v, x_ghost=xg)
        wrt.append([e_v, out['x'], out['self_cont_tmp'], xg])
        out = seg(out)
    energy = out['inferred_total_energy'].squeeze()
    dE_dr = torch.zeros_like(ev)
    gx = gtmp = of = None
    for i in range(len(wrt) - 1, -1, -1):
        if i == len(wrt) - 1:
            grads = torch.autograd.grad([energy], wrt[i], allow_unused=True)
        else:
            grads = torch.autograd.grad(of, wrt[i], [gx, gtmp],
                                        allow_unused=True)
        if grads[0] is not None:
            dE_dr = dE_dr + grads[0]
        if i == 0:
            break
        of = [wrt[i][1], wrt[i][2]]
        gx, gtmp = grads[1], grads[2]
    return float(energy), _forces_from_dEdr(dE_dr.detach().numpy(), idx, n)


def _chain_two_domains(segs, types_g, idx_g, ev_g, n):
    """Two domains with ghost atoms: forward_comm of the post-si1
    features before each segment, the manual backward with reverse_comm
    of the ghost cotangents (the JAX test's harness); (energy, forces)."""
    L = len(segs)
    doms = [np.arange(n // 2), np.arange(n // 2, n)]
    dom_of = np.zeros(n, int)
    dom_of[doms[1]] = 1
    D = []
    for d, locals_ in enumerate(doms):
        l2i = {a: i for i, a in enumerate(locals_)}
        ghosts, g2i = [], {}
        e_src, e_dst, e_vec = [], [], []
        for e in range(idx_g.shape[1]):
            dst, src = idx_g[0, e], idx_g[1, e]
            if dom_of[dst] != d:
                continue
            if dom_of[src] == d:
                si = l2i[src]
            else:
                if src not in g2i:
                    g2i[src] = len(locals_) + len(ghosts)
                    ghosts.append(src)
                si = g2i[src]
            e_src.append(si)
            e_dst.append(l2i[dst])
            e_vec.append(ev_g[e])
        D.append(dict(locals_=locals_, ghosts=np.array(ghosts, int),
                      idx=np.stack([np.array(e_dst), np.array(e_src)]),
                      ev=np.array(e_vec, np.float32)))
    outs, wrts = [], []
    for d in D:
        ev = torch.tensor(d['ev'], requires_grad=True)
        inp = {'x': torch.tensor(types_g[d['locals_']], dtype=torch.long),
               'x_ghost': torch.tensor(types_g[d['ghosts']]
                                       if len(d['ghosts']) else
                                       np.zeros(0, int), dtype=torch.long),
               'edge_index': torch.tensor(d['idx'], dtype=torch.long),
               'edge_vec': ev,
               'num_atoms': torch.tensor([len(d['locals_'])]),
               'nlocal': torch.tensor([len(d['locals_'])])}
        wrts.append([[ev]])
        outs.append(segs[0](inp))

    def owner_row(a):
        od = dom_of[a]
        return od, int(np.where(D[od]['locals_'] == a)[0][0])

    for si in range(1, L):
        xs = [o['x'].detach().numpy() for o in outs]
        for d, dd in enumerate(D):
            gh = np.zeros((len(dd['ghosts']), xs[d].shape[1]), np.float32)
            for r, a in enumerate(dd['ghosts']):
                od, oi = owner_row(a)
                gh[r] = xs[od][oi]
            o = dict(outs[d])
            ev = o['edge_vec'].clone()
            xg = torch.tensor(gh).requires_grad_(True)
            o['edge_vec'], o['x_ghost'] = ev, xg
            wrts[d].append([ev, o['x'], o['self_cont_tmp'], xg])
            outs[d] = segs[si](o)
    energy = sum(float(o['inferred_total_energy'].squeeze()) for o in outs)
    dE_dr = [torch.zeros(len(d['ev']), 3) for d in D]
    gx, gtmp = [None, None], [None, None]
    for si in range(L - 1, -1, -1):
        gxg = [None, None]
        for d in range(2):
            if si == L - 1:
                grads = torch.autograd.grad(
                    [outs[d]['inferred_total_energy'].squeeze()],
                    wrts[d][si], allow_unused=True)
            else:
                of = [wrts[d][si + 1][1], wrts[d][si + 1][2]]
                grads = torch.autograd.grad(of, wrts[d][si],
                                            [gx[d], gtmp[d]],
                                            allow_unused=True)
            if grads[0] is not None:
                dE_dr[d] = dE_dr[d] + grads[0]
            if si > 0:
                gx[d], gtmp[d], gxg[d] = grads[1].clone(), grads[2], grads[3]
        if si > 0:
            for d, dd in enumerate(D):
                if gxg[d] is None:
                    continue
                for r, a in enumerate(dd['ghosts']):
                    od, oi = owner_row(a)
                    gx[od][oi] += gxg[d][r]
    f = np.zeros((n, 3))
    for d, dd in enumerate(D):
        fl = _forces_from_dEdr(dE_dr[d].numpy(), dd['idx'],
                               len(dd['locals_']) + len(dd['ghosts']))
        f[dd['locals_']] += fl[:len(dd['locals_'])]
        f[dd['ghosts'].astype(int)] += fl[len(dd['locals_']):]
    return energy, f


@pytest.fixture(scope='module')
def exported_parallel(tmp_path_factory):
    """(params, port segment paths, JAX segment paths) of the narrow
    linear model."""
    from sevennet_finetuning_tpu.compat.torchscript_export_parallel import (
        export_parallel as j_export)
    from sevennet_finetuning_tpu_torch.compat.torchscript_export_parallel \
        import export_parallel

    tmp = tmp_path_factory.mktemp('parallel')
    cfg = _export_config('linear')
    spec, j_spec = _specs(cfg)
    params = _params(cfg)
    with warnings.catch_warnings():
        warnings.simplefilter('ignore')
        port = export_parallel(spec, params, str(tmp / 'port'))
        jax_paths = j_export(j_spec, params, str(tmp / 'jax'))
    return params, port, jax_paths


@pytest.mark.parametrize('domains', [1, 2])
def test_export_parallel_matches_jax(exported_parallel, domains):
    """The chain (one domain, or two with the halo exchange) against
    JAX's chain (energy 1e-6 rel, forces 1e-5 of max) and JAX's
    apply_model (1e-4 eV/atom, 2e-4 eV/A, the JAX test's limits)."""
    from sevennet_finetuning_tpu_torch import keys as K
    from sevennet_finetuning_tpu_torch.compat.torchscript_export_parallel \
        import comm_size_of

    cfg = _export_config('linear')
    params, port, jax_paths = exported_parallel
    assert [Path(p).name for p in port] == [Path(p).name for p in jax_paths]
    assert len(port) == cfg[K.NUM_CONVOLUTION]
    keys = META_KEYS + ('comm_size',)
    segs = [_load_artifact(p, keys)[0] for p in port]
    j_segs = [_load_artifact(p, keys)[0] for p in jax_paths]
    meta, j_meta = _load_artifact(port[0], keys)[1], _load_artifact(
        jax_paths[0], keys)[1]
    assert int(meta['comm_size']) == comm_size_of(_specs(cfg)[0]) == int(
        j_meta['comm_size'])
    tm = cfg[K.TYPE_MAP]
    chain = _chain_one_domain if domains == 1 else _chain_two_domains
    for i, s in enumerate(_structures()):
        e_ref, f_ref, _, g = _jax_reference_of('linear', i)
        idx = np.asarray(g[K.EDGE_IDX])
        types = np.array([tm[z] for z in s.atomic_numbers])
        n = len(s)
        e, f = chain(segs, types, idx, _edge_vec(s, g), n)
        j_e, j_f = chain(j_segs, types, idx, _edge_vec(s, g), n)
        assert abs(e - j_e) <= 1e-6 * abs(j_e)
        assert _rel(f, j_f) <= 1e-5
        assert abs(e - e_ref) / n < 1e-4, (e, e_ref)
        np.testing.assert_allclose(f, f_ref, atol=2e-4)


# --- import, function by function --------------------------------------------

@pytest.mark.parametrize('sc', SC_TYPES)
def test_expected_sequence_matches_jax(sc):
    from sevennet_finetuning_tpu.compat import torchscript_import as J
    from sevennet_finetuning_tpu_torch.compat import torchscript_import as P

    spec, j_spec = _specs(_export_config(sc))
    assert P._expected_sequence(spec) == J._expected_sequence(j_spec)
    # and the FCTP family's sequence at lmax 2 (the l x 0 scalarisation)
    spec, j_spec = _specs(_small_config())
    assert P._expected_sequence(spec) == J._expected_sequence(j_spec)


@pytest.mark.parametrize('sc', SC_TYPES)
def test_frozen_graph_readers_match_jax(exported, sc):
    """``_extract_weight_ops`` (arrays, traced offsets, multipliers) and
    ``_config_from_frozen`` on the JAX-exported artifact."""
    from sevennet_finetuning_tpu.compat import torchscript_import as J
    from sevennet_finetuning_tpu_torch.compat import torchscript_import as P

    model, meta = _load_artifact(exported[sc][2])
    got = P._extract_weight_ops(model.graph)
    want = J._extract_weight_ops(model.graph)
    assert len(got) == len(want) > 10
    for (a, off, muls), (b, j_off, j_muls) in zip(got, want):
        assert a.dtype == b.dtype and np.array_equal(a, b)
        assert off == j_off and muls == j_muls
    code, consts = model.code_with_constants
    cfg = P._config_from_frozen(code, consts.const_mapping, meta)
    assert cfg == J._config_from_frozen(code, consts.const_mapping, meta)
    assert cfg['cutoff'] == 4.5 and cfg['channel'] == 8


def test_import_deployed_serial_raises_like_jax(exported):
    """The exporter writes dense matrices, the importer reads the raw
    weights e3nn leaves in a frozen graph: JAX's importer rejects JAX's
    own artifact with ``matched k/n``, and the port's entry points
    (``import_deployed_serial``, ``Calculator.from_deployed_torchscript``
    and ``load_checkpoint``'s TorchScript route) raise the same error."""
    from sevennet_finetuning_tpu.compat import torchscript_import as J
    from sevennet_finetuning_tpu.train import checkpoint as jck
    from sevennet_finetuning_tpu_torch.calculator import Calculator
    from sevennet_finetuning_tpu_torch.compat import torchscript_import as P
    from sevennet_finetuning_tpu_torch.train import checkpoint as ck

    path = exported['nequip'][2]

    def error(call):
        with pytest.raises(RuntimeError, match='weight import incomplete'
                           ) as info:
            with warnings.catch_warnings():
                warnings.simplefilter('ignore')
                call()
        return str(info.value)

    want = error(lambda: J.import_deployed_serial(path))
    assert 'matched 2/' in want
    assert error(lambda: P.import_deployed_serial(path)) == want
    assert error(lambda: Calculator.from_deployed_torchscript(
        path, device='cpu')) == want
    # load_checkpoint's route guesses the architecture from the species
    # count (known_models: EXAMPLE_MD_MODEL here), as JAX's does
    assert error(lambda: ck.load_checkpoint(path)) == error(
        lambda: jck.load_checkpoint(path))


# --- the CLI -----------------------------------------------------------------

@pytest.mark.parametrize('parallel', [False, True])
def test_get_model_torchscript_matches_jax_cli(tmp_path, parallel):
    """``main get_model <ckpt> --torchscript [-p]`` against the JAX CLI's
    ``cmd_get_model``: the same file names, and artifacts that give the
    same energy (1e-6 rel) and forces (1e-5 of max)."""
    from sevennet_finetuning_tpu import main as jmain
    from sevennet_finetuning_tpu_torch import keys as K
    from sevennet_finetuning_tpu_torch.main import main as cli
    from sevennet_finetuning_tpu_torch.train.checkpoint import (
        save_checkpoint)

    cfg = _export_config('nequip')
    params = _params(cfg)
    ckpt = tmp_path / 'checkpoint_best.pth'
    save_checkpoint(str(ckpt), params, cfg, epoch=2)
    flags = ['-ts'] + (['-p'] if parallel else [])
    with warnings.catch_warnings():
        warnings.simplefilter('ignore')
        cli(['get_model', str(ckpt), '-o', str(tmp_path / 'port.sevenn')]
            + flags)
        jmain.cmd_get_model(argparse.Namespace(
            checkpoint=str(ckpt), output=str(tmp_path / 'jax.sevenn'),
            torchscript=True, parallel=parallel))
    s = _structures()[0]
    tm = cfg[K.TYPE_MAP]
    g = _jax_reference_of('nequip', 0)[3]
    if parallel:
        names = sorted(p.name for p in (tmp_path / 'port_parallel').iterdir())
        assert names == sorted(p.name for p in
                               (tmp_path / 'jax_parallel').iterdir())
        assert len(names) == cfg[K.NUM_CONVOLUTION]
        results = []
        for tag in ('port', 'jax'):
            segs = [torch.jit.load(str(tmp_path / f'{tag}_parallel' / n))
                    for n in names]
            results.append(_chain_one_domain(
                segs, np.array([tm[z] for z in s.atomic_numbers]),
                np.asarray(g[K.EDGE_IDX]), _edge_vec(s, g), len(s)))
        (e, f), (j_e, j_f) = results
    else:
        got = _run_serial(torch.jit.load(str(tmp_path / 'port.pt')), tm, s, g)
        want = _run_serial(torch.jit.load(str(tmp_path / 'jax.pt')), tm, s,
                           g)
        e, j_e = float(got['inferred_total_energy']), float(
            want['inferred_total_energy'])
        f, j_f = got['inferred_force'], want['inferred_force']
    assert abs(e - j_e) <= 1e-6 * abs(j_e)
    assert _rel(f, j_f) <= 1e-5


# --- the ASE adapter ---------------------------------------------------------

def test_ase_calculator_with_stub(monkeypatch):
    """``SevenNetASECalculator`` through a stub
    ``ase.calculators.calculator``: energy, energies and forces as the
    port's Calculator gives them, stress in ASE's Voigt order (xx yy zz
    yz xz xy) with its sign."""
    from sevennet_finetuning_tpu_torch.calculator import (
        Calculator, SevenNetASECalculator)

    class AseBase:
        def __init__(self, **kwargs):
            self.kwargs = kwargs
            self.results = {}

        def calculate(self, atoms=None, properties=('energy',),
                      system_changes=None):
            self.atoms = atoms

    mod = types.ModuleType('ase.calculators.calculator')
    mod.Calculator = AseBase
    for name, m in (('ase', types.ModuleType('ase')),
                    ('ase.calculators', types.ModuleType('ase.calculators')),
                    ('ase.calculators.calculator', mod)):
        monkeypatch.setitem(sys.modules, name, m)

    s = _structures()[0]

    class DuckAtoms:
        def get_chemical_symbols(self):
            return list(s.species)

        def get_positions(self):
            return np.asarray(s.pos)

        def get_cell(self):
            return np.asarray(s.cell)

        def get_pbc(self):
            return np.array(s.pbc)

    cfg = _export_config('nequip')
    inner = Calculator(_specs(cfg)[0], _params(cfg), device='cpu')
    ase_calc = SevenNetASECalculator(inner, label='x')
    assert ase_calc.kwargs == {'label': 'x'}
    assert set(ase_calc.implemented_properties) >= {'energy', 'forces',
                                                    'stress', 'energies'}
    ase_calc.calculate(DuckAtoms(), ('energy', 'forces', 'stress'))
    res = ase_calc.results
    want = inner.calculate(s)
    assert res['energy'] == res['free_energy'] == want['energy']
    assert np.array_equal(res['energies'], want['energies'])
    assert np.array_equal(res['forces'], want['forces'])
    st = want['stress']
    assert np.array_equal(res['stress'],
                          -np.array([st[0], st[1], st[2], st[4], st[5],
                                     st[3]]))
