"""Halo-parallel MD of the port against its serial loops, and the halo
path in two gloo processes against one process, on the CPU.

The narrow models and structures of ``tests/test_torch_halo.py`` (the
JAX tests' ``tests/test_halo_md.py`` / ``tests/test_md_device.py``),
native neighbor lists, the JAX tests' limits:

- the host halo loop (``halo=dict(n_dev=2)``) against the serial host
  loop (positions 1e-5 A, E_pot 1e-3 rel); ``run_device_halo`` against
  the serial ``run_device`` and the host halo loop, 10 steps in segments
  of 4 with a plan rebuild each segment (positions 1e-4 rel + 2e-5 A,
  velocities 1e-3 + 1e-5, E_pot 1e-5 + 2e-5, E_kin 1e-4 + 2e-5);
- two gloo ranks (spawned once for the module): the forward, the host
  halo loop and ``run_device_halo`` through ``DistTransport`` against
  the one-process transport (energies 1e-6 relative, forces 1e-5 of max,
  positions 1e-6 A: the same rows in another summation order), and no
  rank imports jax.
"""

import pickle

import numpy as np
import pytest
import torch

from sevennet_finetuning_tpu_torch import keys as K
from tests.test_torch_halo import (  # noqa: F401
    HF_O, SI_O, _arrays, _both, _cfg, _native_neighbor_list, _port_halo)
from tests.test_torch_parallel import spawn_ranks, wait_ranks

torch.set_num_threads(2)


# --- molecular dynamics ------------------------------------------------------

def _calc(cfg):
    from sevennet_finetuning_tpu_torch.calculator import Calculator
    from sevennet_finetuning_tpu_torch.model.build import build_model_spec
    from sevennet_finetuning_tpu_torch.model.nequip import init_params

    spec = build_model_spec(cfg)
    return Calculator(spec, init_params(spec, 0), device='cpu')


def _md_calc():
    return _calc(_cfg(SI_O, 3.0, **{K.NUM_CONVOLUTION: 2}))


def test_md_serial_vs_halo_host_loop():
    from sevennet_finetuning_tpu_torch.md import VelocityVerlet

    calc = _md_calc()
    s, _ = _both(_arrays(24, 0, 8.0), (2, 1, 1))
    md1 = VelocityVerlet(s, calc, dt_fs=0.5)
    md1.set_temperature(50.0, seed=5)
    r1 = md1.run(3)
    md2 = VelocityVerlet(s, calc, dt_fs=0.5, halo=dict(n_dev=2))
    md2.set_temperature(50.0, seed=5)
    r2 = md2.run(3)
    np.testing.assert_allclose(md1.s.pos, md2.s.pos, atol=1e-5)
    for a, b in zip(r1.energies, r2.energies):
        assert abs(a - b) < 1e-3 * max(1.0, abs(a))


def _md_pair(calc):
    from sevennet_finetuning_tpu_torch.md import VelocityVerlet

    s, _ = _both(_arrays(24, 0, 9.0))
    ref = VelocityVerlet(s, calculator=calc, dt_fs=0.5)
    ref.set_temperature(300.0, seed=4)
    dev = VelocityVerlet(s, calculator=calc, dt_fs=0.5, halo=dict(n_dev=2))
    dev.set_temperature(300.0, seed=4)
    return ref, dev


def _close_md(dev, ref, n_steps):
    assert len(dev.result.energies) == n_steps
    np.testing.assert_allclose(dev.s.pos, ref.s.pos, rtol=1e-4, atol=2e-5)
    np.testing.assert_allclose(dev.vel, ref.vel, rtol=1e-3, atol=1e-5)
    np.testing.assert_allclose(dev.result.energies,
                               ref.result.energies[:n_steps],
                               rtol=1e-5, atol=2e-5)
    np.testing.assert_allclose(dev.result.kinetic,
                               ref.result.kinetic[:n_steps],
                               rtol=1e-4, atol=2e-5)


def test_run_device_halo_matches_serial_and_host_halo():
    calc = _md_calc()
    ref, dev = _md_pair(calc)
    ref.run_device(10, seg_steps=4)
    dev.run_device_halo(10, seg_steps=4)
    assert dev.result.segments == ref.result.segments == [4, 4, 2]
    _close_md(dev, ref, 10)
    _, host = _md_pair(calc)
    host.run(10)
    _close_md(dev, host, 10)


def test_halo_md_needs_a_calculator():
    from sevennet_finetuning_tpu_torch.data.vasp import Structure
    from sevennet_finetuning_tpu_torch.md import VelocityVerlet

    s = Structure(**_arrays(12, 3, 8.0))
    with pytest.raises(ValueError, match='Calculator'):
        VelocityVerlet(s, halo={'n_dev': 2})
    md = VelocityVerlet(s)
    with pytest.raises(ValueError, match='halo'):
        md.run_device_halo(2)
    with pytest.raises(ValueError, match='Calculator'):
        md.run_device(2)


# --- two gloo ranks ----------------------------------------------------------

WORKER = r'''
import os, pickle, sys
import numpy as np
import torch
torch.set_num_threads(1)
from sevennet_finetuning_tpu_torch import keys as K
from sevennet_finetuning_tpu_torch.calculator import Calculator
from sevennet_finetuning_tpu_torch.data.vasp import Structure
from sevennet_finetuning_tpu_torch.md import VelocityVerlet
from sevennet_finetuning_tpu_torch.model.build import build_model_spec
from sevennet_finetuning_tpu_torch.model.nequip import init_params
from sevennet_finetuning_tpu_torch.parallel import data_parallel as dp
from sevennet_finetuning_tpu_torch.parallel.halo import (
    DistTransport, build_halo_plan, make_halo_forward, scatter_positions)

work = sys.argv[1]
assert dp.maybe_init_distributed('cpu', timeout_s=120)
rank = dp.process_rank()
with open(os.path.join(work, 'inputs.pkl'), 'rb') as f:
    inp = pickle.load(f)
spec = build_model_spec(inp['config'])
calc = Calculator(spec, init_params(spec, 0), device='cpu')
s = Structure(**inp['structure'])
out = {}
plan = build_halo_plan(s, spec.cutoff, dict(spec.type_map), 2)
fwd = make_halo_forward(calc.model, plan)
assert isinstance(fwd.transport, DistTransport) and fwd.ranks == [rank]
pos = scatter_positions(plan, s.pos.astype(np.float32))[[rank]]
e, f, st = fwd(torch.as_tensor(pos))
out['forward'] = (float(e), f.numpy(), st.numpy())
out['untimed_seconds'] = fwd.transport.seconds
md = VelocityVerlet(s, calc, dt_fs=0.5, halo=dict(n_dev=2))
md.set_temperature(300.0, seed=4)
md.run(3)
out['host'] = (md.s.pos.copy(), list(md.result.energies))
md = VelocityVerlet(s, calc, dt_fs=0.5, halo=dict(n_dev=2))
md.set_temperature(300.0, seed=4)
DistTransport.timed = True
md.run_device_halo(10, seg_steps=4)
out['device'] = (md.s.pos.copy(), md.vel.copy(), list(md.result.energies),
                 list(md.result.kinetic), list(md.result.segments))
out['timed_seconds'] = md.result.transport_seconds
out['bad'] = sorted(m for m in sys.modules
                    if m.split('.')[0] in ('jax', 'jaxlib', 'optax',
                                           'sevennet_finetuning_tpu'))
with open(os.path.join(work, f'rank{rank}.pkl'), 'wb') as f:
    pickle.dump(out, f)
torch.distributed.destroy_process_group()
print('RANK', rank, 'HALO_OK')
'''


@pytest.fixture(scope='module')
def halo_ranks(tmp_path_factory):
    """Two gloo ranks over the JAX multi-process test's 40-atom Hf/O cell
    (``tests/test_multihost_halo.py``), and the same runs through the
    one-process transport."""
    from sevennet_finetuning_tpu_torch.data.vasp import Structure
    from sevennet_finetuning_tpu_torch.md import VelocityVerlet
    from sevennet_finetuning_tpu_torch.parallel.halo import build_halo_plan

    work = tmp_path_factory.mktemp('halo')
    rng = np.random.default_rng(11)
    arrays = dict(species=['Hf' if i % 3 == 0 else 'O' for i in range(40)],
                  pos=rng.uniform(0, 13.0, (40, 3)), cell=np.eye(3) * 13.0)
    cfg = _cfg(HF_O, 3.0, **{K.NUM_CONVOLUTION: 2, K.IS_PARITY: False,
                             K.SELF_CONNECTION_TYPE: 'linear',
                             K.CONV_DENOMINATOR: 10.0, K.SHIFT: 0.0,
                             K.SCALE: 1.0})
    with open(work / 'inputs.pkl', 'wb') as f:
        pickle.dump(dict(config=cfg, structure=arrays), f)
    script = work / 'worker.py'
    script.write_text(WORKER)
    procs = spawn_ranks(script, [work], 2)
    try:
        calc = _calc(cfg)
        s = Structure(**arrays)
        plan = build_halo_plan(s, 3.0, HF_O, 2)
        local = {'forward': _port_halo(calc.model, plan, s), 'plan': plan}
        md = VelocityVerlet(s, calc, dt_fs=0.5, halo=dict(n_dev=2))
        md.set_temperature(300.0, seed=4)
        md.run(3)
        local['host'] = (md.s.pos.copy(), list(md.result.energies))
        md = VelocityVerlet(s, calc, dt_fs=0.5, halo=dict(n_dev=2))
        md.set_temperature(300.0, seed=4)
        md.run_device_halo(10, seg_steps=4)
        local['device'] = md
    finally:
        outs = wait_ranks(procs)
    ranks = []
    for r in range(2):
        with open(work / f'rank{r}.pkl', 'rb') as f:
            ranks.append(pickle.load(f))
    return dict(local=local, ranks=ranks, outs=outs)


def test_dist_forward_matches_one_process(halo_ranks):
    from sevennet_finetuning_tpu_torch.parallel.halo import gather_forces

    e_w, f_w, st_w = halo_ranks['local']['forward']
    plan = halo_ranks['local']['plan']
    forces = np.concatenate([r['forward'][1] for r in halo_ranks['ranks']])
    for r in halo_ranks['ranks']:
        e, _, st = r['forward']
        assert abs(e - e_w) <= 1e-6 * abs(e_w)
        np.testing.assert_allclose(st, st_w, atol=1e-9)
    f = gather_forces(plan, forces)
    assert np.abs(f - f_w).max() <= 1e-5 * np.abs(f_w).max()


def test_dist_md_matches_one_process(halo_ranks):
    pos_w, e_w = halo_ranks['local']['host']
    dev = halo_ranks['local']['device']
    for r in halo_ranks['ranks']:
        pos, e = r['host']
        np.testing.assert_allclose(pos, pos_w, atol=1e-6)
        np.testing.assert_allclose(e, e_w, rtol=1e-6)
        pos, vel, ed, ked, segs = r['device']
        assert segs == dev.result.segments
        np.testing.assert_allclose(pos, dev.s.pos, atol=1e-6)
        np.testing.assert_allclose(vel, dev.vel, atol=1e-6)
        np.testing.assert_allclose(ed, dev.result.energies, rtol=1e-6)
        np.testing.assert_allclose(ked, dev.result.kinetic, rtol=1e-5)
        # the swaps are timed only while DistTransport.timed is set
        assert r['untimed_seconds'] == 0.0 and r['timed_seconds'] > 0.0


def test_halo_ranks_import_no_jax(halo_ranks):
    for r, out in zip(halo_ranks['ranks'], halo_ranks['outs']):
        assert r['bad'] == []
        assert 'HALO_OK' in out
