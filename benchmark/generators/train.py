"""Traffic kind ``train``: the reEWC rehearsal loop, closed.

Parameters (the traffic file): ``train_file`` / ``memory_file`` (extxyz
under the checkout), ``train_mix`` / ``memory_mix`` ({atoms: count}: the
first structures of each size, the same for every seed; the seed orders
them and shuffles the loaders),
``batch``, ``recipe`` (loss delta, force / stress weights, EWC lambda,
adam's lr, betas, eps), ``fisher`` / ``anchor`` (the EWC files).

Set-up builds one ``Trainer`` (the program's, from the configuration's
weights, under ``train.recipe.reewc_recipe_config``), device-cached
batch-``batch`` loaders (``cache=True``, shuffled per epoch from the
seed), and runs one rehearsal epoch through
``Trainer.run_one_epoch_rehearsal``: the first three steps that the
reference follows, and every shape the window uses.  The window repeats
that call until ``--seconds`` have passed.

``correct``: the reference takes the same first three steps from the same
weights and batches (it packs the batches and orders the epoch by the
loader's rules from its own edge counts) and compares each step's loss,
each leaf's first gradient (the program's from adam's first moment after
step 1) and each leaf's change after three steps (the program's from a
copy taken after step 3), each leaf by the gap of its norm against the
reference's norm of that leaf or of the median leaf, whichever is larger.
"""

from __future__ import annotations

import gc
import math
from typing import Dict, List

import numpy as np
import torch

from benchmark import inputs, program
from benchmark.count.bounds import Census
from benchmark.count.flops import TRAIN_PASSES, FlopCounter
from benchmark.judge import judge
from benchmark.reference import checkpoint as ref_checkpoint
from benchmark.reference import graph as ref_graph
from benchmark.reference.model import Reference
from benchmark.reference.train import ReferenceTrainer, batch_labels

FOLLOWED_STEPS = 3


def draw(structures: List[Dict], mix: Dict[str, int],
         rng: np.random.Generator) -> List[Dict]:
    """The first ``mix[atoms]`` structures of each size in the file (the
    same work for every seed), in the seed's order."""
    out = []
    for atoms, count in sorted(mix.items(), key=lambda kv: int(kv[0])):
        out += [s for s in structures
                if len(s['numbers']) == int(atoms)][:int(count)]
    return [out[i] for i in rng.permutation(len(out))]


def packed_batches(edges: List[int], batch: int) -> List[List[int]]:
    """The loader's size-balanced packing (first-fit decreasing by edge
    count into the open batch with the smallest total)."""
    edges = np.asarray(edges)
    n_b = math.ceil(len(edges) / batch)
    slots = np.zeros(n_b, np.int64)
    totals = np.zeros(n_b, np.int64)
    members: List[List[int]] = [[] for _ in range(n_b)]
    for i in np.argsort(-edges):
        open_b = np.flatnonzero(slots < batch)
        j = open_b[np.argmin(totals[open_b])]
        members[j].append(int(i))
        slots[j] += 1
        totals[j] += edges[i]
    return members


def first_order(n_batches: int, seed: int) -> np.ndarray:
    """The first epoch's batch order of a shuffled loader seeded so."""
    order = np.arange(n_batches)
    np.random.default_rng(seed).shuffle(order)
    return order


class Generator:
    def __init__(self, ctx):
        self.ctx = ctx
        self.t = ctx.traffic
        self.device = ctx.device
        self.census = None

    # -- set-up -------------------------------------------------------------
    def setup(self):
        from sevennet_finetuning_tpu_torch.data.dataset import (GraphDataset,
                                                                Loader)
        from sevennet_finetuning_tpu_torch.model.build import build_model_spec
        from sevennet_finetuning_tpu_torch.model.nequip import (
            NequIP, load_jax_params)
        from sevennet_finetuning_tpu_torch.train.checkpoint import load_pytree
        from sevennet_finetuning_tpu_torch.train.recipe import (
            reewc_recipe_config)
        from sevennet_finetuning_tpu_torch.train.trainer import Trainer

        import time

        ctx, t = self.ctx, self.t
        root = ctx.root
        t0 = time.perf_counter()
        if self.device.type == 'cuda':
            program.build_kernels(program.TRAIN_SOURCES)
        t1 = time.perf_counter()
        rng = np.random.default_rng(ctx.seed)
        self.train_s = draw(inputs.read_extxyz(root / t['train_file']),
                            t['train_mix'], rng)
        self.mem_s = draw(inputs.read_extxyz(root / t['memory_file']),
                          t['memory_mix'], rng)
        self.loader_seeds = (int(rng.integers(2 ** 62)),
                             int(rng.integers(2 ** 62)))
        self.cfg, self.params = program.weights(ctx.config, root, ctx.seed,
                                                self.device)
        rec = t['recipe']
        model = load_jax_params(NequIP(build_model_spec(self.cfg)),
                                self.params)
        fisher, anchor = (str(root / t['fisher']), str(root / t['anchor']))
        config = reewc_recipe_config(self.cfg, fisher, anchor, lr=rec['lr'])
        self.trainer = Trainer(model, config, fisher=load_pytree(fisher),
                               opt_params=load_pytree(anchor),
                               device=self.device)
        cutoff = float(self.cfg['cutoff'])
        tm = self.cfg['_type_map']
        self.loaders = [
            Loader(GraphDataset.from_structures(
                [inputs.to_program(s) for s in structs], cutoff, tm),
                t['batch'], shuffle=True, seed=seed, cache=True)
            for structs, seed in ((self.train_s, self.loader_seeds[0]),
                                  (self.mem_s, self.loader_seeds[1]))]
        t2 = time.perf_counter()
        self.flops = FlopCounter(self.cfg)
        self.steps = 0
        self.structures = 0
        self.flop_sum = 0
        self.snap = {}
        self._work = {}
        self._wrap_train_step()
        # the first epoch: the followed steps, and every shape
        self.trainer.run_one_epoch_rehearsal(*self.loaders, fetch=False)
        ctx.log(f'[bench] set-up: kernels {t1 - t0:.3f} s, inputs, weights, '
                f'trainer and graphs {t2 - t1:.3f} s, first epoch '
                f'{time.perf_counter() - t2:.3f} s')

    def _wrap_train_step(self):
        tr = self.trainer
        inner = tr.train_step
        spans = self.ctx.spans

        def train_step(batch, acc):
            key = id(batch)
            if key not in self._work:
                # a new device batch (the first epoch caches them): its
                # real structures, atoms and edges, read once
                from sevennet_finetuning_tpu_torch import keys as K
                graphs = int((batch[K.NUM_ATOMS] > 0).sum())
                atoms = int(batch[K.NODE_MASK].sum())
                edges = int(batch[K.EDGE_MASK].sum())
                self._work[key] = (graphs, self.flops.forward(edges, atoms))
            with spans('train_step'):
                out = inner(batch, acc)
            graphs, fwd = self._work[key]
            self.steps += 1
            self.structures += graphs
            self.flop_sum += TRAIN_PASSES * fwd
            if self.steps <= FOLLOWED_STEPS:
                self._snapshot(out[1]['Total'])
            return out

        tr.train_step = train_step

    def _snapshot(self, total):
        tr = self.trainer
        self.snap.setdefault('loss', []).append(total.detach().clone())
        names = {id(p): (g, n) for g, leaves in tr.params.items()
                 for n, p in leaves.items()}
        if self.steps == 1:
            b1 = tr.optimizer.param_groups[0]['betas'][0]
            self.snap['grad'] = {
                names[id(p)]: (tr.optimizer.state[p]['exp_avg'] / (1 - b1)
                               ).detach().clone()
                for grp in tr.optimizer.param_groups for p in grp['params']}
        if self.steps == FOLLOWED_STEPS:
            self.snap['params'] = {names[id(p)]: p.detach().clone()
                                   for grp in tr.optimizer.param_groups
                                   for p in grp['params']}

    # -- the window ---------------------------------------------------------
    def window(self, seconds: float, tracer=None) -> Dict:
        import time

        steps0, structs0, flops0 = self.steps, self.structures, self.flop_sum
        t_end = time.perf_counter() + seconds
        epochs = 0
        trace_steps = 0
        while True:
            if tracer is not None and epochs == 0:
                self.census = Census()
                self.census.install()
                tracer.start()
            self.trainer.run_one_epoch_rehearsal(*self.loaders, fetch=False)
            epochs += 1
            if tracer is not None and epochs == 1:
                tracer.stop()
                self.census.remove()
                trace_steps = self.steps - steps0
                flops_at_stop = self.flop_sum
            if time.perf_counter() >= t_end:
                break
        if self.device.type == 'cuda':
            torch.cuda.synchronize(self.device)
        stats = {'attempted': self.steps - steps0, 'failed': 0,
                 'units': self.steps - steps0, 'trace_units': trace_steps,
                 'structures': self.structures - structs0,
                 'flops': self.flop_sum - flops0, 'epochs': epochs}
        if tracer is not None and epochs > 1:
            # the work after the traced slice, which the profiler slows
            stats['flops_untraced'] = self.flop_sum - flops_at_stop
            stats['seconds_untraced'] = time.perf_counter() - tracer.t_stopped
        return stats

    def end_to_end(self, rec) -> Dict[str, float]:
        return {'train_structures_per_s':
                rec['stats']['structures'] / rec['window_s']}

    def memory_peak(self) -> int:
        return torch.cuda.max_memory_allocated(self.device)

    def kernel_bounds(self):
        return self.census.bound_seconds() if self.census else None

    def release(self):
        self.snap = {k: ({kk: vv.cpu() for kk, vv in v.items()}
                         if isinstance(v, dict) else [float(x) for x in v])
                     for k, v in self.snap.items()}
        self.trainer = self.loaders = None
        self._work = {}
        gc.collect()
        if self.device.type == 'cuda':
            torch.cuda.empty_cache()

    # -- the reference ------------------------------------------------------
    def _followed_batches(self):
        """The structures of the first three steps, in the program's
        order: train batch 0, memory batch 0, train batch 1 of the first
        epoch's orders."""
        cutoff = float(self.cfg['cutoff'])
        out = []
        for structs, seed in ((self.train_s, self.loader_seeds[0]),
                              (self.mem_s, self.loader_seeds[1])):
            edges = ref_graph.edge_counts(structs, cutoff, self.device)
            members = packed_batches(edges, self.t['batch'])
            order = first_order(len(members), seed)
            out.append([[structs[i] for i in members[j]] for j in order])
        tr, mem = out
        return [tr[0], mem[0], tr[1]][:FOLLOWED_STEPS]

    def _reference_steps(self, tf32: bool):
        t = self.t
        rec = t['recipe']
        root = self.ctx.root
        prev = (torch.backends.cuda.matmul.allow_tf32,
                torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = tf32
        torch.backends.cudnn.allow_tf32 = tf32
        try:
            ref = Reference(self.cfg, self.params, self.device)
            trainer = ReferenceTrainer(
                ref, {'delta': rec['delta'],
                      'force_weight': rec['force_weight'],
                      'stress_weight': rec['stress_weight'],
                      'ewc_lambda': rec['ewc_lambda'], 'lr': rec['lr'],
                      'betas': tuple(rec['betas']), 'eps': rec['eps']},
                ref_checkpoint.load(str(root / t['fisher'])),
                ref_checkpoint.load(str(root / t['anchor'])))
            start = {(g, n): v.detach().clone() for g, n, v in ref.leaves()}
            losses, grads = [], None
            tm = self.cfg['_type_map']
            for i, structs in enumerate(self._followed_batches()):
                g = ref_graph.batch_graphs(structs, ref.spec.cutoff, tm,
                                           self.device)
                loss, gr = trainer.step(g, batch_labels(structs,
                                                        self.device))
                losses.append(loss)
                if i == 0:
                    grads = {k: v.cpu() for k, v in gr.items()}
            change = {(g, n): (v.detach() - start[(g, n)]).cpu()
                      for g, n, v in ref.leaves()}
            return losses, grads, change
        finally:
            torch.backends.cuda.matmul.allow_tf32 = prev[0]
            torch.backends.cudnn.allow_tf32 = prev[1]

    def _readings(self, losses, grads, change, ref) -> Dict[str, float]:
        """The numbers: the first step's loss gap and the worst step's;
        the worst leaf's and the median leaf's first-gradient gap; the
        worst leaf's and the median leaf's change gap (leaves whose
        reference gradient is under a thousandth of the median leaf's
        left out of the change).  A leaf's gap is the gap of its norms
        over the reference's norm of that leaf or of the median leaf,
        whichever is larger.  The limits hold the first step's loss, the
        worst leaf's gradient and the median leaf's change: the later
        steps amplify rounding (adam's first update moves elements whose
        gradient is rounding by about lr), so the worst step's loss and
        the worst leaf's change swing from run to run of one seed."""
        r_losses, r_grads, r_change = ref
        loss_gap = max(abs(a - b) / abs(b) for a, b in zip(losses, r_losses))

        def norms(d):
            return {k: float(torch.linalg.vector_norm(v.double()))
                    for k, v in d.items()}

        def gaps(p, r, keys):
            med = float(np.median([r[k] for k in keys]))
            return {k: abs(p[k] - r[k]) / max(r[k], med) for k in keys}

        g_r, g_p = norms(r_grads), norms(grads)
        g_gap = gaps(g_p, g_r, list(g_r))
        med_g = float(np.median(list(g_r.values())))
        moved = [k for k in g_r if g_r[k] >= 1e-3 * med_g]
        c_gap = gaps(norms(change), norms(r_change), moved)
        for name, gap in (('grad', g_gap), ('change', c_gap)):
            top = sorted(gap, key=gap.get, reverse=True)[:3]
            self.ctx.log(f'[bench] worst {name} leaves: ' + ', '.join(
                f'{g}/{n} {gap[(g, n)]:.3e}' for g, n in top))
        return {'loss_gap_first': abs(losses[0] - r_losses[0])
                / abs(r_losses[0]),
                'loss_gap': loss_gap,
                'grad_gap': max(g_gap.values()),
                'grad_gap_median': float(np.median(list(g_gap.values()))),
                'change_gap': max(c_gap.values()),
                'change_gap_median': float(np.median(list(c_gap.values())))}

    def check(self):
        losses = self.snap['loss']
        grads = self.snap['grad']
        start = {(g, n): torch.as_tensor(np.asarray(v, np.float32))
                 for g, names in self.params.items() for n, v in names.items()}
        change = {k: v - start[k] for k, v in self.snap['params'].items()}
        ref = self._reference_steps(tf32=False)
        readings = self._readings(losses, grads, change, ref)
        return judge(self.ctx, readings)

    def control(self):
        fp32 = self._reference_steps(tf32=False)
        low = self._reference_steps(tf32=True)
        return self._readings(*low, fp32)

