"""Trainer: train / eval steps, Fisher estimation, rehearsal.

Port of ``sevennet_finetuning_tpu/train/trainer.py`` for one device
(reference: sevenn/train/trainer.py:15-222).  A train step runs the model
with its force pass kept in the graph (``apply_model_train``), so the
loss on forces and stress backpropagates to the parameters through a
double backward of the convolution -- the CUDA kernels ``cg_gagg`` and
``cg_gmulti`` under ``CGNodeMulti.backward``.  Then adam updates the
trainable leaves and the metric accumulators grow on the device.

JAX's ``lax.scan`` epochs become a Python loop over steps; a
``cache=True`` loader's batches are put on the device once and replayed
in the loader's per-epoch order.  Metrics reach the host once per epoch.
"""

from __future__ import annotations

from typing import Dict, Iterable, Optional, Tuple

import numpy as np
import torch

from .. import keys as K
from .. import resolve_device
from ..model.nequip import (
    NequIP,
    apply_model,
    apply_model_train,
    batch_to_torch,
    detach_outputs,
    load_jax_params,
    trainable_mask,
)
from .loss import build_loss_fn, loss_specs_from_config
from .metrics import (
    fetch_accumulators,
    finalize,
    init_accumulators,
    metric_specs_from_config,
    update_accumulators,
)
from .optim import build_optimizer, optax_state_dict, set_lr

Tree = Dict[str, Dict[str, torch.Tensor]]


def _tree_to(tree, device) -> Optional[Tree]:
    if tree is None:
        return None
    return {g: {n: torch.as_tensor(np.asarray(v, np.float32), device=device)
                for n, v in names.items()} for g, names in tree.items()}


def _tree_to_numpy(tree: Tree) -> Dict[str, Dict[str, np.ndarray]]:
    return {g: {n: v.detach().cpu().numpy() for n, v in names.items()}
            for g, names in tree.items()}


class Trainer:
    """Owns the model's parameters and the optimizer state.

    ``model``: a ``NequIP`` (moved to ``device``: cuda unless
    ``device='cpu'``); ``fisher`` / ``opt_params``: the EWC Fisher
    estimate and anchor parameters as nested dicts of numpy arrays with
    the parameter names (``load_pytree`` of the reference artifacts)."""

    def __init__(self, model: NequIP, config: Dict, fisher=None,
                 opt_params=None, device=None):
        self.device = resolve_device(device)
        self.model = model.to(self.device)
        self.model.requires_grad_(True)
        self.spec = model.spec
        self.config = config
        self.params: Tree = {g: dict(p.items())
                             for g, p in self.model.params.items()}

        self.loss_specs = loss_specs_from_config(config)
        self.metric_specs = metric_specs_from_config(config)
        self.loss_fn = build_loss_fn(
            self.loss_specs,
            use_data_weights=config.get(K.LOAD_DATASET_WITH_WEIGHTS, False),
            fisher=_tree_to(fisher, self.device),
            opt_params=_tree_to(opt_params, self.device))
        self.optimizer, self.lr_controller = build_optimizer(
            config, self.params, trainable_mask(self.spec))
        # device copies of cache=True loaders' batches, per loader
        self._dev_cache: Dict[int, list] = {}

    # -- steps ------------------------------------------------------------
    def _clear_grads(self):
        for p in self.model.parameters():
            p.grad = None

    def train_step(self, batch: Dict[str, torch.Tensor], acc: Dict
                   ) -> Tuple[Dict, Dict[str, torch.Tensor]]:
        """One optimizer step on a device batch.  Returns the updated
        accumulators and the step's loss terms ('Total' and one per
        LossSpec) as detached device scalars."""
        self._clear_grads()
        out = apply_model_train(self.model, batch)
        total, terms = self.loss_fn(self.params, out)
        total.backward()
        self.optimizer.step()
        with torch.no_grad():
            out = detach_outputs(out)
            terms = {k: v.detach() for k, v in terms.items()}
            acc = update_accumulators(self.metric_specs, acc, out, terms,
                                      total.detach())
        terms['Total'] = total.detach()
        return acc, terms

    def eval_step(self, batch: Dict[str, torch.Tensor], acc: Dict
                  ) -> Tuple[Dict, Dict[str, torch.Tensor]]:
        out = apply_model(self.model, batch)
        with torch.no_grad():
            total, terms = self.loss_fn(self.params, out)
            acc = update_accumulators(self.metric_specs, acc, out, terms,
                                      total)
        return acc, out

    # -- batch placement --------------------------------------------------
    def place_batch(self, batch: Dict) -> Dict[str, torch.Tensor]:
        return batch_to_torch(batch, self.device)

    def _epoch_batches(self, loader) -> Iterable[Dict[str, torch.Tensor]]:
        """Device batches for one epoch: a cache=True loader's batches go
        to the device once and are replayed in its per-epoch order."""
        if getattr(loader, 'cache', False):
            key = id(loader)
            if key not in self._dev_cache:
                self._dev_cache[key] = [self.place_batch(b)
                                        for b in loader.materialize()]
            dev = self._dev_cache[key]
            return (dev[i] for i in loader.epoch_order())
        return (self.place_batch(b) for b in loader)

    def _step(self, batch, acc, is_train):
        if is_train:
            return self.train_step(batch, acc)[0]
        return self.eval_step(batch, acc)[0]

    def _finalize(self, *accs):
        return tuple(finalize(self.metric_specs, a)
                     for a in fetch_accumulators(*accs))

    # -- epochs -----------------------------------------------------------
    def run_one_epoch(self, loader, is_train: bool = False,
                      fetch: bool = True) -> Optional[Dict[str, float]]:
        """One pass over ``loader``; ``fetch=False`` skips the host copy
        of the metrics and returns None."""
        acc = init_accumulators(self.metric_specs, self.device)
        for batch in self._epoch_batches(loader):
            acc = self._step(batch, acc, is_train)
        if not fetch:
            return None
        return self._finalize(acc)[0]

    def run_one_epoch_rehearsal(self, loader, memloader,
                                is_train: bool = True, fetch: bool = True):
        """Interleaved replay: after every train-batch step, one step on
        the next memory batch of a cycling iterator (reference:
        sevenn/train/trainer.py:157-222).  Returns (train metrics, memory
        metrics)."""
        acc = init_accumulators(self.metric_specs, self.device)
        mem_acc = init_accumulators(self.metric_specs, self.device)
        mem_iter = iter(self._epoch_batches(memloader))
        for batch in self._epoch_batches(loader):
            acc = self._step(batch, acc, is_train)
            try:
                mem_batch = next(mem_iter)
            except StopIteration:
                mem_iter = iter(self._epoch_batches(memloader))
                mem_batch = next(mem_iter)
            mem_acc = self._step(mem_batch, mem_acc, is_train)
        if not fetch:
            return None, None
        return self._finalize(acc, mem_acc)

    def compute_fisher_matrix(self, loader, loss_thr: float = -1.0):
        """Empirical Fisher: mean over samples of squared loss gradients,
        skipping samples whose loss exceeds the threshold (reference:
        sevenn/train/trainer.py:126-152).  Use batch size 1.  Returns
        (fisher, opt_params, count) with numpy leaves."""
        fisher = {g: {n: torch.zeros_like(p) for n, p in names.items()}
                  for g, names in self.params.items()}
        count = torch.zeros((), device=self.device)
        for batch in loader:
            self._clear_grads()
            out = apply_model_train(self.model, self.place_batch(batch))
            total, _ = self.loss_fn(self.params, out)
            total.backward()
            with torch.no_grad():
                take = (torch.ones((), device=self.device) if loss_thr < 0
                        else (total < loss_thr).to(torch.float32))
                for g, names in self.params.items():
                    for n, p in names.items():
                        fisher[g][n] += take * p.grad * p.grad
                count += take
        self._clear_grads()
        count_f = float(count)
        if count_f > 0:
            fisher = {g: {n: f / count_f for n, f in names.items()}
                      for g, names in fisher.items()}
        return (_tree_to_numpy(fisher), _tree_to_numpy(self.params),
                int(count_f))

    # -- scheduler / checkpoint ------------------------------------------
    def scheduler_step(self, metric: Optional[float] = None):
        self.lr_controller.step(metric)
        set_lr(self.optimizer, self.lr_controller.lr)

    def get_lr(self) -> float:
        return self.lr_controller.lr

    def synchronize(self):
        """Wait for the queued device work (JAX's block_until_ready)."""
        if self.device.type == 'cuda':
            torch.cuda.synchronize(self.device)

    def get_checkpoint_dict(self) -> Dict:
        return {
            'model_state_dict': _tree_to_numpy(self.params),
            'optimizer_state_dict': self.optimizer.state_dict(),
            'scheduler_state_dict': self.lr_controller.state_dict(),
        }

    def load_optimizer_state(self, state):
        """``state``: a state dict of this port's optimizer, or the optax
        state of a JAX checkpoint (``load_checkpoint`` keeps it as a tree
        of ``OptaxState``), translated by ``optim.optax_state_dict``.
        Raises ``ValueError`` where it does not fit this optimizer."""
        if not (isinstance(state, dict) and 'param_groups' in state):
            state = optax_state_dict(self.optimizer, self.params, state)
        self.optimizer.load_state_dict(state)

    def load_state_dicts(self, model_state, optimizer_state=None,
                         scheduler_state=None):
        """``model_state``: a parameter dict of numpy arrays (the port's
        own checkpoint or the JAX package's); ``optimizer_state``: what
        ``load_optimizer_state`` takes."""
        load_jax_params(self.model, model_state)
        if optimizer_state is not None:
            self.load_optimizer_state(optimizer_state)
        if scheduler_state is not None:
            self.lr_controller.load_state_dict(scheduler_state)
            set_lr(self.optimizer, self.lr_controller.lr)
