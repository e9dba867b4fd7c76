"""Data-parallel training over ``torch.distributed``.

Port of ``sevennet_finetuning_tpu/parallel/data_parallel.py`` (the
reference's DDP path, reference: sevenn/main/sevenn.py:39-50,
sevenn/train/trainer.py:17-28).  JAX shards a stacked batch over a device
mesh and lets XLA insert the all-reduces; here each process owns one card
and one shard of every global batch (``Loader(n_shards=world,
shard_offset=rank)``), and the Trainer's data-parallel mode (the
counterpart of JAX ``make_dp_train_step`` / ``make_dp_eval_step``) calls
the helpers below:

- ``broadcast_parameters`` / ``broadcast_optimizer_state``: rank 0's
  parameters and optimizer state at the start (JAX's are replicated);
- ``average_gradients``: after ``total.backward()``, one ``all_reduce``
  (SUM) of the flattened gradients of the trainable leaves, then ``/
  world`` -- JAX's ``jnp.mean`` of the per-shard losses.  An explicit
  all-reduce and not ``DistributedDataParallel``: its bucket hooks would
  sit inside the double backward (``create_graph=True``) of the force
  pass, and JAX's semantics are a plain mean over shards;
- ``sum_accumulators``: the metric accumulators summed over ranks once
  per epoch (the reference's ``dist.all_reduce`` of sums and counts,
  reference: sevenn/error_recorder.py:70-77), so every rank finalizes the
  same metrics and ``ReduceLROnPlateau`` takes the same step everywhere.

The process group: ``maybe_init_distributed`` reads the environment that
``torchrun`` sets (RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR,
MASTER_PORT); NCCL for cards, gloo for the CPU, or the backend the caller
names (gloo lets several ranks share one card).  gloo's collectives take
host tensors here: a card tensor is copied to the host, reduced there and
copied back; NCCL takes a host tensor (adam's step count) through a copy
on the card (``_collective_``).
"""

from __future__ import annotations

import datetime
import os
from typing import Dict, Iterable, List, Optional

import torch
import torch.distributed as dist

# a stuck rank fails a collective after this long instead of hanging
DEFAULT_TIMEOUT_S = 300
_ENV = ('RANK', 'WORLD_SIZE', 'MASTER_ADDR', 'MASTER_PORT')


def maybe_init_distributed(device='cuda', backend: Optional[str] = None,
                           timeout_s: float = DEFAULT_TIMEOUT_S) -> bool:
    """Join the process group that ``torchrun`` describes in the
    environment (JAX ``maybe_init_distributed``).  Returns False, and does
    nothing, without that environment; True when the group exists.

    ``backend``: NCCL for a ``cuda`` device, gloo otherwise, unless named.
    A failing NCCL raises: the backend is never switched silently.  A
    ``cuda`` rank works on ``cuda:LOCAL_RANK`` (``rank_device``)."""
    if dist.is_initialized():
        return True
    if not all(k in os.environ for k in _ENV):
        return False
    device = torch.device(device)
    if backend is None:
        backend = 'nccl' if device.type == 'cuda' else 'gloo'
    if device.type == 'cuda':
        torch.cuda.set_device(rank_device(device))
    dist.init_process_group(
        backend, init_method='env://',
        rank=int(os.environ['RANK']),
        world_size=int(os.environ['WORLD_SIZE']),
        timeout=datetime.timedelta(seconds=timeout_s))
    return True


def is_distributed() -> bool:
    return dist.is_available() and dist.is_initialized()


def process_rank() -> int:
    """This process's rank; 0 without a process group."""
    return dist.get_rank() if is_distributed() else 0


def world_size() -> int:
    return dist.get_world_size() if is_distributed() else 1


def rank_device(device) -> torch.device:
    """``cuda`` -> ``cuda:LOCAL_RANK`` (0 without torchrun); other devices
    pass through."""
    device = torch.device(device)
    if device.type == 'cuda' and device.index is None:
        return torch.device('cuda', int(os.environ.get('LOCAL_RANK', 0)))
    return device


def _comm_device(t: torch.Tensor) -> torch.device:
    """Where the backend takes ``t``: the host under gloo, the rank's
    card under NCCL."""
    if dist.get_backend() == 'gloo':
        return torch.device('cpu')
    return t.device if t.is_cuda else torch.device(
        'cuda', torch.cuda.current_device())


def _collective_(t: torch.Tensor, fn) -> torch.Tensor:
    """``fn`` (an in-place collective) on ``t``, through a copy on the
    backend's device where ``t`` lies elsewhere."""
    where = _comm_device(t)
    if t.device == where:
        fn(t)
        return t
    staged = t.to(where)
    fn(staged)
    t.copy_(staged)
    return t


def all_reduce_(t: torch.Tensor, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """In-place all-reduce of ``t`` (through the host under gloo)."""
    return _collective_(t, lambda x: dist.all_reduce(x, op=op))


def broadcast_(t: torch.Tensor, src: int = 0) -> torch.Tensor:
    """In-place broadcast of rank ``src``'s ``t``."""
    return _collective_(t, lambda x: dist.broadcast(x, src))


def all_gather(t: torch.Tensor) -> List[torch.Tensor]:
    """Every rank's ``t`` (equal shapes), on the backend's device."""
    t = t.detach().to(_comm_device(t))
    out = [torch.empty_like(t) for _ in range(world_size())]
    dist.all_gather(out, t)
    return out


def _flat_reduce_(tensors: List[torch.Tensor], op=dist.ReduceOp.SUM):
    """One all-reduce over the concatenation of ``tensors``, written
    back in place."""
    if not tensors:
        return
    flat = torch.cat([t.reshape(-1) for t in tensors])
    all_reduce_(flat, op)
    offset = 0
    for t in tensors:
        n = t.numel()
        t.copy_(flat[offset:offset + n].view_as(t))
        offset += n


@torch.no_grad()
def broadcast_parameters(params: Iterable[torch.Tensor], src: int = 0):
    """Rank ``src``'s values into every rank's ``params``."""
    for p in params:
        broadcast_(p.data, src)


@torch.no_grad()
def broadcast_optimizer_state(optimizer: torch.optim.Optimizer,
                              src: int = 0):
    """Rank ``src``'s optimizer state (every tensor of it) into every
    rank's; ranks must hold the same state structure."""
    for state in optimizer.state.values():
        for v in state.values():
            if isinstance(v, torch.Tensor):
                broadcast_(v, src)


@torch.no_grad()
def average_gradients(params: Iterable[torch.Tensor]):
    """Replace each ``p.grad`` by its mean over ranks: one flattened
    all-reduce (SUM), then ``/ world``."""
    grads = [p.grad for p in params if p.grad is not None]
    _flat_reduce_(grads)
    w = float(world_size())
    for g in grads:
        g.div_(w)


@torch.no_grad()
def sum_accumulators(*accs: Dict[str, torch.Tensor]):
    """Sum metric accumulator dicts (0-d tensors) over ranks in place,
    with one all-reduce for all of them."""
    _flat_reduce_([a[k] for a in accs for k in sorted(a)])
