"""Spatially decomposed inference with a per-layer halo exchange (the
forces of ``md``'s halo loops).

Port of ``sevennet_finetuning_tpu/parallel/halo.py``, the counterpart of
the reference's parallel MD execution model (reference:
sevenn/pair_e3gnn/pair_e3gnn_parallel.cpp:207-541 and the patched MPI
CommBrick, comm_brick.cpp:1057-1120): the atoms of a periodic cell are
split into an N-D brick grid of D ranks; each rank owns its atoms'
features, and the ghost (boundary) rows are refreshed from their owners
before every convolution.

- The host plan (``build_halo_plan``, ``HaloPlan``, ``StagePlan``,
  ``choose_dims``, ``scatter_positions``, ``gather_forces``) is the JAX
  package's numpy code, kept verbatim over this package's neighbor list:
  the same structure, cutoff and rank count give the same arrays.  The
  last two also take any trailing width, and the first a fill value
  and the ranks held.
- The exchange follows the LAMMPS brick schedule: one staged swap per
  decomposed axis (x, then y including the x ghosts, then z), each a
  +axis and a -axis swap of packed rows, appended to the buffer as
  ``[from_minus | from_plus]``.  JAX gets the reverse halo pass as the
  adjoint of ``lax.ppermute``; ``torch.distributed`` P2P is not
  differentiable, so ``_Swap`` is an autograd Function whose backward is
  the reverse swap (stage by stage from the last, through autograd's own
  order) and the owners add the returned cotangents into their packed
  rows through ``gather_rows``' backward, the sorted segment sum -- no
  ``index_add_``.  Each backward calls only Functions, so
  ``create_graph`` works through the exchange.
- Two transports move the packed rows, and only they differ:
  ``LocalTransport`` holds every partition in one process on one device
  (the counterpart of JAX's ``shard_map`` on a virtual mesh, how every
  JAX halo test runs), ``DistTransport`` one partition per process of a
  ``torch.distributed`` group (``batch_isend_irecv``; gloo's P2P takes
  host tensors, so under gloo the packed rows are staged through the
  host; with ``DistTransport.timed`` its ``seconds`` count the swaps).
- A process holding ranks R runs the model once over their partitions
  side by side: node rows ``k * n_local + i`` for the k-th held rank, its
  exchange buffer rows ``k * buffer_rows + slot``, each edge partition
  the concatenation of the held ranks' real edges, padded at the end.
  Each node's edges keep their order, so every node's sums are the ones
  a rank computes alone.
- ``HaloForward`` (JAX ``make_halo_forward``): forces are ``-dE/dpos``
  through the exchange's backward; stress comes from a strain ``eps``
  applied to both partitions' edge vectors, its gradient summed over
  processes with the energy (JAX's ``deps`` is the global sum).
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from .. import tracing
from ..data.neighborlist import neighbor_list
from ..data.vasp import Structure
from ..ops.scatter import gather_rows, inverse_perm
from . import data_parallel as dp


@dataclass
class StagePlan:
    """One brick-swap stage (one decomposed axis): a +axis and a -axis
    swap with static pack index maps into the buffer accumulated from
    the previous stages."""

    axis: int
    cap: int
    perm_plus: Tuple[Tuple[int, int], ...]   # rank -> +axis neighbor
    perm_minus: Tuple[Tuple[int, int], ...]
    send_plus: np.ndarray                     # [D, cap] buffer rows
    send_plus_mask: np.ndarray                # [D, cap]
    send_minus: np.ndarray
    send_minus_mask: np.ndarray


@dataclass
class HaloPlan:
    """Static decomposition: per-rank padded arrays (leading axis D)."""

    dims: Tuple[int, int, int]
    n_dev: int
    n_local: int              # padded local-atom capacity per device
    n_edge: int               # padded edge capacity per device
    stages: List[StagePlan]
    atom_type: np.ndarray     # [D, n_local] i32
    node_mask: np.ndarray     # [D, n_local] f32
    owner_perm: np.ndarray    # [D, n_local] global atom id (-1 pad)
    edge_idx: np.ndarray      # [D, 2, n_edge]: dst local (sorted); src
    edge_shift: np.ndarray    # [D, n_edge, 3]        in exchange buffer
    edge_mask: np.ndarray     # [D, n_edge]
    edge_src_perm: np.ndarray  # [D, n_edge]: argsort of src per device
    # comm/compute-overlap partition: edges whose SOURCE is local vs in
    # the ghost blocks.  Local-source messages depend only on this
    # device's features; ghost-source messages consume the exchange.
    # Each set is dst-sorted with sentinel padding + its own src-sort
    # permutation (kernel contract).
    edge_loc: Dict[str, np.ndarray] = None   # idx [D,2,El], shift, mask, perm
    edge_gh: Dict[str, np.ndarray] = None
    cell: np.ndarray = None   # [3, 3]
    volume: float = 0.0
    n_atoms: int = 0

    @property
    def buffer_rows(self) -> int:
        return self.n_local + 2 * sum(st.cap for st in self.stages)


def _axis_heights(cell: np.ndarray) -> np.ndarray:
    """Perpendicular height of the cell along each lattice axis."""
    h = np.zeros(3)
    for a in range(3):
        n = np.cross(cell[(a + 1) % 3], cell[(a + 2) % 3])
        h[a] = abs(np.linalg.det(cell)) / np.linalg.norm(n)
    return h


def choose_dims(cell: np.ndarray, cutoff: float, n_dev: int
                ) -> Tuple[int, int, int]:
    """Factor n_dev into a brick grid maximizing the min slab width.
    Axes split >2 ways must keep width >= cutoff (face-neighbor routing,
    same constraint the reference aborts on, comm_brick.cpp:1071);
    2-way splits always route (every brick is every other brick's
    neighbor modulo 2)."""
    h = _axis_heights(np.asarray(cell, float))
    best = None
    for px in range(1, n_dev + 1):
        if n_dev % px:
            continue
        for py in range(1, n_dev // px + 1):
            if (n_dev // px) % py:
                continue
            pz = n_dev // px // py
            dims = (px, py, pz)
            widths = h / np.array(dims)
            if any(p > 2 and w < cutoff for p, w in zip(dims, widths)):
                continue
            key = (min(widths), -sum(p > 1 for p in dims))
            if best is None or key > best[0]:
                best = (key, dims)
    if best is None:
        raise ValueError(
            f'no brick decomposition of {n_dev} devices fits cell '
            f'heights {np.round(h, 2)} with cutoff {cutoff} '
            f'(face-neighbor halo only)'
        )
    return best[1]


def _wrap_delta(c_from: int, c_to: int, p: int) -> int:
    """Periodic hop direction from c_from to c_to on a ring of size p:
    0 (same), +1, or -1; raises if further than one hop."""
    dv = (c_to - c_from) % p
    if dv == 0:
        return 0
    if dv == 1:
        return 1
    if dv == p - 1:
        return -1
    raise ValueError(
        'edge crosses non-adjacent bricks; decrease device count or '
        'choose different dims'
    )


def build_halo_plan(
    s: Structure,
    cutoff: float,
    type_map: Dict[int, int],
    n_dev: int,
    dims: Optional[Tuple[int, int, int]] = None,
    pad_quantum: int = 8,
    cap_hints: Optional[Dict[str, object]] = None,
) -> HaloPlan:
    """Partition one periodic structure into an N-D brick grid.

    ``dims`` (px, py, pz) with px*py*pz == n_dev overrides the automatic
    factorization.  Rank layout: ((cx * py) + cy) * pz + cz.

    ``cap_hints`` (keys ``n_local``, ``n_edge``, ``loc``, ``gh``,
    ``stage`` [list per stage]) sets capacity FLOORS: an MD loop
    passes its running maxima so rebuilds along a trajectory keep the
    padded shapes stable (the single-device loop's capacity growth,
    md.run_device; the reference's counterpart is the adaptive
    nedges_bound growth, pair_e3gnn.cpp:104-110)."""
    hints = cap_hints or {}
    pos = np.asarray(s.pos, float)
    cell = np.asarray(s.cell, float)
    n = len(pos)
    if dims is None:
        dims = choose_dims(cell, cutoff, n_dev)
    px, py, pz = dims
    assert px * py * pz == n_dev, (dims, n_dev)

    h = _axis_heights(cell)
    for p, w, name in zip(dims, h / np.array(dims), 'xyz'):
        if p > 2 and w < cutoff:
            raise ValueError(
                f'brick width {w:.2f} A along {name} < cutoff {cutoff}: '
                f'too many devices for this cell (face-neighbor halo '
                f'only)'
            )

    def flat(cx, cy, cz):
        return (cx * py + cy) * pz + cz

    frac = (pos @ np.linalg.inv(cell)) % 1.0
    coords = np.stack([
        np.minimum((frac[:, a] * p).astype(int), p - 1)
        for a, p in enumerate(dims)
    ], axis=1)
    dom = np.array([flat(*c) for c in coords])
    rank_coords = [(cx, cy, cz) for cx in range(px) for cy in range(py)
                   for cz in range(pz)]

    idx_i, idx_j, shift, _ = neighbor_list(pos, cell, s.pbc, cutoff)
    z = s.atomic_numbers
    types = np.array([type_map[int(v)] for v in z], np.int32)

    locals_of = [np.where(dom == d)[0] for d in range(n_dev)]
    g2l = {}
    for d, ids in enumerate(locals_of):
        for li, gi in enumerate(ids):
            g2l[int(gi)] = (d, li)

    def qpad(x):
        return max(pad_quantum, int(np.ceil(x / pad_quantum)) * pad_quantum)

    n_local = qpad(max((len(ids) for ids in locals_of), default=1))
    n_local = max(n_local, int(hints.get('n_local', 0)))
    active = [a for a in range(3) if dims[a] > 1]

    # ---- staged routing: which atom arrives where, at which stage ------
    # recv[(rank, stage_pos, side)] = set of global atom ids; side 0 =
    # from -axis neighbor (data travelled +axis), side 1 = from +axis
    recv: Dict[Tuple[int, int, int], set] = {}
    # last hop of each (dst rank, atom): determines its buffer block
    last_hop: Dict[Tuple[int, int], Tuple[int, int]] = {}
    for a, b in zip(idx_i, idx_j):
        d, _ = g2l[int(a)]
        o, _ = g2l[int(b)]
        if o == d:
            continue
        cd, co = rank_coords[d], rank_coords[o]
        cur = list(co)
        lh = None
        for sp_i, ax in enumerate(active):
            delta = _wrap_delta(co[ax], cd[ax], dims[ax])
            if delta == 0:
                continue
            cur[ax] = cd[ax]
            r_to = flat(*cur)
            side = 0 if delta == 1 else 1
            recv.setdefault((r_to, sp_i, side), set()).add(int(b))
            lh = (sp_i, side)
        assert lh is not None
        last_hop[(d, int(b))] = lh

    caps = []
    stage_hints = hints.get('stage', [])
    for sp_i in range(len(active)):
        worst = max(
            (len(v) for (r, st, sd), v in recv.items() if st == sp_i),
            default=0,
        )
        cap = qpad(max(1, worst))
        if sp_i < len(stage_hints):
            cap = max(cap, int(stage_hints[sp_i]))
        caps.append(cap)

    # sorted receive blocks fix slot order; senders pack in that order
    recv_sorted = {
        k: sorted(v) for k, v in recv.items()
    }

    # buffer slot of each (rank, atom): locals first, then per-stage
    # [from_minus | from_plus] blocks
    present: List[Dict[int, int]] = [
        {int(gi): li for li, gi in enumerate(ids)}
        for ids in locals_of
    ]
    block_base = n_local
    stage_layout = []  # per stage: (base_minus, base_plus)
    for sp_i in range(len(active)):
        stage_layout.append((block_base, block_base + caps[sp_i]))
        block_base += 2 * caps[sp_i]
    for sp_i in range(len(active)):
        for r in range(n_dev):
            for side in (0, 1):
                base = stage_layout[sp_i][side]
                for k, gid in enumerate(
                    recv_sorted.get((r, sp_i, side), [])
                ):
                    # do not overwrite: an atom may arrive once and be
                    # referenced from its first landing block
                    present[r].setdefault(gid, base + k)

    stages: List[StagePlan] = []
    for sp_i, ax in enumerate(active):
        cap = caps[sp_i]
        perm_plus = []
        perm_minus = []
        send_plus = np.zeros((n_dev, cap), np.int32)
        send_plus_mask = np.zeros((n_dev, cap), np.float32)
        send_minus = np.zeros((n_dev, cap), np.int32)
        send_minus_mask = np.zeros((n_dev, cap), np.float32)
        for r in range(n_dev):
            c = list(rank_coords[r])
            cp = list(c)
            cp[ax] = (c[ax] + 1) % dims[ax]
            cm = list(c)
            cm[ax] = (c[ax] - 1) % dims[ax]
            rp, rm = flat(*cp), flat(*cm)
            perm_plus.append((r, rp))
            perm_minus.append((r, rm))
            # what the +axis neighbor expects in its from_minus block
            for k, gid in enumerate(recv_sorted.get((rp, sp_i, 0), [])):
                slot = present[r].get(gid)
                assert slot is not None and slot < stage_layout[sp_i][0], (
                    'routing error: atom not present before its send '
                    'stage'
                )
                send_plus[r, k] = slot
                send_plus_mask[r, k] = 1.0
            for k, gid in enumerate(recv_sorted.get((rm, sp_i, 1), [])):
                slot = present[r].get(gid)
                assert slot is not None and slot < stage_layout[sp_i][0]
                send_minus[r, k] = slot
                send_minus_mask[r, k] = 1.0
        stages.append(StagePlan(
            axis=ax, cap=cap,
            perm_plus=tuple(perm_plus), perm_minus=tuple(perm_minus),
            send_plus=send_plus, send_plus_mask=send_plus_mask,
            send_minus=send_minus, send_minus_mask=send_minus_mask,
        ))

    # ---- per-device edge lists (dst-owner partitioning) ----------------
    # dst-SORTED with out-of-range sentinel padding, mirroring the
    # collate batch contract, so the halo aggregation rides the sorted
    # segment-sum kernel.  A per-device src-sort permutation routes the
    # source-gather's backward through the same kernel (buffer slots are
    # ascending under it).
    per_dev: List[list] = [[] for _ in range(n_dev)]
    for eidx, (a, b) in enumerate(zip(idx_i, idx_j)):
        d, la = g2l[int(a)]
        o, _ = g2l[int(b)]
        if o == d:
            slot = g2l[int(b)][1]
        else:
            slot = present[d][int(b)]
        per_dev[d].append((la, slot, shift[eidx]))

    n_edge = max(qpad(max((len(e) for e in per_dev), default=1)),
                 int(hints.get('n_edge', 0)))
    buffer_rows = block_base
    edge_idx = np.zeros((n_dev, 2, n_edge), np.int32)
    edge_idx[:, 0, :] = n_local      # dst pad: drop sentinel, ascending
    edge_idx[:, 1, :] = buffer_rows  # src pad: out-of-range sentinel
    edge_shift = np.zeros((n_dev, n_edge, 3), np.float32)
    edge_mask = np.zeros((n_dev, n_edge), np.float32)
    edge_src_perm = np.zeros((n_dev, n_edge), np.int32)
    for d, edges in enumerate(per_dev):
        edges.sort(key=lambda e: e[0])   # stable dst sort
        for k, (la, sb, sh) in enumerate(edges):
            edge_idx[d, :, k] = (la, sb)
            edge_shift[d, k] = sh
            edge_mask[d, k] = 1.0
        edge_src_perm[d] = np.argsort(edge_idx[d, 1], kind='stable')

    def build_set(selector, src_sentinel, hint_key):
        sets = [[e for e in per_dev[d] if selector(e[1])]
                for d in range(n_dev)]
        cap = max(qpad(max((len(es) for es in sets), default=1)),
                  int(hints.get(hint_key, 0)))
        idx = np.zeros((n_dev, 2, cap), np.int32)
        idx[:, 0, :] = n_local
        idx[:, 1, :] = src_sentinel
        shf = np.zeros((n_dev, cap, 3), np.float32)
        msk = np.zeros((n_dev, cap), np.float32)
        prm = np.zeros((n_dev, cap), np.int32)
        for d, es in enumerate(sets):
            es.sort(key=lambda e: e[0])
            for k, (la, sb, sh) in enumerate(es):
                idx[d, :, k] = (la, sb)
                shf[d, k] = sh
                msk[d, k] = 1.0
            prm[d] = np.argsort(idx[d, 1], kind='stable')
        return dict(idx=idx, shift=shf, mask=msk, perm=prm)

    edge_loc = build_set(lambda sb: sb < n_local, n_local, 'loc')
    edge_gh = build_set(lambda sb: sb >= n_local, buffer_rows, 'gh')

    atom_type = np.zeros((n_dev, n_local), np.int32)
    node_mask = np.zeros((n_dev, n_local), np.float32)
    owner_perm = np.full((n_dev, n_local), -1, np.int64)
    for d, ids in enumerate(locals_of):
        atom_type[d, :len(ids)] = types[ids]
        node_mask[d, :len(ids)] = 1.0
        owner_perm[d, :len(ids)] = ids

    return HaloPlan(
        dims=(px, py, pz), n_dev=n_dev, n_local=n_local, n_edge=n_edge,
        stages=stages,
        atom_type=atom_type, node_mask=node_mask, owner_perm=owner_perm,
        edge_idx=edge_idx, edge_shift=edge_shift, edge_mask=edge_mask,
        edge_src_perm=edge_src_perm,
        edge_loc=edge_loc, edge_gh=edge_gh,
        cell=cell.astype(np.float32), volume=float(s.volume), n_atoms=n,
    )


# ---------------------------------------------------------------------------
# transports and the exchange
# ---------------------------------------------------------------------------

class LocalTransport:
    """Every partition of the plan in this process, on one device."""

    def __init__(self, plan: HaloPlan, device=None):
        self.ranks = tuple(range(plan.n_dev))
        self.seconds = 0.0
        # per stage: the rank whose +axis (-axis) neighbor each rank is
        self._from = []
        for st in plan.stages:
            minus_of = np.zeros(plan.n_dev, np.int64)
            plus_of = np.zeros(plan.n_dev, np.int64)
            for r, rp in st.perm_plus:
                minus_of[rp] = r
            for r, rm in st.perm_minus:
                plus_of[rm] = r
            self._from.append((torch.as_tensor(minus_of, device=device),
                               torch.as_tensor(plus_of, device=device)))

    def swap(self, stage: int, up: torch.Tensor, down: torch.Tensor):
        """``up`` [R, cap, F] travels +axis, ``down`` -axis: returns
        (from_minus, from_plus) of every rank."""
        minus_of, plus_of = self._from[stage]
        return up[minus_of], down[plus_of]


class DistTransport:
    """One partition per process; the rank's neighbors from the plan.

    With ``timed`` set (off by default: it costs two card syncs a swap),
    ``seconds`` sums the swaps' wall time between a sync of the card
    before and after each: the staging copies, the transfer and the wait
    for the peer, without this rank's queued kernels."""

    timed = False

    def __init__(self, plan: HaloPlan, rank: int):
        self.ranks = (rank,)
        self.seconds = 0.0
        self._peers = [(dict(st.perm_plus)[rank], dict(st.perm_minus)[rank])
                       for st in plan.stages]

    def swap(self, stage: int, up: torch.Tensor, down: torch.Tensor):
        """Inside the span ``halo.swap`` (``stage``, ``rows``); the counter
        ``halo.swap_bytes`` adds the bytes this rank sends."""
        tracing.count('halo.swap_bytes', up.numel() * up.element_size()
                      + down.numel() * down.element_size())
        with tracing.span('halo.swap', stage=stage,
                          rows=up.shape[-2] + down.shape[-2]):
            return self._swap(stage, up, down)

    def _swap(self, stage: int, up: torch.Tensor, down: torch.Tensor):
        device = up.device
        sync = self.timed and device.type == 'cuda'
        if sync:
            torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        plus, minus = self._peers[stage]
        host = dist.get_backend() == 'gloo' and device.type != 'cpu'
        up, down = up.contiguous(), down.contiguous()
        if host:
            up, down = up.cpu(), down.cpu()
        from_minus = torch.empty_like(up)
        from_plus = torch.empty_like(down)
        # two swaps between the same pair of ranks (a 2-way axis) are
        # told apart by their tags
        ops = [dist.P2POp(dist.isend, up, plus, tag=2 * stage),
               dist.P2POp(dist.irecv, from_minus, minus, tag=2 * stage),
               dist.P2POp(dist.isend, down, minus, tag=2 * stage + 1),
               dist.P2POp(dist.irecv, from_plus, plus, tag=2 * stage + 1)]
        for work in dist.batch_isend_irecv(ops):
            work.wait()
        if host:
            from_minus = from_minus.to(device)
            from_plus = from_plus.to(device)
        if self.timed:
            if sync:
                torch.cuda.synchronize(device)
            self.seconds += time.perf_counter() - t0
        return from_minus, from_plus


def make_transport(plan: HaloPlan, device=None):
    """``DistTransport`` for this process's rank when a process group of
    the plan's rank count exists, else ``LocalTransport`` on ``device``."""
    if plan.n_dev > 1 and dp.is_distributed() \
            and dp.world_size() == plan.n_dev:
        return DistTransport(plan, dp.process_rank())
    return LocalTransport(plan, device)


class _Swap(torch.autograd.Function):
    """One stage's swap; the backward sends the cotangents of the
    received rows back to their owners (the reverse swap)."""

    @staticmethod
    def forward(ctx, transport, stage, up, down):
        ctx.transport, ctx.stage = transport, stage
        return transport.swap(stage, up, down)

    @staticmethod
    def backward(ctx, ct_from_minus, ct_from_plus):
        # rows that came from the -axis neighbor go back down the axis
        ct_down, ct_up = _Swap.apply(ctx.transport, ctx.stage,
                                     ct_from_plus, ct_from_minus)
        return None, None, ct_up, ct_down


def _sorted_gather(idx: np.ndarray, device):
    """(idx, perm, inv) tensors of a host index for ``gather_rows``."""
    idx = np.ascontiguousarray(idx, np.int32)
    perm = torch.as_tensor(np.argsort(idx, kind='stable').astype(np.int32),
                           device=device)
    return (torch.as_tensor(idx, device=device), perm, inverse_perm(perm))


class HaloExchange:
    """exchange(x) [R * n_local, ...] -> [R * buffer_rows, ...]: the held
    ranks' buffers, each ``[locals | per stage: from_minus | from_plus]``
    (JAX ``_make_exchange``)."""

    def __init__(self, plan: HaloPlan, transport, device):
        self.plan, self.transport = plan, transport
        ranks = list(transport.ranks)
        self._stages = []
        rows = plan.n_local
        for st in plan.stages:
            packs = []
            for idx, mask in ((st.send_plus, st.send_plus_mask),
                              (st.send_minus, st.send_minus_mask)):
                flat = idx[ranks] + rows * np.arange(len(ranks))[:, None]
                packs.append(_sorted_gather(flat.reshape(-1), device) + (
                    torch.as_tensor(mask[ranks], device=device)[..., None],))
            self._stages.append(packs)
            rows += 2 * st.cap

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        n_held = len(self.transport.ranks)
        tail = x.shape[1:]
        buf = x.reshape(n_held, self.plan.n_local, -1)
        for i, packs in enumerate(self._stages):
            flat = buf.reshape(-1, buf.shape[-1])
            up, down = (gather_rows(flat, idx, perm, inv).reshape(
                n_held, -1, buf.shape[-1]) * mask
                for idx, perm, inv, mask in packs)
            from_minus, from_plus = _Swap.apply(self.transport, i, up, down)
            buf = torch.cat([buf, from_minus, from_plus], dim=1)
        return buf.reshape((-1,) + tail)


# ---------------------------------------------------------------------------
# the forward
# ---------------------------------------------------------------------------

def _held_partition(part: Dict[str, np.ndarray], ranks, n_local: int,
                    src_rows: int, device) -> Dict[str, torch.Tensor]:
    """One edge partition of the held ranks: their real edges side by
    side (node rows offset by ``n_local``, sources by ``src_rows`` a
    rank), padded at the end with the sentinels (dst ``R * n_local``, src
    ``R * src_rows``); a single held rank gives the plan's own arrays."""
    cap = part['mask'].shape[1]
    dst, src, shift = [], [], []
    for k, r in enumerate(ranks):
        n = int(part['mask'][r].sum())
        dst.append(part['idx'][r, 0, :n] + k * n_local)
        src.append(part['idx'][r, 1, :n] + k * src_rows)
        shift.append(part['shift'][r, :n])
    n_real = sum(len(d) for d in dst)
    size = cap * len(ranks)
    idx = np.empty((2, size), np.int32)
    idx[0] = len(ranks) * n_local
    idx[1] = len(ranks) * src_rows
    idx[0, :n_real] = np.concatenate(dst)
    idx[1, :n_real] = np.concatenate(src)
    sh = np.zeros((size, 3), np.float32)
    sh[:n_real] = np.concatenate(shift)
    mask = np.zeros(size, np.float32)
    mask[:n_real] = 1.0
    src_t, perm, inv = _sorted_gather(idx[1], device)
    dst_t = torch.as_tensor(idx[0], device=device)
    ident = torch.arange(size, dtype=torch.int32, device=device)
    return dict(src=src_t, dst=dst_t, perm=perm, inv=inv, ident=ident,
                shift=torch.as_tensor(sh, device=device),
                mask=torch.as_tensor(mask, device=device))


class HaloForward:
    """The halo-parallel forward of ``model`` over ``plan`` for the ranks
    ``transport`` holds (JAX ``make_halo_forward``):
    ``forward(pos [R, n_local, 3])`` -> (total energy, forces
    [R, n_local, 3], stress Voigt [6]), every rank's result the same
    energy and stress.  Padded rows carry zero force."""

    def __init__(self, model, plan: HaloPlan):
        self.model, self.plan = model, plan
        self.device = dev = next(model.parameters()).device
        self.transport = make_transport(plan, dev)
        self.ranks = list(self.transport.ranks)
        self.n_node = len(self.ranks) * plan.n_local
        self.atom_type = torch.as_tensor(
            plan.atom_type[self.ranks].reshape(-1), device=dev)
        self.node_mask = torch.as_tensor(
            plan.node_mask[self.ranks].reshape(-1), device=dev)
        self.loc = _held_partition(plan.edge_loc, self.ranks, plan.n_local,
                                   plan.n_local, dev)
        self.gh = _held_partition(plan.edge_gh, self.ranks, plan.n_local,
                                  plan.buffer_rows, dev)
        self.exchange = HaloExchange(plan, self.transport, dev)
        self.cell = torch.as_tensor(plan.cell, device=dev)
        self.distributed = isinstance(self.transport, DistTransport)

    def _edge_vectors(self, pos_loc, pos_all, eps):
        """Both partitions' edge vectors under the strain ``eps`` (JAX
        ``_local_edge_vectors``); the gathers' backwards are sorted
        segment sums."""
        out = []
        for part, table in ((self.loc, pos_loc), (self.gh, pos_all)):
            ev = (gather_rows(table, part['src'], part['perm'], part['inv'])
                  - gather_rows(pos_loc, part['dst'], part['ident'],
                                part['ident'])
                  + part['shift'] @ self.cell)
            out.append(ev @ (torch.eye(3, dtype=ev.dtype, device=ev.device)
                             + eps))
        return out

    def local_energy(self, pos_loc: torch.Tensor,
                     eps: torch.Tensor) -> torch.Tensor:
        """The held ranks' energy (JAX ``_network_energy`` before its
        psum): both edge partitions, the exchange before every
        convolution."""
        from ..model.nequip import (embed_edges, embed_nodes,
                                    readout_and_rescale, run_blocks)

        spec, p = self.model.spec, self.model.params
        pos_all = self.exchange(pos_loc)
        ev_loc, ev_gh = self._edge_vectors(pos_loc, pos_all, eps)
        _, emb_l, sh_l = embed_edges(spec, p, ev_loc, self.loc['mask'])
        _, emb_g, sh_g = embed_edges(spec, p, ev_gh, self.gh['mask'])
        onehot, x = embed_nodes(spec, p, self.atom_type, ev_loc.dtype)
        halo_split = {
            name: dict(src=part['src'], dst=part['dst'], emb=emb, sh=sh,
                       perm=part['perm'], inv=part['inv'])
            for name, part, emb, sh in (('loc', self.loc, emb_l, sh_l),
                                        ('gh', self.gh, emb_g, sh_g))}
        x = run_blocks(spec, p, x, onehot, emb_l, sh_l, self.loc['src'],
                       self.loc['dst'], self.n_node,
                       exchange_fn=self.exchange, edges_sorted=True,
                       src_perm=self.loc['perm'], src_inv=self.loc['inv'],
                       halo_split=halo_split)
        _, atomic_e = readout_and_rescale(spec, p, x, self.atom_type)
        return torch.sum(atomic_e * self.node_mask)

    def energy_forces(self, pos: torch.Tensor, with_stress: bool = False):
        """(held ranks' energy, forces [R, n_local, 3] masked, and with
        ``with_stress`` this process's dE/d strain [3, 3])."""
        shape = pos.shape
        pos = pos.detach().reshape(-1, 3).requires_grad_(True)
        eps = torch.zeros((3, 3), dtype=pos.dtype, device=pos.device,
                          requires_grad=with_stress)
        with torch.enable_grad():
            e = self.local_energy(pos, eps)
            grads = torch.autograd.grad(
                e, (pos, eps) if with_stress else (pos,))
        f = (-grads[0] * self.node_mask[:, None]).reshape(shape)
        return e.detach(), f, (grads[1] if with_stress else None)

    def __call__(self, pos: torch.Tensor):
        e, f, deps = self.energy_forces(pos, with_stress=True)
        # the energy and the strain gradient summed over processes in one
        # all-reduce (JAX: psum, and deps is the global sum)
        tot = torch.cat([e.reshape(1), deps.reshape(-1)])
        if self.distributed:
            dp.all_reduce_(tot)
        w = tot[1:].reshape(3, 3)
        voigt = torch.stack([w[0, 0], w[1, 1], w[2, 2],
                             w[0, 1], w[1, 2], w[2, 0]])
        return tot[0], f, -voigt / self.plan.volume


def make_halo_forward(model, plan: HaloPlan) -> HaloForward:
    """JAX ``make_halo_forward``: ``model`` is a ``NequIP`` on its
    device; the transport follows ``make_transport``."""
    return HaloForward(model, plan)


def gather_forces(plan: HaloPlan, forces_sharded) -> np.ndarray:
    """[D, n_local, c] device layout of every rank -> [n_atoms, c] global
    order."""
    f = np.asarray(forces_sharded).reshape(plan.n_dev * plan.n_local, -1)
    perm = np.asarray(plan.owner_perm).reshape(-1)
    out = np.zeros((plan.n_atoms, f.shape[1]), f.dtype)
    valid = perm >= 0
    out[perm[valid]] = f[valid]
    return out


def scatter_positions(plan: HaloPlan, pos: np.ndarray, fill: float = 0.0,
                      ranks=None) -> np.ndarray:
    """[n_atoms, ...] global -> [R, n_local, ...] float32 device layout of
    ``ranks`` (every rank by default), ``fill`` in the padded rows."""
    ranks = range(plan.n_dev) if ranks is None else ranks
    pos = np.asarray(pos)
    out = np.full((len(ranks), plan.n_local) + pos.shape[1:], fill,
                  np.float32)
    for k, d in enumerate(ranks):
        ids = plan.owner_perm[d]
        valid = ids >= 0
        out[k, valid] = pos[ids[valid]]
    return out
