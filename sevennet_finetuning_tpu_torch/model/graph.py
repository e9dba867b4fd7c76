"""Graph construction and padded batching (host-side numpy).

Copy of ``sevennet_finetuning_tpu/model/graph.py``; the batch layout is
kept bit-for-bit: edges sorted by destination, padded edges carrying the
sentinel ``(n_node, n_node)``, and the src-sort permutation
``EDGE_SRC_PERM``.  The port's kernels rely on the same contract (the
sorted destination gives each node a contiguous edge range).

A batch is a plain dict of numpy arrays keyed by ``keys`` constants.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence

import numpy as np

from .. import keys as K
from ..data.neighborlist import neighbor_list
from ..data.vasp import Structure


def structure_to_graph(
    s: Structure,
    cutoff: float,
    type_map: Dict[int, int],
) -> Dict[str, np.ndarray]:
    """One Structure -> unpadded numpy graph with labels.

    Edge convention matches the reference (reference:
    sevenn/train/dataload.py:36-48): edge_index[0]=i, edge_index[1]=j,
    edge_vec = pos[j] + shift.cell - pos[i]; messages flow j -> i.
    """
    idx_i, idx_j, shift, _ = neighbor_list(s.pos, s.cell, s.pbc, cutoff)
    z = s.atomic_numbers
    try:
        atom_type = np.array([type_map[int(n)] for n in z], dtype=np.int32)
    except KeyError as e:
        raise ValueError(f'species Z={e.args[0]} not in type map') from e

    g = {
        K.POS: s.pos.astype(np.float32),
        K.ATOMIC_NUMBERS: z.astype(np.int32),
        K.ATOM_TYPE: atom_type,
        K.EDGE_IDX: np.stack([idx_i, idx_j]).astype(np.int32),
        K.CELL_SHIFT: shift.astype(np.float32),
        K.CELL: s.cell.astype(np.float32).reshape(1, 3, 3),
        K.CELL_VOLUME: np.array([s.volume], dtype=np.float32),
        K.NUM_ATOMS: np.array([len(s)], dtype=np.int32),
    }
    g[K.ENERGY] = np.array(
        [np.nan if s.energy is None else s.energy], dtype=np.float32
    )
    if s.forces is not None:
        g[K.FORCE] = s.forces.astype(np.float32)
    else:
        g[K.FORCE] = np.full((len(s), 3), np.nan, dtype=np.float32)
    if s.stress is not None:
        g[K.STRESS] = s.stress.reshape(1, 6).astype(np.float32)
    else:
        g[K.STRESS] = np.full((1, 6), np.nan, dtype=np.float32)
    g[K.INFO] = dict(s.info)
    g[K.USER_LABEL] = s.info.get('label', K.LABEL_NONE)
    return g


def bucket_capacity(n: int, margin: float = 1.1, quantum: int = 64) -> int:
    """Round up with headroom to a coarse grid so shapes rarely change."""
    return max(quantum, int(math.ceil(n * margin / quantum)) * quantum)


def collate(
    graphs: Sequence[Dict[str, np.ndarray]],
    n_node: Optional[int] = None,
    n_edge: Optional[int] = None,
    n_graph: Optional[int] = None,
) -> Dict[str, np.ndarray]:
    """Pad-and-concatenate graphs into one static-shape batch.

    Edges are emitted SORTED BY DESTINATION (edge_idx[0] ascending over
    the whole batch): each graph's edges are dst-sorted and node offsets
    grow monotonically, which lets the convolution aggregate messages
    with the sorted segment-sum kernel (ops.scatter).

    Padded nodes carry atom_type 0 / mask 0.  Padded edges carry the
    out-of-range sentinel index (n_node, n_node) -- gathers clamp to the
    last row giving an exactly-zero edge_vec, scatters drop them, and
    sortedness is preserved; all their contributions vanish (see
    ops.radial/bessel guard).  Padded graphs have num_atoms 0 and NaN
    labels.
    """
    tot_nodes = sum(len(g[K.POS]) for g in graphs)
    tot_edges = sum(g[K.EDGE_IDX].shape[1] for g in graphs)
    B = len(graphs)
    n_node = tot_nodes if n_node is None else n_node
    n_edge = tot_edges if n_edge is None else n_edge
    n_graph = B if n_graph is None else n_graph
    if tot_nodes > n_node or tot_edges > n_edge or B > n_graph:
        raise ValueError(
            f'batch exceeds capacity: nodes {tot_nodes}/{n_node} '
            f'edges {tot_edges}/{n_edge} graphs {B}/{n_graph}'
        )

    pos = np.zeros((n_node, 3), np.float32)
    atom_type = np.zeros(n_node, np.int32)
    atomic_numbers = np.zeros(n_node, np.int32)
    batch_vec = np.zeros(n_node, np.int32)
    node_mask = np.zeros(n_node, np.float32)
    force = np.full((n_node, 3), np.nan, np.float32)

    edge_idx = np.full((2, n_edge), n_node, np.int32)
    cell_shift = np.zeros((n_edge, 3), np.float32)
    edge_mask = np.zeros(n_edge, np.float32)

    cell = np.zeros((n_graph, 3, 3), np.float32)
    cell[:] = np.eye(3, dtype=np.float32)
    volume = np.ones(n_graph, np.float32)
    energy = np.full(n_graph, np.nan, np.float32)
    stress = np.full((n_graph, 6), np.nan, np.float32)
    num_atoms = np.zeros(n_graph, np.int32)

    node_off = 0
    edge_off = 0
    for b, g in enumerate(graphs):
        n = len(g[K.POS])
        e = g[K.EDGE_IDX].shape[1]
        pos[node_off:node_off + n] = g[K.POS]
        atom_type[node_off:node_off + n] = g[K.ATOM_TYPE]
        atomic_numbers[node_off:node_off + n] = g[K.ATOMIC_NUMBERS]
        batch_vec[node_off:node_off + n] = b
        node_mask[node_off:node_off + n] = 1.0
        force[node_off:node_off + n] = g[K.FORCE]
        order = np.argsort(g[K.EDGE_IDX][0], kind='stable')
        edge_idx[:, edge_off:edge_off + e] = (
            g[K.EDGE_IDX][:, order] + node_off
        )
        cell_shift[edge_off:edge_off + e] = g[K.CELL_SHIFT][order]
        edge_mask[edge_off:edge_off + e] = 1.0
        cell[b] = g[K.CELL][0]
        volume[b] = g[K.CELL_VOLUME][0]
        energy[b] = g[K.ENERGY][0]
        stress[b] = g[K.STRESS][0]
        num_atoms[b] = n
        node_off += n
        edge_off += e

    # permutation sorting edges by SOURCE (padded sentinels stay last):
    # backward-pass scatters (cotangents accumulated by src) then run on
    # the sorted segment-sum kernel instead of an atomic scatter-add
    src_perm = np.argsort(edge_idx[1], kind='stable').astype(np.int32)

    return {
        K.POS: pos,
        K.ATOM_TYPE: atom_type,
        K.ATOMIC_NUMBERS: atomic_numbers,
        K.BATCH: batch_vec,
        K.NODE_MASK: node_mask,
        K.FORCE: force,
        K.EDGE_IDX: edge_idx,
        K.EDGE_SRC_PERM: src_perm,
        K.CELL_SHIFT: cell_shift,
        K.EDGE_MASK: edge_mask,
        K.CELL: cell,
        K.CELL_VOLUME: volume,
        K.ENERGY: energy,
        K.STRESS: stress,
        K.NUM_ATOMS: num_atoms,
    }
