"""Dataset container, statistics, and the padded-batch loader.

Port of ``sevennet_finetuning_tpu/data/dataset.py`` for one device:
label-grouped lists of numpy graphs and a loader that emits statically
padded batches (capacities computed once per dataset).  The shuffle draws
from ``np.random.default_rng(seed)`` exactly as the JAX package's loader
does, so both packages visit the same batches from the same seed.  With
``data_weights`` (label -> per-term weight) each batch carries the
per-graph weights of the loss terms.  The sharded (data-parallel)
branches come with the DDP slice (ROADMAP A.8).

Statistics follow the reference:
- per-atom energy mean / std (shift candidates)
- force RMS, species-wise force RMS (scale candidates)
- species reference energies by Ridge(alpha=0.1) regression on
  compositions (reference: sevenn/train/dataset.py:279-309)
- average neighbor count (conv denominator)

``.sevenn_data`` artifacts (``save_sevenn_data`` / ``load_sevenn_data`` /
``sevenn_data_structures``) have the JAX package's layout, a pickle of
the graphs, cutoff, type map and (optionally) the structures, so each
package reads the other's; a JAX-written one pickles
``sevennet_finetuning_tpu.data.vasp.Structure``, which ``_load_blob``
maps to this package's copy of the class without importing the JAX
package.  Reference artifacts (a ``torch.save`` of ``AtomGraphDataset``)
go through ``compat/sevenn_data_import``.
"""

from __future__ import annotations

import math
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from .. import keys as K
from ..model.graph import bucket_capacity, collate, structure_to_graph
from .vasp import Structure

# the Structure classes a .sevenn_data pickle may name: the JAX package's
# and this package's (the same dataclass, copied verbatim)
_STRUCTURE_CLASSES = (('sevennet_finetuning_tpu.data.vasp', 'Structure'),
                      ('sevennet_finetuning_tpu_torch.data.vasp', 'Structure'))


class GraphDataset:
    def __init__(self, graphs: Optional[List[Dict]] = None):
        self.graphs: List[Dict] = list(graphs) if graphs else []

    def __len__(self):
        return len(self.graphs)

    @staticmethod
    def from_structures(
        structures: Sequence[Structure],
        cutoff: float,
        type_map: Dict[int, int],
        label: str = K.LABEL_NONE,
        n_cores: int = 1,
    ) -> 'GraphDataset':
        """Graph build; ``n_cores > 1`` builds in a spawned worker pool
        (the config key preprocess_num_cores, reference:
        sevenn/train/dataload.py:174-184)."""
        if n_cores > 1 and len(structures) >= 4:
            import functools
            import multiprocessing as mp

            with mp.get_context('spawn').Pool(n_cores) as pool:
                gs = pool.map(
                    functools.partial(structure_to_graph, cutoff=cutoff,
                                      type_map=type_map),
                    structures,
                    chunksize=max(1, len(structures) // (4 * n_cores)))
        else:
            gs = [structure_to_graph(s, cutoff, type_map)
                  for s in structures]
        for g, s in zip(gs, structures):
            g[K.USER_LABEL] = s.info.get('label', label)
        return GraphDataset(gs)

    def extend(self, other: 'GraphDataset'):
        self.graphs.extend(other.graphs)

    # ---- statistics -----------------------------------------------------
    def _per_atom_energies(self) -> List[float]:
        return [float(g[K.ENERGY][0]) / int(g[K.NUM_ATOMS][0])
                for g in self.graphs if np.isfinite(g[K.ENERGY][0])]

    def per_atom_energy_mean(self) -> float:
        return float(np.mean(self._per_atom_energies()))

    def per_atom_energy_std(self) -> float:
        return float(np.std(self._per_atom_energies()))

    def force_rms(self) -> float:
        sq = [np.square(g[K.FORCE][np.isfinite(g[K.FORCE])])
              for g in self.graphs]
        return float(np.sqrt(np.mean(np.concatenate([s.ravel()
                                                     for s in sq]))))

    def avg_num_neigh(self) -> float:
        counts = []
        for g in self.graphs:
            counts.extend(np.unique(g[K.EDGE_IDX][0], return_counts=True)[1])
        return float(np.mean(counts))

    def species_ref_energies(self, num_species: int) -> np.ndarray:
        """Ridge(alpha=0.1, no intercept) fit of E on composition counts
        over species present (reference: sevenn/train/dataset.py:279-309)."""
        c = np.zeros((len(self.graphs), num_species))
        y = np.zeros(len(self.graphs))
        for i, g in enumerate(self.graphs):
            c[i] = np.bincount(g[K.ATOM_TYPE], minlength=num_species)
            y[i] = g[K.ENERGY][0]
        present = ~np.all(c == 0, axis=0)
        cr = c[:, present]
        A = cr.T @ cr + 0.1 * np.eye(cr.shape[1])
        coef = np.linalg.solve(A, cr.T @ y)
        full = np.zeros(num_species)
        full[present] = coef
        return full

    def species_force_rms(self, num_species: int) -> np.ndarray:
        sums = np.zeros(num_species)
        counts = np.zeros(num_species)
        for g in self.graphs:
            for sp in range(num_species):
                m = g[K.ATOM_TYPE] == sp
                if m.any():
                    sums[sp] += np.square(g[K.FORCE][m]).sum()
                    counts[sp] += m.sum() * 3
        out = np.sqrt(np.divide(sums, np.maximum(counts, 1)))
        out[counts == 0] = 1.0
        return out

    # ---- splitting ------------------------------------------------------
    def divide(self, ratio: float, seed: int = 0
               ) -> Tuple['GraphDataset', 'GraphDataset']:
        """(train, valid) split; valid fraction = ratio (reference:
        sevenn/train/dataset.py:187-236)."""
        if ratio > 0.5:
            raise ValueError('data_divide_ratio must not exceed 0.5')
        n = len(self.graphs)
        idx = np.random.default_rng(seed).permutation(n)
        n_valid = int(n * ratio)
        if n_valid == 0:
            raise ValueError(
                f'validation split is empty ({n} structures x ratio '
                f'{ratio}); add data, raise data_divide_ratio, or provide '
                'a validation set')
        valid = [self.graphs[i] for i in idx[:n_valid]]
        train = [self.graphs[i] for i in idx[n_valid:]]
        return GraphDataset(train), GraphDataset(valid)


def _load_blob(path: str):
    """A .sevenn_data pickle of either package, through an unpickler that
    resolves the numpy globals of an array and the ``Structure`` class of
    either package (as this package's), and nothing else."""
    import pickle

    from ..train.checkpoint import numpy_global

    class _Unpickler(pickle.Unpickler):
        def find_class(self, module, name):
            if (module, name) in _STRUCTURE_CLASSES:
                return Structure
            fn = numpy_global(module, name)
            if fn is not None:
                return fn
            raise pickle.UnpicklingError(
                f'{path} references {module}.{name}, which is not loaded')

    with open(path, 'rb') as f:
        return _Unpickler(f).load()


def save_sevenn_data(
    path: str,
    dataset: GraphDataset,
    cutoff: float,
    type_map: Dict[int, int],
    structures: Optional[Sequence[Structure]] = None,
):
    """Write a prebuilt dataset artifact (the JAX package's .sevenn_data;
    the reference's is a torch.save of AtomGraphDataset, reference:
    sevenn/train/dataset.py:453-465).  Stores the graphs plus (optionally)
    the raw structures so a later load under a different cutoff/type-map
    can rebuild instead of failing."""
    import pickle

    blob = {
        'version': 2,
        'cutoff': float(cutoff),
        'type_map': {int(z): int(i) for z, i in type_map.items()},
        'graphs': dataset.graphs,
        'structures': list(structures) if structures is not None else None,
    }
    with open(path, 'wb') as f:
        pickle.dump(blob, f)


def load_sevenn_data(
    path: str,
    cutoff: Optional[float] = None,
    type_map: Optional[Dict[int, int]] = None,
    n_cores: int = 1,
) -> GraphDataset:
    """Load a .sevenn_data artifact -- either package's (a pickle blob) or
    a REFERENCE-produced one (torch.save of AtomGraphDataset; imported
    best-effort via compat.sevenn_data_import and rebuilt with this
    package's neighbor list).  Uses the stored graphs when the requested
    cutoff/type-map match (or are unspecified); rebuilds from the stored
    structures otherwise; errors if a rebuild is needed but the artifact
    carries no structures."""
    from ..compat.sevenn_data_import import is_reference_sevenn_data

    if is_reference_sevenn_data(path):
        from ..compat.sevenn_data_import import (
            reference_sevenn_data_cutoff,
            reference_sevenn_data_structures,
        )

        structures = reference_sevenn_data_structures(path)
        cut = cutoff if cutoff is not None \
            else reference_sevenn_data_cutoff(path)
        if cut is None:
            raise ValueError(f'{path}: no cutoff stored or requested')
        if type_map is None:
            from .elements import type_map_from_species

            type_map = type_map_from_species(
                {sp for s in structures for sp in s.species}
            )
        return GraphDataset.from_structures(
            structures, float(cut), type_map, n_cores=n_cores
        )

    blob = _load_blob(path)
    stored_cut = float(blob['cutoff'])
    stored_tm = {int(z): int(i) for z, i in blob['type_map'].items()}
    match = (cutoff is None or abs(stored_cut - float(cutoff)) < 1e-9) \
        and (type_map is None
             or stored_tm == {int(z): int(i) for z, i in type_map.items()})
    if match:
        return GraphDataset(blob['graphs'])
    structures = blob.get('structures')
    if structures is None:
        raise ValueError(
            f'{path}: built with cutoff={stored_cut}/different type map '
            f'and carries no structures to rebuild from '
            f'(requested cutoff={cutoff})'
        )
    return GraphDataset.from_structures(
        structures, float(cutoff if cutoff is not None else stored_cut),
        type_map if type_map is not None else stored_tm, n_cores=n_cores,
    )


def sevenn_data_structures(path: str) -> Optional[List[Structure]]:
    """The raw structures stored in an artifact (None if absent)."""
    from ..compat.sevenn_data_import import is_reference_sevenn_data

    if is_reference_sevenn_data(path):
        from ..compat.sevenn_data_import import (
            reference_sevenn_data_structures,
        )

        return reference_sevenn_data_structures(path)
    return _load_blob(path).get('structures')


class Loader:
    """Iterable over statically padded batches, for one device.

    Capacities are fixed at construction (max batch totals + headroom,
    bucketed) so every batch of an epoch has the same shapes.
    ``cache=True`` collates every batch once and replays them across
    epochs: membership is fixed (size-balanced packing), only batch
    ORDER reshuffles (``epoch_order``); the Trainer puts such batches on
    the device once.
    """

    def __init__(
        self,
        dataset: GraphDataset,
        batch_size: int,
        shuffle: bool = False,
        seed: int = 0,
        n_node: Optional[int] = None,
        n_edge: Optional[int] = None,
        n_graph: Optional[int] = None,
        cache: bool = False,
        data_weights: Optional[Dict[str, Dict[str, float]]] = None,
    ):
        self.graphs = dataset.graphs
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.rng = np.random.default_rng(seed)
        self.data_weights = data_weights
        self.cache = cache
        self._cached: Optional[List[Dict]] = None

        # size-balanced packing: with fixed membership (cache=True) the
        # batches equalize per-batch edge totals (greedy first-fit
        # decreasing), so the padded capacity shrinks toward the mean
        self._balanced_order: Optional[np.ndarray] = None
        if cache and len(self.graphs) > batch_size:
            self._balanced_order = self._balance_membership()

        if n_node is None or n_edge is None:
            nodes = np.array([len(g[K.POS]) for g in self.graphs])
            edges = np.array([g[K.EDGE_IDX].shape[1] for g in self.graphs])
            if self._balanced_order is not None:
                # exact maxima over the packed batches: membership is
                # frozen, so no headroom margin is needed
                self.n_node = n_node or bucket_capacity(
                    self._packed_max(nodes), margin=1.0)
                self.n_edge = n_edge or bucket_capacity(
                    self._packed_max(edges), margin=1.0, quantum=256)
            else:
                self.n_node = n_node or bucket_capacity(
                    self._worst_batch_total(nodes))
                self.n_edge = n_edge or bucket_capacity(
                    self._worst_batch_total(edges))
        else:
            self.n_node = n_node
            self.n_edge = n_edge
        # n_graph may exceed batch_size so loaders over different sets
        # share one batch shape (collate pads graph slots)
        self.n_graph = max(batch_size, n_graph or 0)

    def _balance_membership(self) -> np.ndarray:
        """Pack graphs into batches of ``batch_size`` equalizing edge
        totals: sort descending by edge count, give each graph to the
        non-full batch with the smallest running total.  Returns a
        permutation whose consecutive ``batch_size`` chunks are the
        batches."""
        edges = np.array([g[K.EDGE_IDX].shape[1] for g in self.graphs])
        n_batches = math.ceil(len(edges) / self.batch_size)
        slots = np.zeros(n_batches, np.int64)
        totals = np.zeros(n_batches, np.int64)
        members: List[List[int]] = [[] for _ in range(n_batches)]
        for i in np.argsort(-edges):
            open_b = np.flatnonzero(slots < self.batch_size)
            j = open_b[np.argmin(totals[open_b])]
            members[j].append(int(i))
            slots[j] += 1
            totals[j] += edges[i]
        return np.concatenate([np.array(m, np.int64) for m in members])

    def _packed_max(self, vals: np.ndarray) -> int:
        order = self._balanced_order
        mx = 0
        for lo in range(0, len(order), self.batch_size):
            mx = max(mx, int(vals[order[lo:lo + self.batch_size]].sum()))
        return max(mx, 1)

    def _worst_batch_total(self, vals: np.ndarray) -> int:
        """Upper bound of sum(vals[i] for i in batch) over any batch."""
        if len(vals) == 0:
            return self.batch_size
        v = np.sort(vals)[::-1]
        if len(v) >= self.batch_size:
            return int(v[:self.batch_size].sum())
        return int(v.sum() + (self.batch_size - len(v)) * v[0])

    def __len__(self):
        return math.ceil(len(self.graphs) / self.batch_size)

    def __iter__(self) -> Iterator[Dict]:
        if self.cache:
            self.materialize()
            for i in self.epoch_order():
                yield self._cached[i]
            return
        yield from self._iter_fresh()

    def materialize(self) -> List[Dict]:
        """Collate every batch once and keep them (membership fixed by the
        size-balanced packing; ``epoch_order`` reshuffles their order)."""
        if self._cached is None:
            self._cached = list(
                self._iter_fresh(order=self._balanced_order))
        return self._cached

    def epoch_order(self) -> np.ndarray:
        """Order in which this epoch visits the materialized batches."""
        order = np.arange(len(self.materialize()))
        if self.shuffle:
            self.rng.shuffle(order)
        return order

    def _iter_fresh(self, order: Optional[np.ndarray] = None
                    ) -> Iterator[Dict]:
        if order is None:
            order = np.arange(len(self.graphs))
            if self.shuffle:
                self.rng.shuffle(order)
        for i in range(0, len(order), self.batch_size):
            chunk = [self.graphs[j] for j in order[i:i + self.batch_size]]
            batch = collate(chunk, n_node=self.n_node, n_edge=self.n_edge,
                            n_graph=self.n_graph)
            if self.data_weights is not None:
                batch[K.DATA_WEIGHT] = self._weights_for(chunk)
            yield batch

    def _weights_for(self, chunk) -> Dict[str, np.ndarray]:
        """Per-graph weights of the energy, force and stress terms from
        each structure's label (1 for a padded slot or an unlisted
        label)."""
        out = {}
        for wkey in (K.PER_ATOM_ENERGY, K.FORCE, K.STRESS):
            w = np.ones(self.n_graph, np.float32)
            for b, g in enumerate(chunk):
                label = g.get(K.USER_LABEL, K.LABEL_NONE)
                w[b] = self.data_weights.get(label, {}).get(wkey, 1.0)
            out[wkey] = w
        return out
