"""Host-side batching: fixed capacities, the shuffled training order and
an iterator that cuts a split into batches in a given order (copied in part
from ``graphtrans_tpu/data/loader.py``). The JAX package pins one batch
shape per epoch for its jit; the port runs eagerly and does not.
"""

from __future__ import annotations

from typing import Iterator, Sequence

import numpy as np

from .batch import GraphBatch, bucket_size, collate


def dataset_caps(graphs: Sequence[dict], batch_size: int,
                 node_multiple: int = 256, edge_multiple: int = 512):
    """Fixed (node, edge) capacities for ``batch_size``-graph batches: mean
    + 5 sigma of a batch's sum (drawn without replacement) plus one largest
    graph, bucketed. A batch that would overflow is closed early by
    ``iterate_batches``, so nothing is dropped."""
    nodes = np.array([g["x"].shape[0] for g in graphs], np.float64)
    edges = np.array([g["edge_index"].shape[1] for g in graphs], np.float64)

    def bound(sizes):
        n = len(sizes)
        frac = min(batch_size / max(n, 1), 1.0)
        sig = float(sizes.std()) * np.sqrt(batch_size * max(1.0 - frac, 0.0))
        return int(min(sizes.sum(),
                       batch_size * sizes.mean() + 5.0 * sig
                       + max(sizes.max(initial=1), 1)))

    return (bucket_size(max(bound(nodes), 1), node_multiple),
            bucket_size(max(bound(edges), 1), edge_multiple))


def shuffled_order(num_graphs: int, seed: int, epoch: int) -> np.ndarray:
    """The training order of one epoch, as ``GraphLoader(shuffle=True)``
    draws it: ``default_rng(seed + epoch)`` shuffles ``arange(n)``
    (epochs count from 0)."""
    order = np.arange(num_graphs)
    np.random.default_rng(seed + epoch).shuffle(order)
    return order


def plan_chunks(n: np.ndarray, e: np.ndarray, order: np.ndarray,
                batch_size: int, node_cap: int, edge_cap: int):
    """Split ``order`` into per-batch index arrays, as
    ``GraphLoader._plan_chunks`` does: each takes up to ``batch_size``
    graphs and closes early at the first node or edge cap the cumulative
    sizes would pass (``n``/``e`` are the sizes of every graph)."""
    n_arr, e_arr = n[order], e[order]
    plans = []
    i = 0
    while i < len(order):
        j = min(i + batch_size, len(order))
        cn = np.cumsum(n_arr[i:j])
        ce = np.cumsum(e_arr[i:j])
        k = int(np.count_nonzero((cn <= node_cap) & (ce <= edge_cap)))
        plans.append(np.asarray(order[i:i + k], np.int64))
        i += k
    return plans


def iterate_batches(graphs: Sequence[dict], batch_size: int, node_cap: int,
                    edge_cap: int, order=None,
                    **collate_kw) -> Iterator[GraphBatch]:
    """Collate ``graphs`` in ``order`` (default: as given) into batches of
    at most ``batch_size`` graphs (``batch_size + 1`` graph slots), closing
    a batch early where the next graph would pass the node or edge cap.
    ``graph_ids`` index into ``graphs``. A graph larger than the caps
    raises. In the strided layout ``node_cap`` must be
    ``(batch_size + 1) * node_stride``."""
    n = np.array([g["x"].shape[0] for g in graphs], np.int64)
    e = np.array([g["edge_index"].shape[1] for g in graphs], np.int64)
    stride = collate_kw.get("node_stride", 0)
    ecap_g = collate_kw.get("dense_edge_cap", 0)
    over = (n > node_cap) | (e > edge_cap)
    if stride > 0:
        over |= (n > stride) | (e > ecap_g)
    if over.any():
        i = int(np.nonzero(over)[0][0])
        raise ValueError(f"graph {i} ({n[i]} nodes, {e[i]} edges) exceeds "
                         f"the batch caps")
    if order is None:
        order = np.arange(len(graphs))
    for plan in plan_chunks(n, e, order, batch_size, node_cap, edge_cap):
        chunk = [dict(graphs[t], _id=int(t)) for t in plan]
        yield collate(chunk, batch_size + 1, node_cap, edge_cap, **collate_kw)
