"""Host-side batching for evaluation: fixed capacities and an in-order
iterator over one split (copied in part from ``graphtrans_tpu/data/loader.py``).
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


def iterate_batches(graphs: Sequence[dict], batch_size: int, node_cap: int,
                    edge_cap: int, **collate_kw) -> Iterator[GraphBatch]:
    """Collate ``graphs`` in order into batches of at most ``batch_size``
    graphs (``batch_size + 1`` graph slots), closing a batch early where
    the next graph would pass the node or edge cap. ``graph_ids`` index
    into ``graphs``. A graph larger than the caps raises. In the strided
    layout ``node_cap`` must be ``(batch_size + 1) * node_stride``."""
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
    i = 0
    while i < len(graphs):
        j = min(i + batch_size, len(graphs))
        cn = np.cumsum(n[i:j])
        ce = np.cumsum(e[i:j])
        k = int(np.count_nonzero((cn <= node_cap) & (ce <= edge_cap)))
        chunk = [dict(graphs[t], _id=t) for t in range(i, i + k)]
        yield collate(chunk, batch_size + 1, node_cap, edge_cap, **collate_kw)
        i += k
