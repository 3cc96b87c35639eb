"""Host-side batching: fixed capacities, the packing tiers and their row
caps, the shuffled training order and an iterator that cuts a split into
batches in a given order (copied in part from
``graphtrans_tpu/data/loader.py``). A batch whose packing overflows the
pinned row caps is split in two and retried, as ``GraphLoader`` does for a
single consumer."""

from __future__ import annotations

from typing import Iterator, Sequence

import numpy as np

from ..ops.pack import plan_seq_pack
from .batch import GraphBatch, PackOverflow, bucket_size, collate


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


def pack_widths(max_n: int, max_input_len: int) -> tuple:
    """The packing tiers of a split whose largest graph has ``max_n``
    nodes (``GraphLoader``): the widest fits the largest kept graph and its
    CLS token, bucketed to 128; a widest tier past 384 brings a 384 tier and
    a 128 tier for the small graphs (attention costs sum_rows W_r^2)."""
    w = bucket_size(min(max_n, max_input_len) + 1, 128)
    w2 = 384 if w > 384 else 0
    w3 = 128 if w2 > 0 else 0
    return tuple(v for v in (w, w2, w3) if v)


def sample_pack_rows(graphs: Sequence[dict], batch_size: int, node_cap: int,
                     edge_cap: int, widths, max_input_len: int, seed: int = 0,
                     samples: int = 4, plans_per: int = 16) -> tuple:
    """Row caps per tier (``GraphLoader._sample_pack_rows``): the real
    packer over the first ``plans_per`` batch plans of ``samples`` shuffled
    epochs, the most rows each tier needed, +10 % and rounded up to 4. A
    rarer batch that needs more is split by ``iterate_batches``."""
    n = np.array([g["x"].shape[0] for g in graphs], np.int64)
    e = np.array([g["edge_index"].shape[1] for g in graphs], np.int64)
    keep = (n <= node_cap) & (e <= edge_cap)
    max_keep = min(widths[0] - 1, max_input_len)
    need = [1] * len(widths)
    for s in range(samples):
        order = np.arange(len(graphs))
        np.random.default_rng(seed + 104729 * (s + 1)).shuffle(order)
        order = order[keep[order]]
        for plan in plan_chunks(n, e, order, batch_size, node_cap,
                                edge_cap)[:plans_per]:
            tokens = np.minimum(n[plan], max_keep) + 1
            tier = np.zeros(len(tokens), np.int32)
            for t, Wt in enumerate(widths[1:], start=1):
                tier = np.where(tokens <= Wt, t, tier)
            for t, Wt in enumerate(widths):
                need[t] = max(need[t], plan_seq_pack(tokens[tier == t], Wt)[0])
    return tuple(-(-int(x * 1.1 + 1) // 4) * 4 for x in need)


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
    collate_chunk = lambda chunk: collate(chunk, batch_size + 1, node_cap,
                                          edge_cap, **collate_kw)
    for plan in plan_chunks(n, e, order, batch_size, node_cap, edge_cap):
        yield from _split_on_overflow(
            [dict(graphs[t], _id=int(t)) for t in plan], collate_chunk, 0)


def _split_on_overflow(chunk, collate_chunk, depth: int) -> list:
    try:
        return [collate_chunk(chunk)]
    except PackOverflow:
        if len(chunk) < 2 or depth >= 4:
            raise
    mid = len(chunk) // 2
    return (_split_on_overflow(chunk[:mid], collate_chunk, depth + 1)
            + _split_on_overflow(chunk[mid:], collate_chunk, depth + 1))
