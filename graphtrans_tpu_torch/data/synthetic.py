"""Synthetic molecule data (numpy; copied from
``graphtrans_tpu/data/synthetic.py`` so both packages draw identical graphs
from one seed)."""

from __future__ import annotations

import numpy as np

from ..nn.encoders import ATOM_FEATURE_DIMS, BOND_FEATURE_DIMS
from .batch import bucket_size, collate
from .loader import dataset_caps


def _random_connected_graph(rng, n, extra_edges):
    """Random tree + extra edges, undirected (both directions emitted)."""
    src, dst = [], []
    for v in range(1, n):
        u = int(rng.integers(0, v))
        src += [u, v]
        dst += [v, u]
    for _ in range(extra_edges):
        u, v = rng.integers(0, n, size=2)
        if u != v:
            src += [int(u), int(v)]
            dst += [int(v), int(u)]
    return np.array([src, dst], dtype=np.int64)


def make_mol_dataset(num_graphs=200, num_tasks=8, min_nodes=8, max_nodes=35,
                     seed=0):
    """molpcba-like graphs: 9 int atom features, 3 int bond features and
    multi-task binary labels with NaN holes."""
    rng = np.random.default_rng(seed)
    graphs = []
    signals = []
    for _ in range(num_graphs):
        n = int(rng.integers(min_nodes, max_nodes + 1))
        ei = _random_connected_graph(rng, n, int(rng.integers(0, n // 2 + 1)))
        x = np.stack([rng.integers(0, d, size=n) for d in ATOM_FEATURE_DIMS],
                     axis=1).astype(np.int8)
        ea = np.stack([rng.integers(0, d, size=ei.shape[1])
                       for d in BOND_FEATURE_DIMS], axis=1).astype(np.int8)
        base = (x[:, 0].mean() / ATOM_FEATURE_DIMS[0]) + ei.shape[1] / (4.0 * n)
        signals.append(base + rng.normal(0, 0.1, size=num_tasks))
        graphs.append({"x": x, "edge_index": ei, "edge_attr": ea})
    # balanced labels: threshold each task at its dataset median
    sig = np.stack(signals)
    thresh = np.median(sig, axis=0)
    for g, s in zip(graphs, sig):
        y = (s > thresh).astype(np.float32)
        y[rng.random(num_tasks) < 0.25] = np.nan
        g["y"] = y
    return graphs


def mol_bench_batch(num_graphs: int = 4096, seed: int = 0):
    """One molpcba-shaped serving batch (``bench.py:build``'s shape):
    ``num_graphs`` graphs of 20-32 nodes with 128 tasks, in the strided
    layout with one tier of packed transformer rows."""
    graphs = make_mol_dataset(num_graphs=num_graphs, num_tasks=128,
                              min_nodes=20, max_nodes=32, seed=seed)
    _, edge_cap = dataset_caps(graphs, num_graphs)
    stride = bucket_size(max(g["x"].shape[0] for g in graphs), 16)
    em = bucket_size(max(g["edge_index"].shape[1] for g in graphs), 8)
    return collate(graphs, num_graphs + 1, (num_graphs + 1) * stride,
                   edge_cap, num_tasks=128, y_dtype="float32",
                   node_stride=stride, dense_edge_cap=em,
                   seq_pack_w=bucket_size(stride + 1, 128))
