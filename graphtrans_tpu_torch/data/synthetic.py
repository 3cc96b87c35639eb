"""Synthetic molecules, NCI-like TU graphs and code2-like ASTs (numpy;
copied from ``graphtrans_tpu/data/synthetic.py`` so both packages draw
identical graphs from one seed)."""

from __future__ import annotations

import numpy as np

from ..nn.encoders import ATOM_FEATURE_DIMS, BOND_FEATURE_DIMS
from ..ops.block_plan import chunk_capacity
from .batch import bucket_size, collate
from .loader import dataset_caps, pack_widths
from .vocab import augment_edge, encode_seq_to_arr, get_vocab_mapping


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


def make_tu_dataset(num_graphs=200, num_classes=2, num_node_labels=16,
                    min_nodes=8, max_nodes=40, seed=0):
    """NCI-like graphs: one-hot node-label features, no edge features, and
    a binary class from graph density and the label histogram (split at
    the dataset's median)."""
    rng = np.random.default_rng(seed)
    graphs = []
    for _ in range(num_graphs):
        n = int(rng.integers(min_nodes, max_nodes + 1))
        extra = int(rng.integers(0, n))
        ei = _random_connected_graph(rng, n, extra)
        labels = rng.integers(0, num_node_labels, size=n)
        x = np.zeros((n, num_node_labels), np.float32)
        x[np.arange(n), labels] = 1.0
        density = ei.shape[1] / (n * (n - 1) + 1)
        signal = density * 10 + (labels < num_node_labels // 2).mean()
        graphs.append({"x": x, "edge_index": ei, "edge_attr": None,
                       "y": np.array([int(signal > 1.05)]),
                       "_signal": signal})
    med = np.median([g["_signal"] for g in graphs])
    for g in graphs:
        g["y"] = np.array([int(g.pop("_signal") > med)])
    return graphs


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


def code2_size_sampler(rng, mean=125.0, sigma=1.0, lo=9, hi=2000):
    """Heavy-tailed AST size: lognormal with mean ~125 nodes, p99 ~650 and
    a tail past max_input_len=1000, clipped to [lo, hi]."""
    mu = np.log(mean) - 0.5 * sigma * sigma
    n = int(np.exp(rng.normal(mu, sigma)))
    return int(np.clip(n, lo, hi))


def make_code_dataset(num_graphs=200, vocab_size=40, seq_len_max=8,
                      num_nodetypes=20, num_nodeattributes=100,
                      min_nodes=10, max_nodes=60, seed=0,
                      size_dist="uniform"):
    """code2-like ASTs: random trees in DFS order with (type, attr) node
    features, node depth, node_is_attributed flags and a target token
    sequence drawn from the node types. ``size_dist='code2'`` draws sizes
    from ``code2_size_sampler`` instead of uniformly in
    [min_nodes, max_nodes]."""
    rng = np.random.default_rng(seed)
    words = [f"tok{i}" for i in range(vocab_size)]
    graphs = []
    for _ in range(num_graphs):
        if size_dist == "code2":
            n = code2_size_sampler(rng)
        else:
            n = int(rng.integers(min_nodes, max_nodes + 1))
        # random tree in DFS order: parent of v in [max(0, v-5), v-1]
        depth = np.zeros(n, np.int64)
        src, dst = [], []
        for v in range(1, n):
            p = int(rng.integers(max(0, v - 5), v))
            depth[v] = depth[p] + 1
            src.append(p)
            dst.append(v)
        ei = np.array([src, dst], dtype=np.int64)
        types = rng.integers(0, num_nodetypes, size=n)
        attrs = rng.integers(0, num_nodeattributes, size=n)
        is_attributed = (rng.random(n) < 0.4).astype(np.int64)
        x = np.stack([types, attrs], axis=1).astype(np.int32)
        L = int(rng.integers(1, seq_len_max))
        seq = [words[int(types[i % n]) % vocab_size] for i in range(L)]
        graphs.append({"x": x, "edge_index": ei, "edge_attr": None,
                       "node_depth": depth,
                       "node_is_attributed": is_attributed, "y_seq": seq})
    return graphs


def mol_bench_batch(num_graphs: int = 4096, seed: int = 0,
                    flat: bool = False):
    """One molpcba-shaped serving batch (``bench.py:build``'s shape):
    ``num_graphs`` graphs of 20-32 nodes with 128 tasks, in the strided
    layout with one tier of packed transformer rows; ``flat``: in the flat
    layout, unpacked, with the dense width of its largest graph (the
    Transformer-only model's batch)."""
    graphs = make_mol_dataset(num_graphs=num_graphs, num_tasks=128,
                              min_nodes=20, max_nodes=32, seed=seed)
    node_cap, edge_cap = dataset_caps(graphs, num_graphs)
    stride = bucket_size(max(g["x"].shape[0] for g in graphs), 16)
    if flat:
        return collate(graphs, num_graphs + 1, node_cap, edge_cap,
                       num_tasks=128, y_dtype="float32", dense_cap=stride)
    em = bucket_size(max(g["edge_index"].shape[1] for g in graphs), 8)
    return collate(graphs, num_graphs + 1, (num_graphs + 1) * stride,
                   edge_cap, num_tasks=128, y_dtype="float32",
                   node_stride=stride, dense_edge_cap=em,
                   seq_pack_w=bucket_size(stride + 1, 128))


def tu_bench_batch(num_graphs: int = 4096, seed: int = 0):
    """One NCI1-shaped batch of ``num_graphs`` synthetic TU graphs
    (``make_tu_dataset``: 8-40 nodes, 16 node labels, 2 classes) in the
    strided layout of the NCI1 GraphTrans (stride and edge slots bucketed
    from its largest graph, one tier of packed rows of 128)."""
    graphs = make_tu_dataset(num_graphs=num_graphs, seed=seed)
    _, edge_cap = dataset_caps(graphs, num_graphs)
    stride = bucket_size(max(g["x"].shape[0] for g in graphs), 16)
    em = bucket_size(max(g["edge_index"].shape[1] for g in graphs), 8)
    return collate(graphs, num_graphs + 1, (num_graphs + 1) * stride,
                   edge_cap, num_tasks=2, y_dtype="int32",
                   node_stride=stride, dense_edge_cap=em,
                   seq_pack_w=bucket_size(stride + 1, 128))


def code2_bench_batch(num_graphs: int = 512, seed: int = 0,
                      max_input_len: int = 1000, flat: bool = False,
                      bsp: bool = False):
    """One code2-shaped serving batch (``bench.py:build_code2``'s shape):
    ``num_graphs`` ASTs of the heavy-tailed code2 size distribution, edges
    augmented, five target positions, in the flat layout with the packing
    tiers of its largest graph (1024, 384, 128 at 512 graphs); ``flat``:
    unpacked, with the dense width of its largest graph capped at
    ``max_input_len`` (1000 at 512 graphs; the Transformer-only model's
    batch); ``bsp``: with K8's block plans at
    ``chunk_capacity(edge cap, node cap)``. Returns (batch, vocabulary
    size)."""
    raw = make_code_dataset(num_graphs=num_graphs, vocab_size=5000,
                            seq_len_max=6, min_nodes=50, max_nodes=250,
                            seed=seed, size_dist="code2")
    vocab2idx, _ = get_vocab_mapping([g["y_seq"] for g in raw], 5000)
    graphs = [dict(augment_edge(g),
                   y_arr=encode_seq_to_arr(g["y_seq"], vocab2idx, 5))
              for g in raw]
    node_cap, edge_cap = dataset_caps(graphs, num_graphs)
    max_n = max(g["x"].shape[0] for g in graphs)
    if flat:
        tiers = {"dense_cap": min(bucket_size(max_n, 16), max_input_len)}
    else:
        tiers = {f"seq_pack_w{t + 1 if t else ''}": w
                 for t, w in enumerate(pack_widths(max_n, max_input_len))}
    if bsp:
        tiers["bsp_chunks_cap"] = chunk_capacity(edge_cap, node_cap)
    return collate(graphs, num_graphs + 1, node_cap, edge_cap,
                   max_input_len=max_input_len, num_tasks=len(vocab2idx),
                   max_seq_len=5, y_dtype="int32", **tiers), len(vocab2idx)
