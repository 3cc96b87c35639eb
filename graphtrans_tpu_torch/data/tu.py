"""TU datasets (NCI1, NCI109): the standard TU file format read with numpy,
the synthetic fallback when no data directory holds the dataset, and the
seeded 80/10/10 split (copied from ``graphtrans_tpu/data/tu.py``).

Node features are one-hot node labels; there are no edge features (the
model's edge encoder contributes zero); the label is one class id per
graph. ``preprocess`` of the JAX package draws a fresh split from
``np.random.default_rng(seed)`` each time, as ``load_tu_splits`` does.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np

from .synthetic import make_tu_dataset


@dataclasses.dataclass
class TUData:
    """A TU dataset's splits, class count and node-label count (the width
    of the one-hot node features, which sizes ``LinearNodeEncoder``)."""

    splits: dict
    num_tasks: int
    num_node_labels: int


def load_tu_dataset(root: str, name: str):
    """Parse the standard TU format (DS_A.txt 1-based edge list,
    DS_graph_indicator.txt, DS_graph_labels.txt, DS_node_labels.txt) under
    ``root/DS/DS``, ``root/DS/raw/DS`` or ``root/DS``. Returns (graphs,
    number of classes), or None when no directory holds the dataset."""
    candidates = [
        os.path.join(root, name, name),
        os.path.join(root, name, "raw", name),
        os.path.join(root, name),
    ]
    d = next((c for c in candidates if os.path.exists(c + "_A.txt")), None)
    if d is None:
        return None

    edges = np.loadtxt(d + "_A.txt", delimiter=",", dtype=np.int64) - 1
    indicator = np.loadtxt(d + "_graph_indicator.txt", dtype=np.int64) - 1
    glabels = np.loadtxt(d + "_graph_labels.txt", dtype=np.int64)
    classes = np.unique(glabels)
    remap = {c: i for i, c in enumerate(classes)}
    nlabel_path = d + "_node_labels.txt"
    if os.path.exists(nlabel_path):
        nlabels = np.loadtxt(nlabel_path, delimiter=",", dtype=np.int64)
        if nlabels.ndim > 1:
            nlabels = nlabels[:, 0]
        num_nl = int(nlabels.max()) + 1
    else:
        nlabels = np.zeros(len(indicator), np.int64)
        num_nl = 1

    graphs = []
    num_graphs = int(indicator.max()) + 1
    node_offsets = np.zeros(num_graphs + 1, np.int64)
    node_offsets[1:] = np.cumsum(np.bincount(indicator,
                                             minlength=num_graphs))
    edge_graph = indicator[edges[:, 0]]
    order = np.argsort(edge_graph, kind="stable")
    edges = edges[order]
    edge_graph = edge_graph[order]
    e_off = np.searchsorted(edge_graph, np.arange(num_graphs + 1))
    for g in range(num_graphs):
        lo, hi = node_offsets[g], node_offsets[g + 1]
        n = hi - lo
        x = np.zeros((n, num_nl), np.float32)
        x[np.arange(n), nlabels[lo:hi]] = 1.0
        ei = edges[e_off[g]:e_off[g + 1]].T - lo
        graphs.append({
            "x": x,
            "edge_index": ei.astype(np.int64),
            "edge_attr": None,
            "y": np.array([remap[glabels[g]]]),
        })
    return graphs, len(classes)


def load_tu_splits(data_root, dataset: str, synthetic_num_graphs: int = 400,
                   synthetic_seed: int = 0, seed=None) -> TUData:
    """The dataset under ``data_root`` (else ``make_tu_dataset`` with 2
    classes) split 80/10/10 by a permutation from
    ``np.random.default_rng(seed)``, as ``TUUtil.preprocess``."""
    loaded = load_tu_dataset(data_root, dataset) if data_root else None
    if loaded is None:
        graphs = make_tu_dataset(num_graphs=synthetic_num_graphs,
                                 seed=synthetic_seed)
        num_classes = 2
    else:
        graphs, num_classes = loaded
    order = np.random.default_rng(seed).permutation(len(graphs))
    n_train = int(len(graphs) * 0.8)
    n_val = int(len(graphs) * 0.1)
    splits = {
        "train": [graphs[i] for i in order[:n_train]],
        "valid": [graphs[i] for i in order[n_train:n_train + n_val]],
        "test": [graphs[i] for i in order[n_train + n_val:]],
    }
    return TUData(splits=splits, num_tasks=num_classes,
                  num_node_labels=int(graphs[0]["x"].shape[1]))
