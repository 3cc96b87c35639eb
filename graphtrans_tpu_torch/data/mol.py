"""Molecule datasets (ogbg-molpcba / ogbg-molhiv) from OGB's raw CSV layout,
read with gzip and numpy, with the synthetic fallback of
``graphtrans_tpu/data/mol.py:MolUtil.preprocess``."""

from __future__ import annotations

import gzip
import os

import numpy as np

from .synthetic import make_mol_dataset


def _read_csv(path, dtype):
    """Headerless CSV -> 2-D array; empty fields read as NaN (float only)."""
    with gzip.open(path, "rt") as f:
        if np.issubdtype(dtype, np.floating):
            return np.genfromtxt(f, delimiter=",", dtype=dtype, ndmin=2)
        return np.loadtxt(f, delimiter=",", dtype=dtype, ndmin=2)


def load_ogb_graphs(root: str, dataset: str):
    """Graphs and scaffold split indices from
    ``<root>/<dataset>/raw/*.csv.gz`` (and ``split/scaffold``), or None
    when the directory holds no dataset."""
    base = os.path.join(root, dataset.replace("-", "_"))
    d = os.path.join(base, "raw")
    if not os.path.exists(os.path.join(d, "num-node-list.csv.gz")):
        return None
    nn_list = _read_csv(os.path.join(d, "num-node-list.csv.gz"), np.int64)[:, 0]
    ne_list = _read_csv(os.path.join(d, "num-edge-list.csv.gz"), np.int64)[:, 0]
    node_feat = _read_csv(os.path.join(d, "node-feat.csv.gz"), np.int64)
    edge_feat = _read_csv(os.path.join(d, "edge-feat.csv.gz"), np.int64)
    edge = _read_csv(os.path.join(d, "edge.csv.gz"), np.int64)
    glabel = _read_csv(os.path.join(d, "graph-label.csv.gz"), np.float64)

    graphs = []
    n_off = e_off = 0
    for i, (n, e) in enumerate(zip(nn_list, ne_list)):
        graphs.append({
            "x": node_feat[n_off:n_off + n].astype(np.int8),
            "edge_index": edge[e_off:e_off + e].T.astype(np.int64),
            "edge_attr": edge_feat[e_off:e_off + e].astype(np.int8),
            "y": glabel[i].astype(np.float32),
        })
        n_off += n
        e_off += e

    split_dir = os.path.join(base, "split", "scaffold")
    split_idx = {}
    for split in ("train", "valid", "test"):
        p = os.path.join(split_dir, f"{split}.csv.gz")
        split_idx[split] = (_read_csv(p, np.int64)[:, 0]
                            if os.path.exists(p) else None)
    return graphs, split_idx


def load_mol_splits(data_root, dataset: str, synthetic_num_graphs: int = 400,
                    synthetic_seed: int = 0):
    """``({"train": [...], "valid": [...], "test": [...]}, num_tasks)`` from
    the snapshot under ``data_root``, else from ``make_mol_dataset`` with an
    80/10/10 split, exactly as the JAX package's ``MolUtil.preprocess``."""
    loaded = load_ogb_graphs(data_root, dataset) if data_root else None
    if loaded is None:
        num_tasks = 8 if "pcba" in dataset else 1
        graphs = make_mol_dataset(num_graphs=synthetic_num_graphs,
                                  num_tasks=num_tasks, seed=synthetic_seed)
        order = np.random.default_rng(0).permutation(len(graphs))
        n_tr, n_va = int(0.8 * len(graphs)), int(0.1 * len(graphs))
        split_idx = {"train": order[:n_tr],
                     "valid": order[n_tr:n_tr + n_va],
                     "test": order[n_tr + n_va:]}
    else:
        graphs, split_idx = loaded
        num_tasks = graphs[0]["y"].shape[0]
    splits = {k: [graphs[i] for i in idx] if idx is not None else []
              for k, idx in split_idx.items()}
    return splits, num_tasks
