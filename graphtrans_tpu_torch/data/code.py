"""ogbg-code2 (AST -> method-name subtokens) from OGB's raw CSV layout, read
with gzip and csv, with the synthetic fallback and the preprocessing of
``graphtrans_tpu/data/code.py:CodeUtil.preprocess``: the vocabulary comes
from the train split's targets only, and every split gets ``augment_edge``
and its encoded target ``y_arr``."""

from __future__ import annotations

import csv
import dataclasses
import gzip
import os

import numpy as np

from .mol import _read_csv
from .synthetic import make_code_dataset
from .vocab import (augment_edge, decode_arr_to_seq, encode_seq_to_arr,
                    get_vocab_mapping)


def _read_rows(path):
    with gzip.open(path, "rt", newline="") as f:
        return list(csv.reader(f))


def _num_mapped(path, column: str) -> int:
    """Rows of a headered mapping CSV (``type idx,type``) with ``column``."""
    header, *rows = _read_rows(path)
    if column not in header:
        raise ValueError(f"{path}: no column {column!r} in {header}")
    return len(rows)


def load_code_graphs(root: str, dataset: str):
    """(graphs, split indices, node types, node attributes) from
    ``<root>/<dataset>/raw`` (with ``split/project`` and ``mapping``), or
    None when the directory holds no dataset."""
    base = os.path.join(root, dataset.replace("-", "_"))
    d = os.path.join(base, "raw")
    if not os.path.exists(os.path.join(d, "num-node-list.csv.gz")):
        return None
    rd = lambda name: _read_csv(os.path.join(d, name), np.int64)
    have = lambda name: os.path.exists(os.path.join(d, name))
    nn_list = rd("num-node-list.csv.gz")[:, 0]
    ne_list = rd("num-edge-list.csv.gz")[:, 0]
    node_feat = rd("node-feat.csv.gz")
    edge = rd("edge.csv.gz")
    node_depth = (rd("node_depth.csv.gz")[:, 0]
                  if have("node_depth.csv.gz") else None)
    node_is_attr = (rd("node_is_attributed.csv.gz")[:, 0]
                    if have("node_is_attributed.csv.gz") else None)
    seqs = ([row[0].split() for row in
             _read_rows(os.path.join(d, "graph-label.csv.gz"))]
            if have("graph-label.csv.gz") else None)

    graphs = []
    n_off = e_off = 0
    for i, (n, e) in enumerate(zip(nn_list, ne_list)):
        graphs.append({
            "x": node_feat[n_off:n_off + n, :2].astype(np.int32),
            "edge_index": edge[e_off:e_off + e].T.astype(np.int64),
            "edge_attr": None,
            "node_depth": (node_depth[n_off:n_off + n]
                           if node_depth is not None else np.zeros(n, np.int64)),
            "node_is_attributed": (node_is_attr[n_off:n_off + n]
                                   if node_is_attr is not None
                                   else np.zeros(n, np.int64)),
            "y_seq": seqs[i] if seqs else [],
        })
        n_off += n
        e_off += e

    split_idx = {}
    for split in ("train", "valid", "test"):
        p = os.path.join(base, "split", "project", f"{split}.csv.gz")
        split_idx[split] = (_read_csv(p, np.int64)[:, 0]
                            if os.path.exists(p) else None)
    tpath = os.path.join(base, "mapping", "typeidx2type.csv.gz")
    apath = os.path.join(base, "mapping", "attridx2attr.csv.gz")
    if os.path.exists(tpath) and os.path.exists(apath):
        num_types = _num_mapped(tpath, "type")
        num_attrs = _num_mapped(apath, "attr")
    else:
        num_types = int(node_feat[:, 0].max()) + 1
        num_attrs = int(node_feat[:, 1].max()) + 1
    return graphs, split_idx, num_types, num_attrs


@dataclasses.dataclass
class CodeData:
    splits: dict             # split -> graphs with augmented edges and y_arr
    num_tasks: int           # vocabulary size, __UNK__ and __EOS__ included
    num_nodetypes: int
    num_nodeattributes: int
    idx2vocab: list
    max_seq_len: int

    def arr_to_seq(self, arr) -> list:
        return decode_arr_to_seq(arr, self.idx2vocab)


def load_code_splits(data_root, dataset: str = "ogbg-code2",
                     num_vocab: int = 5000, max_seq_len: int = 5,
                     synthetic_num_graphs: int = 400,
                     synthetic_seed: int = 0) -> CodeData:
    """The three splits of ogbg-code2 from the snapshot under ``data_root``,
    else ``make_code_dataset`` with an 80/10/10 split (20 node types, 100
    attributes), preprocessed as ``CodeUtil.preprocess`` does."""
    loaded = load_code_graphs(data_root, dataset) if data_root else None
    if loaded is None:
        graphs = make_code_dataset(num_graphs=synthetic_num_graphs,
                                   seed=synthetic_seed)
        num_types, num_attrs = 20, 100
        order = np.random.default_rng(0).permutation(len(graphs))
        n_tr, n_va = int(0.8 * len(graphs)), int(0.1 * len(graphs))
        split_idx = {"train": order[:n_tr],
                     "valid": order[n_tr:n_tr + n_va],
                     "test": order[n_tr + n_va:]}
    else:
        graphs, split_idx, num_types, num_attrs = loaded
    vocab2idx, idx2vocab = get_vocab_mapping(
        [graphs[i]["y_seq"] for i in split_idx["train"]], num_vocab)
    splits = {}
    for split, idx in split_idx.items():
        out = []
        for i in (idx if idx is not None else []):
            g = augment_edge(graphs[i])
            g["y_arr"] = encode_seq_to_arr(g["y_seq"], vocab2idx, max_seq_len)
            out.append(g)
        splits[split] = out
    return CodeData(splits=splits, num_tasks=len(vocab2idx),
                    num_nodetypes=num_types, num_nodeattributes=num_attrs,
                    idx2vocab=idx2vocab, max_seq_len=max_seq_len)
