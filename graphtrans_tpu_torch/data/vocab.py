"""ogbg-code2 vocabulary, target-sequence encoding and edge augmentation
(numpy; copied from ``graphtrans_tpu/data/vocab.py``).

The vocabulary is the ``num_vocab`` most frequent target tokens, ties
broken by first appearance, then ``__UNK__`` and ``__EOS__`` (always the
last id). Encoding pads with ``__EOS__`` and maps unknown tokens to
``__UNK__``; decoding stops at the first ``__EOS__``.
"""

from __future__ import annotations

from collections import Counter

import numpy as np


def get_vocab_mapping(seq_list, num_vocab):
    """(vocab2idx, idx2vocab) from the token sequences ``seq_list``."""
    counts: Counter = Counter()
    for seq in seq_list:
        counts.update(seq)
    idx2vocab = sorted(counts, key=counts.__getitem__, reverse=True)[:num_vocab]
    idx2vocab += ["__UNK__", "__EOS__"]
    vocab2idx = {w: i for i, w in enumerate(idx2vocab)}
    if len(vocab2idx) != len(idx2vocab):
        raise ValueError("a target token clashes with __UNK__ or __EOS__")
    return vocab2idx, idx2vocab


def encode_seq_to_arr(seq, vocab2idx, max_seq_len) -> np.ndarray:
    augmented = (list(seq[:max_seq_len])
                 + ["__EOS__"] * max(0, max_seq_len - len(seq)))
    return np.array([vocab2idx.get(w, vocab2idx["__UNK__"])
                     for w in augmented], dtype=np.int64)


def decode_arr_to_seq(arr, idx2vocab) -> list:
    arr = np.asarray(arr)
    eos = len(idx2vocab) - 1
    hits = np.nonzero(arr == eos)[0]
    if len(hits):
        arr = arr[: hits.min()]
    return [idx2vocab[int(i)] for i in arr]


def augment_edge(graph: dict) -> dict:
    """code2 edge augmentation: AST edges get attr [0, 0], inverse AST
    edges [0, 1], next-token edges chaining the attributed nodes in DFS
    order [1, 0], inverse next-token edges [1, 1]."""
    ei = graph["edge_index"]
    a_ast = np.zeros((ei.shape[1], 2))
    a_ast_inv = np.stack([np.zeros(ei.shape[1]), np.ones(ei.shape[1])], axis=1)
    attributed = np.nonzero(graph["node_is_attributed"].reshape(-1) == 1)[0]
    e_next = (np.stack([attributed[:-1], attributed[1:]])
              if len(attributed) > 1 else np.zeros((2, 0), np.int64))
    a_next = np.stack([np.ones(e_next.shape[1]), np.zeros(e_next.shape[1])],
                      axis=1)
    a_next_inv = np.ones((e_next.shape[1], 2))

    out = dict(graph)
    out["edge_index"] = np.concatenate(
        [ei, ei[::-1], e_next, e_next[::-1]], axis=1).astype(np.int64)
    out["edge_attr"] = np.concatenate(
        [a_ast, a_ast_inv, a_next, a_next_inv], axis=0).astype(np.int8)
    return out
