"""Variable-length sequence packing for the transformer stage.

Host side (numpy, copied from ``graphtrans_tpu/ops/pack.py``): each graph's
kept nodes plus its own CLS token are packed contiguously into rows of width
W (first-fit decreasing), and attention is masked by segment id (token i
attends token j iff both belong to the same graph). Device side:
``pack_gather`` turns ``[N+1, d]`` node rows into ``[R*W, d]`` packed slots.
"""

from __future__ import annotations

import numpy as np
import torch


def plan_seq_pack(tokens: np.ndarray, W: int):
    """First-fit-decreasing bin packing of ``tokens[i]`` consecutive slots per
    graph into rows of width W. Returns (rows_used, row[i], start[i])."""
    G = len(tokens)
    order = np.argsort(-tokens, kind="stable")
    row = np.zeros(G, np.int32)
    start = np.zeros(G, np.int32)
    rem = []  # remaining capacity per open row
    for i in order:
        t = int(tokens[i])
        if t > W:
            raise ValueError(f"graph of {t} tokens exceeds pack width {W}")
        for r, free in enumerate(rem):
            if free >= t:
                row[i], start[i] = r, W - free
                rem[r] -= t
                break
        else:
            row[i], start[i] = len(rem), 0
            rem.append(W - t)
    return len(rem), row, start


def build_pack_fields(num_nodes: np.ndarray, graph_mask: np.ndarray,
                      node_offsets: np.ndarray, N: int, W: int,
                      max_keep: int, rows_cap: int = 0):
    """Packing arrays for one batch: ``pack_node [R*W]`` (slot -> flat node
    row, N for CLS/pad slots), ``pack_seg [R*W]`` (graph id, -1 = pad),
    ``pack_cls_slot [G]`` and ``pack_inv [N]`` (node -> slot, R*W = none).
    Each graph keeps its LAST ``min(max_keep, W-1)`` nodes. ``rows_cap > 0``
    pins the row count; returns None if the packing overflows it."""
    G = len(num_nodes)
    valid = np.asarray(graph_mask, bool)
    n = np.asarray(num_nodes, np.int64)
    n_keep = np.minimum(n, min(max_keep, W - 1))
    tokens = np.where(valid, n_keep + 1, 0)  # +1: the graph's own CLS slot

    idx = np.nonzero(valid)[0]
    R, row_v, start_v = plan_seq_pack(tokens[idx], W)
    if rows_cap > 0:
        if R > rows_cap:
            return None
        R = rows_cap
    R = max(R, 1)

    pack_node = np.full(R * W, N, np.int32)
    pack_seg = np.full(R * W, -1, np.int32)
    pack_cls_slot = np.full(G, R * W - 1, np.int32)  # padding graphs: unread
    pack_inv = np.full(N, R * W, np.int32)
    for k, g in enumerate(idx):
        nk = int(n_keep[g])
        s = int(row_v[k]) * W + int(start_v[k])
        first = int(node_offsets[g]) + int(n[g]) - nk
        pack_node[s:s + nk] = np.arange(first, first + nk, dtype=np.int32)
        pack_inv[first:first + nk] = np.arange(s, s + nk, dtype=np.int32)
        pack_seg[s:s + nk + 1] = g
        pack_cls_slot[g] = s + nk  # CLS at the segment end (reference order)
    return {
        "pack_node": pack_node,
        "pack_seg": pack_seg,
        "pack_cls_slot": pack_cls_slot,
        "pack_inv": pack_inv,
        "pack_w": int(W),
        "pack_rows": int(R),
    }


class _PackGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, src, pack_node, pack_inv):
        ctx.save_for_backward(pack_inv)
        ctx.n_src = src.shape[0]
        return src.index_select(0, pack_node.long())

    @staticmethod
    def backward(ctx, g):
        (pack_inv,) = ctx.saved_tensors
        gz = torch.cat([g, g.new_zeros((1,) + g.shape[1:])])
        d_nodes = gz.index_select(0, pack_inv.long())            # [N, d]
        pad = g.new_zeros((ctx.n_src - d_nodes.shape[0],) + g.shape[1:])
        return torch.cat([d_nodes, pad]), None, None


def pack_gather(src: torch.Tensor, pack_node: torch.Tensor,
                pack_inv: torch.Tensor) -> torch.Tensor:
    """``out[s] = src[pack_node[s]]`` with a gather-based backward (copy of
    ``graphtrans_tpu/ops/pack.py:pack_gather``). src is ``[N+1, d]`` whose
    last row is zero (the CLS/pad sentinel); ``pack_inv [N]`` maps each node
    to its slot (``R*W`` = none). The slot map is injective on real nodes,
    so ``d_src[i] = d_out[pack_inv[i]]``: a gather, where the backward of
    ``index_select`` would be an ``index_add_`` (atomics on the card, in no
    fixed order)."""
    return _PackGather.apply(src, pack_node, pack_inv)
