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


TIER_NAMES = ("pack", "pack2", "pack3")   # GraphBatch field groups


def build_pack_fields_tiers(num_nodes: np.ndarray, graph_mask: np.ndarray,
                            node_offsets: np.ndarray, N: int, widths,
                            max_keep: int, rows_caps):
    """Multi-tier packing: ``widths`` is a strictly decreasing tuple of up
    to three row widths (e.g. (1024, 384, 128)); each graph packs into the
    narrowest tier its tokens (kept nodes + CLS) fit, each tier as
    ``build_pack_fields`` packs it with row cap ``rows_caps[t]``. Returns
    the fields of the ``TIER_NAMES`` groups; ``pack_cls_slot`` indexes the
    virtual concat of the tiers, widest first. Returns None if any pinned
    row cap overflows. Equal adjacent widths are rejected (the JAX package
    accepts them and then packs nothing into the second tier)."""
    widths = tuple(int(w) for w in widths)
    if not 1 <= len(widths) <= len(TIER_NAMES) or any(
            a <= b for a, b in zip(widths, widths[1:])) or widths[-1] <= 0:
        raise ValueError(f"tier widths {widths}: need 1-3 strictly "
                         "decreasing positive widths")
    if len(rows_caps) != len(widths):
        raise ValueError(f"{len(rows_caps)} row caps for {len(widths)} tiers")
    n = np.asarray(num_nodes, np.int64)
    valid = np.asarray(graph_mask, bool)
    n_keep = np.minimum(n, min(max_keep, widths[0] - 1))
    tokens = n_keep + 1
    tier = np.zeros(len(n), np.int32)     # the narrowest width that fits
    for t, Wt in enumerate(widths[1:], start=1):
        tier = np.where(tokens <= Wt, t, tier)

    fs, offs, off = [], [], 0
    for t, Wt in enumerate(widths):
        ft = build_pack_fields(num_nodes, valid & (tier == t), node_offsets,
                               N, Wt, min(max_keep, Wt - 1), rows_caps[t])
        if ft is None:
            return None
        fs.append(ft)
        offs.append(off)
        off += ft["pack_rows"] * ft["pack_w"]
    cls_slot = fs[0]["pack_cls_slot"].astype(np.int64)
    for t in range(1, len(widths)):
        cls_slot = np.where(tier == t, fs[t]["pack_cls_slot"] + offs[t],
                            cls_slot)
    base = offs[1] - 1 if len(widths) > 1 else fs[0]["pack_cls_slot"]
    out = {"pack_cls_slot": np.where(valid, cls_slot, base).astype(np.int32)}
    for name, ft in zip(TIER_NAMES, fs):
        out.update({f"{name}_node": ft["pack_node"],
                    f"{name}_seg": ft["pack_seg"],
                    f"{name}_inv": ft["pack_inv"],
                    f"{name}_w": ft["pack_w"],
                    f"{name}_rows": ft["pack_rows"]})
    return out


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
