"""Message passing over the strided (dense) graph layout.

Counterpart of ``graphtrans_tpu/ops/dense_mp.py``. Graph g's nodes occupy
flat rows ``[g*Sm, g*Sm + n)``, so ``[N, d]`` node tensors view as
``[G, Sm, d]`` and per-graph edge tables index within a graph. The GIN
aggregation always takes kernel K1 (``ops/kernels/gin_agg.py``), whose
plain version is this module's plain route; unlike the TPU package it runs
at any width, and the bond table is not padded to 128 rows.
"""

from __future__ import annotations

from typing import Optional

import torch

from .kernels import gin_agg, gin_agg_plain


def bond_table_index(edge_attr_dense: torch.Tensor, dims) -> torch.Tensor:
    """[G, Em, F] bond features -> [G, F, Em] int32 rows of the
    concatenated table: each feature clipped to its vocabulary, with the
    offsets of the tables before it added."""
    attr = edge_attr_dense.long()
    cols, off = [], 0
    for f, n in enumerate(dims):
        cols.append(attr[..., f].clamp(0, n - 1) + off)
        off += n
    return torch.stack(cols, dim=1).int()


def gather_message_scatter_dense_tables(
        x: torch.Tensor, batch, tables: torch.Tensor, dims,
        eps_scale: Optional[torch.Tensor] = None,
        kernel: bool = True) -> torch.Tensor:
    """``encoder(edge_attr)`` + gather -> relu(x_src + emb) -> scatter-sum
    with the lookup inside K1. x [N = G*Sm, d] -> [N, d]; with
    ``eps_scale`` (a 1-element tensor) it returns ``eps_scale*x + agg``.
    ``kernel=False`` takes K1's plain version on any device."""
    Sm = batch.node_stride
    G = batch.num_graph_slots
    d = x.shape[-1]
    fn = gin_agg if kernel else gin_agg_plain
    out = fn(x.reshape(G, Sm, d), batch.edge_src_dense, batch.edge_dst_dense,
             batch.edge_mask_dense,
             bond_table_index(batch.edge_attr_dense, dims),
             tables.contiguous(), None, eps_scale)
    return out.reshape(G * Sm, d)


def graph_sum(h: torch.Tensor, batch) -> torch.Tensor:
    """Per-graph sum of valid node rows: [N, d] -> [G, d]."""
    G, Sm = batch.num_graph_slots, batch.node_stride
    hd = h.reshape(G, Sm, h.shape[-1])
    return (hd * batch.node_mask.reshape(G, Sm, 1).to(h.dtype)).sum(dim=1)


def graph_broadcast(v: torch.Tensor, batch) -> torch.Tensor:
    """Per-graph rows [G, d] broadcast to their valid nodes [N, d]."""
    G, Sm = batch.num_graph_slots, batch.node_stride
    out = v[:, None, :].expand(G, Sm, v.shape[-1]).reshape(G * Sm, -1)
    return out.masked_fill(~batch.node_mask[:, None], 0.0)
