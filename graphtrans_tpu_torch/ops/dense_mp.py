"""Message passing over the strided (dense) graph layout.

Counterpart of ``graphtrans_tpu/ops/dense_mp.py``. Graph g's nodes occupy
flat rows ``[g*Sm, g*Sm + n)``, so ``[N, d]`` node tensors view as
``[G, Sm, d]`` and per-graph edge tables index within a graph. The GIN
aggregation always takes kernel K1 (``ops/kernels/gin_agg.py``) and the
aggregation with precomputed edge embeddings (GCN on NCI1) kernel K6
(``ops/kernels/dense_agg.py``), whatever ``--use_pallas`` says; their
plain versions are this module's plain route. Unlike the TPU package both
run at any width and any number of graphs, and the bond table is not
padded to 128 rows. The degree and the per-edge gathers of node values
are plain PyTorch, outside any kernel in the JAX package too.
"""

from __future__ import annotations

from typing import Optional

import torch

from .kernels import dense_agg, dense_agg_plain, gin_agg, gin_agg_plain


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


def dense_degree(edge_idx: torch.Tensor, edge_mask: torch.Tensor,
                 num_slots: int, dtype=torch.float32) -> torch.Tensor:
    """Valid edges incident per slot: [G, Em] -> [G, Sm]."""
    G = edge_idx.shape[0]
    return torch.zeros(G, num_slots, dtype=dtype,
                       device=edge_idx.device).scatter_add_(
        1, edge_idx.long(), edge_mask.to(dtype))


def dense_gather(x_dense: torch.Tensor, edge_idx: torch.Tensor,
                 edge_mask: torch.Tensor) -> torch.Tensor:
    """[G, Sm, d] rows at per-graph indices [G, Em] -> [G, Em, d], zero on
    masked slots (the JAX package's masked one-hot product)."""
    G, Em = edge_idx.shape
    d = x_dense.shape[-1]
    out = torch.gather(x_dense, 1, edge_idx.long()[..., None].expand(G, Em, d))
    return out.masked_fill(~edge_mask[..., None], 0.0)


def gather_message_scatter_dense(
        x: torch.Tensor, batch, edge_emb: Optional[torch.Tensor],
        edge_weight: Optional[torch.Tensor] = None,
        kernel: bool = True) -> torch.Tensor:
    """Flat-in / flat-out ``relu_add`` aggregation over the strided layout:
    x [N = G*Sm, d], edge_emb [G, Em, d] (the encoder applied to
    ``edge_attr_dense``) or None (zero embeddings: none is made),
    edge_weight [G, Em] or None -> [N, d], the sum of ``w * relu(x_src +
    emb)`` in K6. ``kernel=False`` takes K6's plain version on any
    device."""
    Sm = batch.node_stride
    G = batch.num_graph_slots
    d = x.shape[-1]
    fn = dense_agg if kernel else dense_agg_plain
    emb = None if edge_emb is None else edge_emb.contiguous()
    out = fn(x.reshape(G, Sm, d), batch.edge_src_dense, batch.edge_dst_dense,
             batch.edge_mask_dense, emb, edge_weight)
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
