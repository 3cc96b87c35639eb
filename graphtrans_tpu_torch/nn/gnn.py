"""GNN node-embedding stack with an optional virtual node (counterpart of
``graphtrans_tpu/nn/gnn.py``), JK=cat or last: GIN on the strided layout
(molpcba), GCN on the flat layout (code2) or on the strided layout (NCI1).

Before each layer the virtual node's per-graph embedding is added to its
graph's nodes, and that sum overwrites ``h_list[layer]`` (the reference
mutates the list in place, which feeds JK=cat's first entry). After every
layer but the last the virtual node is updated from the per-graph sum of
``h_list[layer]`` through a two-layer BN-MLP. No ReLU after the last layer.
In training mode ``ByteDropout(drop_ratio)`` runs at the JAX package's
sites: after the ReLU of layers 0..L-2, on the last layer's BN output, and
on each virtual-node MLP output; BatchNorm uses batch statistics."""

from __future__ import annotations

from typing import Callable, Optional

import torch
from torch import nn

from ..ops import dense_mp
from ..ops.segment import segment_sum
from .conv import GCNConv, GINConv
from .dropout import ByteDropout
from .encoders import AtomEncoder, LinearEdgeEncoder
from .norm import MaskedBatchNorm


class VirtualNodeMLP(nn.Module):
    """Linear(d,2d) -> BN -> ReLU -> Linear(2d,d) -> BN -> ReLU over
    per-graph rows."""

    def __init__(self, emb_dim: int, device=None):
        super().__init__()
        self.lin1 = nn.Linear(emb_dim, 2 * emb_dim, device=device)
        self.bn1 = MaskedBatchNorm(2 * emb_dim, device=device)
        self.lin2 = nn.Linear(2 * emb_dim, emb_dim, device=device)
        self.bn2 = MaskedBatchNorm(emb_dim, device=device)

    def forward(self, v: torch.Tensor, graph_mask: torch.Tensor):
        v = torch.relu(self.bn1(self.lin1(v), graph_mask))
        return torch.relu(self.bn2(self.lin2(v), graph_mask))


def graph_broadcast(v: torch.Tensor, batch) -> torch.Tensor:
    """Per-graph rows [G, d] on their graphs' valid nodes [N, d]."""
    if batch.node_stride > 0:
        return dense_mp.graph_broadcast(v, batch)
    rows = v.index_select(0, batch.node_graph.long())
    return rows.masked_fill(~batch.node_mask[:, None], 0.0)


def graph_sum(h: torch.Tensor, batch) -> torch.Tensor:
    """Per-graph sum of valid node rows: [N, d] -> [G, d]."""
    if batch.node_stride > 0:
        return dense_mp.graph_sum(h, batch)
    return segment_sum(h, batch.node_graph, batch.num_graph_slots,
                       batch.node_mask)


JKS = ("cat", "last")


def gnn_out_dim(JK: str, emb_dim: int) -> int:
    return 2 * emb_dim if JK == "cat" else emb_dim


class GNNNodeEmbedding(nn.Module):
    """``gnn_type`` "gin" (bond tables, strided layout) or "gcn" (one edge
    encoder per layer from ``edge_encoder``, a factory: by default code2's
    ``LinearEdgeEncoder``; TU's ``ZeroEdgeEncoder``); ``node_encoder``
    defaults to the molecule ``AtomEncoder``, and one with ``takes_depth``
    (code2's ``ASTNodeEncoder``) also reads ``node_depth``. ``JK`` "cat"
    returns the encoder output beside the last layer, "last" the last
    layer alone."""

    def __init__(self, num_layer: int, emb_dim: int,
                 virtual_node: bool = True, drop_ratio: float = 0.0,
                 gnn_type: str = "gin",
                 node_encoder: Optional[nn.Module] = None, device=None,
                 JK: str = "cat",
                 edge_encoder: Optional[Callable[[], nn.Module]] = None):
        super().__init__()
        if num_layer < 2:
            raise ValueError("Number of GNN layers must be greater than 1.")
        if JK not in JKS:
            raise ValueError(f"JK {JK!r} not in {JKS}")
        self.num_layer = num_layer
        self.emb_dim = emb_dim
        self.JK = JK
        # named as in slice 1 for every node encoder (state-dict keys)
        self.atom_encoder = (node_encoder if node_encoder is not None
                             else AtomEncoder(emb_dim, device=device))
        if gnn_type == "gin":
            make = lambda: GINConv(emb_dim, device=device)
        elif gnn_type == "gcn":
            edge = edge_encoder or (lambda: LinearEdgeEncoder(emb_dim,
                                                              device=device))
            make = lambda: GCNConv(emb_dim, edge(), device=device)
        else:
            raise ValueError(f"Undefined GNN type called {gnn_type}")
        self.convs = nn.ModuleList(make() for _ in range(num_layer))
        self.batch_norms = nn.ModuleList(MaskedBatchNorm(emb_dim, device=device)
                                         for _ in range(num_layer))
        self.virtual_node = virtual_node
        if virtual_node:
            self.virtualnode_embedding = nn.Parameter(
                torch.zeros(emb_dim, device=device))
            self.vn_mlps = nn.ModuleList(VirtualNodeMLP(emb_dim, device=device)
                                         for _ in range(num_layer - 1))
        self.dropout = ByteDropout(drop_ratio)

    def init_from(self, gen):
        if self.virtual_node:
            nn.init.zeros_(self.virtualnode_embedding)

    def _encode(self, batch) -> torch.Tensor:
        if getattr(self.atom_encoder, "takes_depth", False):
            return self.atom_encoder(batch.node_feat, batch.node_depth)
        return self.atom_encoder(batch.node_feat)

    def forward(self, batch, gen=None) -> torch.Tensor:
        """[N, F] node features -> [N, 2*emb_dim] (JK=cat of the encoder
        output, with the first virtual-node add, and the last layer) or
        [N, emb_dim] (JK=last). ``gen`` (``nn.dropout.Generators``) feeds
        dropout in training."""
        mask = batch.node_mask[:, None]
        h_list = [self._encode(batch).masked_fill(~mask, 0.0)]
        if self.virtual_node:
            vn = self.virtualnode_embedding.expand(batch.num_graph_slots, -1)
        for layer in range(self.num_layer):
            if self.virtual_node:
                h_list[layer] = h_list[layer] + graph_broadcast(vn, batch)
            h = self.convs[layer](batch, h_list[layer])
            h = self.batch_norms[layer](h, batch.node_mask)
            if layer < self.num_layer - 1:
                h = torch.relu(h)
            h_list.append(self.dropout(h, gen))
            if self.virtual_node and layer < self.num_layer - 1:
                pooled = graph_sum(h_list[layer], batch)
                vn = self.dropout(
                    self.vn_mlps[layer](pooled + vn, batch.graph_mask), gen)
        out = (torch.cat([h_list[0], h_list[-1]], dim=-1) if self.JK == "cat"
               else h_list[-1])
        return out.masked_fill(~mask, 0.0)
