"""GIN node-embedding stack with an optional virtual node (counterpart of
``graphtrans_tpu/nn/gnn.py``), in eval mode, JK=cat.

Before each layer the virtual node's per-graph embedding is added to its
graph's nodes, and that sum overwrites ``h_list[layer]`` (the reference
mutates the list in place, which feeds JK=cat's first entry). After every
layer but the last the virtual node is updated from the per-graph sum of
``h_list[layer]`` through a two-layer BN-MLP. No ReLU after the last layer;
dropout is the identity in eval."""

from __future__ import annotations

import torch
from torch import nn

from ..ops.dense_mp import graph_broadcast, graph_sum
from .conv import GINConv
from .encoders import AtomEncoder
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


class GNNNodeEmbedding(nn.Module):
    def __init__(self, num_layer: int, emb_dim: int,
                 virtual_node: bool = True, device=None):
        super().__init__()
        if num_layer < 2:
            raise ValueError("Number of GNN layers must be greater than 1.")
        self.num_layer = num_layer
        self.emb_dim = emb_dim
        self.atom_encoder = AtomEncoder(emb_dim, device=device)
        self.convs = nn.ModuleList(GINConv(emb_dim, device=device)
                                   for _ in range(num_layer))
        self.batch_norms = nn.ModuleList(MaskedBatchNorm(emb_dim, device=device)
                                         for _ in range(num_layer))
        self.virtual_node = virtual_node
        if virtual_node:
            self.virtualnode_embedding = nn.Parameter(
                torch.zeros(emb_dim, device=device))
            self.vn_mlps = nn.ModuleList(VirtualNodeMLP(emb_dim, device=device)
                                         for _ in range(num_layer - 1))

    def init_from(self, gen):
        if self.virtual_node:
            nn.init.zeros_(self.virtualnode_embedding)

    def forward(self, batch) -> torch.Tensor:
        """[N, F] atom features -> [N, 2*emb_dim] (JK=cat of the encoder
        output, with the first virtual-node add, and the last layer)."""
        mask = batch.node_mask[:, None]
        h_list = [self.atom_encoder(batch.node_feat).masked_fill(~mask, 0.0)]
        if self.virtual_node:
            vn = self.virtualnode_embedding.expand(batch.num_graph_slots, -1)
        for layer in range(self.num_layer):
            if self.virtual_node:
                h_list[layer] = h_list[layer] + graph_broadcast(vn, batch)
            h = self.convs[layer](batch, h_list[layer])
            h = self.batch_norms[layer](h, batch.node_mask)
            if layer < self.num_layer - 1:
                h = torch.relu(h)
            h_list.append(h)
            if self.virtual_node and layer < self.num_layer - 1:
                pooled = graph_sum(h_list[layer], batch)
                vn = self.vn_mlps[layer](pooled + vn, batch.graph_mask)
        out = torch.cat([h_list[0], h_list[-1]], dim=-1)
        return out.masked_fill(~mask, 0.0)
