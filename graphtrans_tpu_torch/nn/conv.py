"""GIN convolution on the strided layout (counterpart of
``graphtrans_tpu/nn/conv.py:GINConv``).

out = MLP((1+eps)*x + sum_{j->i} relu(x_j + bond_emb)), MLP = Linear(d,2d)
-> masked BN -> ReLU -> Linear(2d,d). The aggregation, the bond lookup and
the (1+eps)*x combine all run in kernel K1."""

from __future__ import annotations

import torch
from torch import nn

from ..ops import dense_mp
from .encoders import BondEncoder
from .norm import MaskedBatchNorm


class GINConv(nn.Module):
    def __init__(self, emb_dim: int, device=None):
        super().__init__()
        self.eps = nn.Parameter(torch.zeros(1, device=device))
        self.edge_encoder = BondEncoder(emb_dim, device=device)
        self.lin1 = nn.Linear(emb_dim, 2 * emb_dim, device=device)
        self.mlp_bn = MaskedBatchNorm(2 * emb_dim, device=device)
        self.lin2 = nn.Linear(2 * emb_dim, emb_dim, device=device)
        self.use_kernel = True

    def init_from(self, gen):
        nn.init.zeros_(self.eps)

    def forward(self, batch, h: torch.Tensor) -> torch.Tensor:
        if batch.node_stride <= 0:
            raise NotImplementedError(
                "GINConv on the flat layout arrives with slice 3 (code2)")
        tables, dims = self.edge_encoder.tables(
            batch.edge_attr_dense.shape[-1])
        out = dense_mp.gather_message_scatter_dense_tables(
            h, batch, tables, dims, eps_scale=1.0 + self.eps,
            kernel=self.use_kernel)
        out = torch.relu(self.mlp_bn(self.lin1(out), batch.node_mask))
        return self.lin2(out).masked_fill(~batch.node_mask[:, None], 0.0)
