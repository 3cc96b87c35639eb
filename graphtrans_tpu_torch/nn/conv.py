"""GIN and GCN convolutions (counterparts of ``graphtrans_tpu/nn/conv.py``).

GINConv runs on the strided layout: out = MLP((1+eps)*x + sum_{j->i}
relu(x_j + bond_emb)), MLP = Linear(d,2d) -> masked BN -> ReLU ->
Linear(2d,d); the aggregation, the bond lookup and the (1+eps)*x combine
all run in kernel K1.

GCNConv runs on the flat layout (OGB's GCN as the reference writes it):
x = Linear(h); deg = out_degree(src) + 1; out = sum_{j->i}
deg^-1/2[src] deg^-1/2[dst] relu(x_j + edge_emb) + relu(x + root_emb)/deg.
The aggregation runs in kernel K7 over the dst-sorted edges (its backward
walks the batch's ``src_order``, shared by every layer); the degree, the
norm and the self term are plain PyTorch.
"""

from __future__ import annotations

import torch
from torch import nn

from ..ops import dense_mp
from ..ops.kernels import spmm, spmm_plain, src_order
from ..ops.segment import out_degree
from .encoders import BondEncoder
from .init import normal_
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
                "GINConv runs on the strided layout only; the port's flat "
                "layout serves GCN (code2)")
        tables, dims = self.edge_encoder.tables(
            batch.edge_attr_dense.shape[-1])
        out = dense_mp.gather_message_scatter_dense_tables(
            h, batch, tables, dims, eps_scale=1.0 + self.eps,
            kernel=self.use_kernel)
        out = torch.relu(self.mlp_bn(self.lin1(out), batch.node_mask))
        return self.lin2(out).masked_fill(~batch.node_mask[:, None], 0.0)


class GCNConv(nn.Module):
    """``edge_encoder`` maps the batch's ``edge_attr`` to ``[E, emb_dim]``
    (``LinearEdgeEncoder`` for code2)."""

    def __init__(self, emb_dim: int, edge_encoder: nn.Module, device=None):
        super().__init__()
        self.lin = nn.Linear(emb_dim, emb_dim, device=device)
        self.edge_encoder = edge_encoder
        self.root_emb = nn.Parameter(torch.zeros(emb_dim, device=device))
        self.use_kernel = True

    def init_from(self, gen):
        normal_(self.root_emb, 1.0, gen)

    def forward(self, batch, h: torch.Tensor) -> torch.Tensor:
        if batch.node_stride > 0:
            raise NotImplementedError(
                "GCNConv runs on the flat layout only; the strided layout "
                "serves GIN (molpcba)")
        mask = batch.node_mask[:, None]
        x = self.lin(h).masked_fill(~mask, 0.0)
        deg = out_degree(batch.edge_src, x.shape[0], batch.edge_mask,
                         x.dtype) + 1.0
        dis = deg ** -0.5
        norm = dis[batch.edge_src.long()] * dis[batch.edge_dst.long()]
        emb = self.edge_encoder(batch.edge_attr).to(x.dtype)
        args = (x, emb, batch.edge_src, batch.edge_dst, batch.edge_mask, norm,
                "relu_add")
        agg = (spmm(*args, order=src_order(batch)) if self.use_kernel
               else spmm_plain(*args))
        out = agg + torch.relu(x + self.root_emb) * (1.0 / deg)[:, None]
        return out.masked_fill(~mask, 0.0)
