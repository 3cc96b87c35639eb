"""GIN and GCN convolutions (counterparts of ``graphtrans_tpu/nn/conv.py``).

GINConv runs on the strided layout: out = MLP((1+eps)*x + sum_{j->i}
relu(x_j + bond_emb)), MLP = Linear(d,2d) -> masked BN -> ReLU ->
Linear(2d,d); the aggregation, the bond lookup and the (1+eps)*x combine
all run in kernel K1 (in bf16 under the bf16 step, the scale 1+eps
rounded to bf16 first).

GCNConv (OGB's GCN as the reference writes it): x = Linear(h); deg =
out_degree(src) + 1; out = sum_{j->i} deg^-1/2[src] deg^-1/2[dst]
relu(x_j + edge_emb) + relu(x + root_emb)/deg. On the strided layout
(NCI1) the aggregation runs in kernel K6 over each graph's edge slots, with
the degree and the norm from per-graph reductions and gathers
(``dense_mp``); NCI1's zero edge embeddings are not made (K6's emb-less
instance). On the flat layout (code2) it runs in kernel K8 over the
batch's block plans when it carries them and the model's switch is on
(``ops/block_plan.py:set_block_spmm``; the edge encoder then encodes the
attributes in the dst-major plan's chunk order, the norm is gathered per
slot, K8 walks the batch's ``slot_order`` and, where a gradient is
wanted, its dx the batch's ``src_slot_order``, reading the same emb and
norm rows), else in kernel K7 over the
dst-sorted edges (it walks the batch's ``dst_order`` and its backward the
batch's ``src_order``, each made once and shared by every layer): the JAX
package's precedence, strided, then blocked, then flat. The degree, the norm and
the self term are plain PyTorch. Under the bf16 step the flat route runs in
bf16 as the JAX layer does under the cast (``graphtrans_tpu/nn/conv.py:
253-270``): the degree, its inverse square root, the norm and the self
term in x's dtype (a degree above 256 rounds, in both), K7 in bf16 with
float32 sums; the strided and the blocked routes refuse bf16 (slice 10's
part 4).
"""

from __future__ import annotations

import torch
from torch import nn

from ..ops import block_plan, dense_mp
from ..ops.kernels import (blocked_gather_message_scatter,
                           blocked_gather_message_scatter_plain, dst_order,
                           slot_order, spmm, spmm_plain, src_order,
                           src_slot_order)
from ..ops.segment import out_degree
from ..train.precision import refuse_bf16
from .encoders import BondEncoder, ZeroEdgeEncoder
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
        # (1 + eps) in eps's dtype, then float32 (graphtrans_tpu/nn/
        # conv.py:199): under bf16 the scale is rounded to bf16 first
        out = dense_mp.gather_message_scatter_dense_tables(
            h, batch, tables, dims, eps_scale=(1.0 + self.eps).float(),
            kernel=self.use_kernel)
        out = torch.relu(self.mlp_bn(self.lin1(out), batch.node_mask))
        return self.lin2(out).masked_fill(~batch.node_mask[:, None], 0.0)


def bsp_slot_weight(plan, per_node_vals: torch.Tensor,
                    major_is_src: bool) -> torch.Tensor:
    """Per-slot weight [C*EB] of a block plan from per-node values:
    ``vals[src] * vals[dst]`` with both endpoints rebuilt from the plan
    (pad slots read row 0; the kernel's mask kills them)."""
    maj, mnr = block_plan.slot_rows(plan)
    src, dst = (maj, mnr) if major_is_src else (mnr, maj)
    return per_node_vals[src] * per_node_vals[dst]


class GCNConv(nn.Module):
    """``edge_encoder`` maps the batch's ``edge_attr`` (flat; its
    ``edge_attr_bsp_*`` copies on the blocked route) or
    ``edge_attr_dense`` (strided) to ``[..., emb_dim]``
    (``LinearEdgeEncoder`` for code2, ``ZeroEdgeEncoder`` for TU).
    ``block_spmm`` ("off", "on" or "auto", set by ``set_block_spmm``)
    turns the blocked route on."""

    def __init__(self, emb_dim: int, edge_encoder: nn.Module, device=None):
        super().__init__()
        self.lin = nn.Linear(emb_dim, emb_dim, device=device)
        self.edge_encoder = edge_encoder
        self.root_emb = nn.Parameter(torch.zeros(emb_dim, device=device))
        self.use_kernel = True
        self.block_spmm = "off"

    def init_from(self, gen):
        normal_(self.root_emb, 1.0, gen)

    def forward(self, batch, h: torch.Tensor) -> torch.Tensor:
        mask = batch.node_mask[:, None]
        x = self.lin(h).masked_fill(~mask, 0.0)
        if batch.node_stride > 0:
            agg, inv_deg = self._strided(batch, x)
        else:
            deg = out_degree(batch.edge_src, x.shape[0], batch.edge_mask,
                             x.dtype) + 1.0
            dis = deg ** -0.5
            if self.block_spmm != "off" and batch.bsp_fwd is not None:
                agg = self._blocked(batch, x, dis)
            else:
                norm = dis[batch.edge_src.long()] * dis[batch.edge_dst.long()]
                emb = self.edge_encoder(batch.edge_attr).to(x.dtype)
                args = (x, emb, batch.edge_src, batch.edge_dst,
                        batch.edge_mask, norm, "relu_add")
                agg = (spmm(*args, order=src_order(batch),
                            rows=dst_order(batch)) if self.use_kernel
                       else spmm_plain(*args))
            inv_deg = (1.0 / deg)[:, None]
        out = agg + torch.relu(x + self.root_emb) * inv_deg
        return out.masked_fill(~mask, 0.0)

    def _blocked(self, batch, x: torch.Tensor, dis: torch.Tensor):
        """The aggregation [N, d] in K8 over the batch's block plans: the
        edge encoder on the dst-major plan's chunk-ordered attributes and
        the norm per slot, once. Where autograd will want a gradient of x
        or of the encoder, K8's dx walks the src-major plan's
        ``src_slot_order`` and reads those same rows through its
        ``fwd_slot``: no src-major copy is made."""
        refuse_bf16(x, "GCNConv on the blocked route (K8)", "4")
        emb_f = self.edge_encoder(batch.edge_attr_bsp_fwd).to(x.dtype)
        w_f = bsp_slot_weight(batch.bsp_fwd, dis, False)
        grad = torch.is_grad_enabled() and (x.requires_grad
                                            or emb_f.requires_grad)
        plan_b = batch.bsp_bwd if grad else None
        args = (x, emb_f, None, batch.bsp_fwd, plan_b, w_f, None, "relu_add")
        if self.use_kernel:
            return blocked_gather_message_scatter(
                *args, rows=slot_order(batch),
                rows_bwd=src_slot_order(batch) if grad else None)
        return blocked_gather_message_scatter_plain(*args)

    def _strided(self, batch, x: torch.Tensor):
        """(aggregation [N, d] in K6, 1/deg [N, 1]) on the strided layout:
        the degree is a per-graph count over the src slots, the per-edge
        norm gathers deg^-1/2 at src and dst (zero on masked slots). A
        ``ZeroEdgeEncoder``'s zeros are not made: K6 takes None, its
        emb-less instance."""
        refuse_bf16(x, "GCNConv on the strided layout (NCI1: K6)", "4")
        G, Sm = batch.num_graph_slots, batch.node_stride
        src, dst = batch.edge_src_dense, batch.edge_dst_dense
        emask = batch.edge_mask_dense
        deg = dense_mp.dense_degree(src, emask, Sm, x.dtype) + 1.0
        dis = (deg ** -0.5)[..., None]
        norm = (dense_mp.dense_gather(dis, src, emask)
                * dense_mp.dense_gather(dis, dst, emask))[..., 0]
        emb = (None if isinstance(self.edge_encoder, ZeroEdgeEncoder)
               else self.edge_encoder(batch.edge_attr_dense).to(x.dtype))
        agg = dense_mp.gather_message_scatter_dense(
            x, batch, emb, norm, kernel=self.use_kernel)
        return agg, (1.0 / deg).reshape(G * Sm, 1)
