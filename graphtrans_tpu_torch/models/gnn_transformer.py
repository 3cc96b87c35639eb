"""GraphTrans: GIN stack -> linear bridge -> transformer over packed rows ->
CLS readout -> linear head (counterpart of
``graphtrans_tpu/models/gnn_transformer.py``, serving path only)."""

from __future__ import annotations

import torch
from torch import nn

from ..nn.gnn import GNNNodeEmbedding
from ..nn.transformer import TransformerNodeEncoder
from ..ops.pack import pack_gather
from .heads import PredictionHead


def use_seq_pack(batch, graph_pooling: str, num_encoder_layers: int) -> bool:
    """The packed route covers the production composition: CLS pooling and
    a global encoder on a batch that carries packing fields."""
    return (batch.pack_node is not None and graph_pooling == "cls"
            and num_encoder_layers > 0)


def packed_transformer_stage(encoder: TransformerNodeEncoder,
                             h_node: torch.Tensor, batch) -> torch.Tensor:
    """Gather node rows into packed ``[R, W, d]`` rows (a zero row for CLS
    and pad slots), run the segment-masked encoder, and read each graph's
    own CLS slot: [N, d] -> [G, d]."""
    N, d = h_node.shape
    R, W = batch.pack_rows, batch.pack_w
    src = torch.cat([h_node, h_node.new_zeros(1, d)])
    dense = pack_gather(src, batch.pack_node).reshape(R, W, d)
    seg = batch.pack_seg.reshape(R, W)
    cls_mask = (seg >= 0) & (batch.pack_node.reshape(R, W) == N)
    out = encoder(dense, seg, cls_mask).reshape(R * W, d)
    return out.index_select(0, batch.pack_cls_slot.long())


class GNNTransformer(nn.Module):
    def __init__(self, num_tasks: int, gnn_num_layer: int, gnn_emb_dim: int,
                 gnn_virtual_node: bool, d_model: int, nhead: int,
                 dim_feedforward: int, num_encoder_layers: int,
                 transformer_norm_input: bool, device=None):
        super().__init__()
        self.gnn_node = GNNNodeEmbedding(gnn_num_layer, gnn_emb_dim,
                                         virtual_node=gnn_virtual_node,
                                         device=device)
        self.gnn2transformer = nn.Linear(2 * gnn_emb_dim, d_model,
                                         device=device)
        self.transformer_encoder = TransformerNodeEncoder(
            d_model, nhead, dim_feedforward, num_encoder_layers,
            norm_input=transformer_norm_input, device=device)
        self.head = PredictionHead(d_model, num_tasks, device=device)
        self.num_encoder_layers = num_encoder_layers

    def forward(self, batch) -> torch.Tensor:
        """Logits [G, num_tasks] for a strided, seq-packed batch on the
        model's device (padding graph slots give unread rows)."""
        if not use_seq_pack(batch, "cls", self.num_encoder_layers):
            raise NotImplementedError(
                "only seq-packed batches take the serving path; the dense "
                "transformer route arrives with slice 3")
        h_node = self.gnn2transformer(self.gnn_node(batch))
        h_graph = packed_transformer_stage(self.transformer_encoder, h_node,
                                           batch)
        return self.head(h_graph)


_SUPPORTED = {
    "model_type": ("gnn-transformer",),
    "gnn_type": ("gin",),
    "gnn_JK": ("cat",),
    "graph_pooling": ("cls",),
    "transformer_activation": ("relu",),
    "gnn_residual": (False,),
    "num_encoder_layers_masked": (0,),
    "transformer_prenorm": (False,),
    "pos_encoder": (False,),
}


def build_gnn_transformer(args, num_tasks: int, device=None) -> GNNTransformer:
    """The model of a parsed config (``utils/config.py``); a composition
    outside this slice raises NotImplementedError."""
    for key, ok in _SUPPORTED.items():
        value = getattr(args, key, ok[0])
        if value not in ok:
            raise NotImplementedError(
                f"{key}={value!r} is not ported yet (slice 1 serves "
                f"{key}={ok[0]!r})")
    return GNNTransformer(
        num_tasks=num_tasks, gnn_num_layer=args.gnn_num_layer,
        gnn_emb_dim=args.gnn_emb_dim,
        gnn_virtual_node=args.gnn_virtual_node, d_model=args.d_model,
        nhead=args.nhead, dim_feedforward=args.dim_feedforward,
        num_encoder_layers=args.num_encoder_layers,
        transformer_norm_input=args.transformer_norm_input, device=device)
