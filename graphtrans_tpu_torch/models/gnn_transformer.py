"""GraphTrans: GNN stack -> linear bridge -> transformer over packed rows ->
CLS readout -> linear head (counterpart of
``graphtrans_tpu/models/gnn_transformer.py``, seq-packed route): GIN on the
strided layout with 128 task logits (molpcba), GCN on the flat layout
with up to three packing tiers and five per-position vocabulary heads
(code2), or GCN without a virtual node on the strided layout, JK=last,
with class logits (NCI1, NCI109). Training mode is ``nn.Module.train()``:
batch-statistics BatchNorm and dropout, whose random draws come from the
``Generators`` passed to ``forward``."""

from __future__ import annotations

from typing import Callable, Optional

import torch
from torch import nn

from ..data import dataset_kind
from ..nn.encoders import ASTNodeEncoder, LinearNodeEncoder, ZeroEdgeEncoder
from ..nn.gnn import GNNNodeEmbedding, gnn_out_dim
from ..nn.transformer import TransformerNodeEncoder
from ..ops.pack import TIER_NAMES, pack_gather
from .heads import PredictionHead


def use_seq_pack(batch, graph_pooling: str, num_encoder_layers: int) -> bool:
    """The packed route covers the production composition: CLS pooling and
    a global encoder on a batch that carries packing fields."""
    return (batch.pack_node is not None and graph_pooling == "cls"
            and num_encoder_layers > 0)


def packed_transformer_stage(encoder: TransformerNodeEncoder,
                             h_node: torch.Tensor, batch,
                             gen=None) -> torch.Tensor:
    """Per packing tier: gather node rows into packed ``[R, W, d]`` rows (a
    zero row for CLS and pad slots; the backward gathers through the tier's
    inverse map) and run the segment-masked encoder; the shared encoder
    runs once per tier. Each graph's CLS slot is read from the concat of
    the tiers, widest first: [N, d] -> [G, d]."""
    N, d = h_node.shape
    src = torch.cat([h_node, h_node.new_zeros(1, d)])
    flats = []
    for name in TIER_NAMES:
        node = getattr(batch, f"{name}_node")
        if node is None:
            break
        R, W = getattr(batch, f"{name}_rows"), getattr(batch, f"{name}_w")
        dense = pack_gather(src, node, getattr(batch, f"{name}_inv"))
        seg = getattr(batch, f"{name}_seg").reshape(R, W)
        cls_mask = (seg >= 0) & (node.reshape(R, W) == N)
        out = encoder(dense.reshape(R, W, d), seg=seg, cls_mask=cls_mask,
                      gen=gen)
        flats.append(out.reshape(R * W, d))
    flat = flats[0] if len(flats) == 1 else torch.cat(flats)
    return flat.index_select(0, batch.pack_cls_slot.long())


class GNNTransformer(nn.Module):
    """``gnn_type`` "gin" (molecules) or "gcn" (with ``node_encoder`` an
    ``ASTNodeEncoder`` for code2, a ``LinearNodeEncoder`` and
    ``edge_encoder`` a ``ZeroEdgeEncoder`` factory for TU);
    ``max_seq_len`` set gives per-position heads and ``[G, max_seq_len,
    num_tasks]`` logits."""

    def __init__(self, num_tasks: int, gnn_num_layer: int, gnn_emb_dim: int,
                 gnn_virtual_node: bool, d_model: int, nhead: int,
                 dim_feedforward: int, num_encoder_layers: int,
                 transformer_norm_input: bool, gnn_dropout: float = 0.0,
                 transformer_dropout: float = 0.0, device=None,
                 gnn_type: str = "gin",
                 node_encoder: Optional[nn.Module] = None,
                 max_seq_len: Optional[int] = None, gnn_JK: str = "cat",
                 edge_encoder: Optional[Callable[[], nn.Module]] = None):
        super().__init__()
        self.gnn_node = GNNNodeEmbedding(gnn_num_layer, gnn_emb_dim,
                                         virtual_node=gnn_virtual_node,
                                         drop_ratio=gnn_dropout,
                                         gnn_type=gnn_type,
                                         node_encoder=node_encoder,
                                         device=device, JK=gnn_JK,
                                         edge_encoder=edge_encoder)
        self.gnn2transformer = nn.Linear(gnn_out_dim(gnn_JK, gnn_emb_dim),
                                         d_model, device=device)
        self.transformer_encoder = TransformerNodeEncoder(
            d_model, nhead, dim_feedforward, num_encoder_layers,
            norm_input=transformer_norm_input, dropout=transformer_dropout,
            device=device)
        self.head = PredictionHead(d_model, num_tasks, max_seq_len,
                                   device=device)
        self.num_encoder_layers = num_encoder_layers

    def forward(self, batch, gen=None) -> torch.Tensor:
        """Logits for a seq-packed batch on the model's device (padding
        graph slots give unread rows). ``gen`` (``nn.dropout.Generators``)
        feeds dropout in training mode."""
        if not use_seq_pack(batch, "cls", self.num_encoder_layers):
            raise NotImplementedError(
                "GraphTrans runs seq-packed batches; its unpacked route "
                "(non-CLS pooling, the masked encoder) arrives with slice 11")
        h_node = self.gnn2transformer(self.gnn_node(batch, gen))
        h_graph = packed_transformer_stage(self.transformer_encoder, h_node,
                                           batch, gen)
        return self.head(h_graph)


# (dataset kind, gnn_type) compositions the port runs: the published
# molpcba, code2 and NCI1 GraphTrans configs
_PORTED = {("mol", "gin"), ("code2", "gcn"), ("tu", "gcn")}
# the transformer options both model types run
_ENCODER = {
    "transformer_activation": ("relu",),
    "num_encoder_layers_masked": (0,),
    "transformer_prenorm": (False,),
    "pos_encoder": (False,),
}
_SUPPORTED = {
    "model_type": ("gnn-transformer",),
    "gnn_JK": ("cat", "last"),
    "graph_pooling": ("cls",),
    "gnn_residual": (False,),
    **_ENCODER,
}


def _check_supported(args, supported: dict):
    for key, ok in supported.items():
        value = getattr(args, key, ok[0])
        if value not in ok:
            raise NotImplementedError(
                f"{key}={value!r} is not ported yet (the port runs "
                f"{key} in {ok})")


def build_gnn_transformer(args, num_tasks: int, device=None,
                          data=None) -> GNNTransformer:
    """The model of a parsed config (``utils/config.py``); ``data`` sizes
    the dataset's encoders: a ``data.code.CodeData`` (code2's node encoder
    and heads) or a ``data.tu.TUData`` (the node-label count). A
    composition outside the ported slices raises NotImplementedError."""
    _check_supported(args, _SUPPORTED)
    kind = dataset_kind(getattr(args, "dataset", "ogbg-molpcba"))
    if (kind, args.gnn_type) not in _PORTED:
        raise NotImplementedError(
            f"gnn_type={args.gnn_type!r} on {kind} is not ported yet (the "
            f"port runs {sorted(_PORTED)})")
    node_encoder = max_seq_len = edge_encoder = None
    if kind == "code2":
        node_encoder = ASTNodeEncoder(args.gnn_emb_dim, data.num_nodetypes,
                                      data.num_nodeattributes, device=device)
        max_seq_len = data.max_seq_len
    elif kind == "tu":
        node_encoder = LinearNodeEncoder(data.num_node_labels,
                                         args.gnn_emb_dim, device=device)
        edge_encoder = lambda: ZeroEdgeEncoder(args.gnn_emb_dim)
    return GNNTransformer(
        num_tasks=num_tasks, gnn_num_layer=args.gnn_num_layer,
        gnn_emb_dim=args.gnn_emb_dim,
        gnn_virtual_node=args.gnn_virtual_node, d_model=args.d_model,
        nhead=args.nhead, dim_feedforward=args.dim_feedforward,
        num_encoder_layers=args.num_encoder_layers,
        transformer_norm_input=args.transformer_norm_input,
        gnn_dropout=getattr(args, "gnn_dropout", 0.0),
        transformer_dropout=getattr(args, "transformer_dropout", 0.0),
        device=device, gnn_type=args.gnn_type, node_encoder=node_encoder,
        max_seq_len=max_seq_len, gnn_JK=args.gnn_JK,
        edge_encoder=edge_encoder)
