"""The Transformer-only ablation of GraphTrans (``model_type transformer``,
``graphtrans_tpu/models/transformer.py``): no GNN. The node encoder's rows
go into a dense ``[G, S, d]`` batch (``ops/dense.py``), the encoder runs
over unpacked rows with a CLS column appended, and the CLS column is read
out into the prediction head (per-position heads for code2), on the
molecule datasets, ogbg-code2 and the TU datasets. It serves and
trains, in f32 or (``--precision bf16``, under ``--attn_backend auto``)
on a bf16 copy of its parameters, the activations bf16 from the node
encoder on as in the JAX model; pooling other than CLS (the ``NodePool``
zoo) arrives with slice 11."""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..data import dataset_kind
from ..nn.encoders import AtomEncoder, ASTNodeEncoder, LinearNodeEncoder
from ..nn.transformer import TransformerNodeEncoder
from ..ops.dense import nodes_to_dense
from .gnn_transformer import _ENCODER, _check_supported
from .heads import PredictionHead


class TransformerModule(nn.Module):
    def __init__(self, num_tasks: int, node_encoder: nn.Module, d_model: int,
                 nhead: int, dim_feedforward: int, num_encoder_layers: int,
                 max_input_len: int, transformer_norm_input: bool,
                 transformer_dropout: float = 0.0,
                 max_seq_len: Optional[int] = None, device=None):
        super().__init__()
        self.node_encoder = node_encoder
        self.transformer = TransformerNodeEncoder(
            d_model, nhead, dim_feedforward, num_encoder_layers,
            norm_input=transformer_norm_input, dropout=transformer_dropout,
            device=device)
        self.head = PredictionHead(d_model, num_tasks, max_seq_len,
                                   device=device)
        self.max_input_len = max_input_len

    def forward(self, batch, gen=None) -> torch.Tensor:
        """Logits ``[G, num_tasks]`` (or ``[G, L, num_tasks]``) for a batch
        on the model's device (padding graph slots give unread rows).
        ``gen`` (``nn.dropout.Generators``) feeds dropout in training
        mode."""
        if getattr(self.node_encoder, "takes_depth", False):
            h = self.node_encoder(batch.node_feat, batch.node_depth)
        else:
            h = self.node_encoder(batch.node_feat)
        h = h.masked_fill(~batch.node_mask[:, None], 0.0)
        S = min(batch.max_nodes_dense, self.max_input_len)
        dense, valid = nodes_to_dense(h, batch.node_graph, batch.node_pos,
                                      batch.node_mask, batch.num_graph_slots,
                                      S, batch.node_stride)
        return self.head(self.transformer(dense, valid, gen=gen)[:, -1])


def build_transformer(args, num_tasks: int, device=None,
                      data=None) -> TransformerModule:
    """The Transformer-only model of a parsed config. Node encoders are
    sized as the JAX package sizes them: molecules ``AtomEncoder(d_model)``
    and TU ``LinearNodeEncoder(d_model)`` over ``data.num_node_labels``
    (``Transformer.get_emb_dim``); code2 ``ASTNodeEncoder(gnn_emb_dim)``
    always (``graphtrans_tpu/data/code.py:163-171``, a quirk of the
    reference), so there ``gnn_emb_dim`` must equal ``d_model``."""
    _check_supported(args, dict(_ENCODER, model_type=("transformer",)))
    if args.graph_pooling != "cls":
        raise NotImplementedError(
            f"graph_pooling={args.graph_pooling!r} on model_type transformer "
            "arrives with slice 11 (the NodePool zoo); the port runs cls")
    kind = dataset_kind(getattr(args, "dataset", "ogbg-molpcba"))
    max_seq_len = None
    if kind == "code2":
        if args.gnn_emb_dim != args.d_model:
            raise ValueError(
                f"the AST node encoder is sized gnn_emb_dim "
                f"({args.gnn_emb_dim}) and feeds the transformer of width "
                f"d_model ({args.d_model}): they must be equal")
        node_encoder = ASTNodeEncoder(args.gnn_emb_dim, data.num_nodetypes,
                                      data.num_nodeattributes, device=device)
        max_seq_len = data.max_seq_len
    elif kind == "tu":
        node_encoder = LinearNodeEncoder(data.num_node_labels, args.d_model,
                                         device=device)
    else:
        node_encoder = AtomEncoder(args.d_model, device=device)
    return TransformerModule(
        num_tasks=num_tasks, node_encoder=node_encoder, d_model=args.d_model,
        nhead=args.nhead, dim_feedforward=args.dim_feedforward,
        num_encoder_layers=args.num_encoder_layers,
        max_input_len=int(args.max_input_len),
        transformer_norm_input=args.transformer_norm_input,
        transformer_dropout=getattr(args, "transformer_dropout", 0.0),
        max_seq_len=max_seq_len, device=device)
