"""Weights of the JAX package's models carried into the port.

``load_flax_variables(model, params, batch_stats)`` takes the flax
``params`` and ``batch_stats`` trees as nested dicts of numpy arrays (keys
are flax paths) and fills the port's ``GNNTransformer``: the molpcba tree
(atom encoder, GIN convs with bond tables, ``head/head``), the code2 tree
(``node_encoder/{type,attr,depth}_emb``, GCN convs with a linear edge
encoder and ``root_emb``, ``head/head_0..L-1``) or the NCI1 tree
(``node_encoder/TDense_0``, GCN convs whose zero edge encoder has no
parameters, a bridge from JK=last's width); or its Transformer-only
``TransformerModule`` (``node_encoder``, ``transformer/{cls_embedding,
norm_input, layer_i/..., final_norm}``, ``head``). Dense kernels are
stored ``[in, out]`` by flax and ``[out, in]`` by ``nn.Linear``, so they are
transposed; ``in_proj`` is ``[d, 3d]`` with q|k|v in that order, as in
``nn.Linear(d, 3d)``. Every flax leaf must be consumed and every parameter
and buffer of the port set, or it raises.
"""

from __future__ import annotations

import numpy as np
import torch

from ..nn.conv import GCNConv
from ..nn.encoders import ASTNodeEncoder, LinearEdgeEncoder, LinearNodeEncoder


def _flatten(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _plan(model) -> dict:
    """Port state key -> (collection, flax path, transpose)."""
    P = {}

    def leaf(port, path, coll="params", t=False):
        P[port] = (coll, tuple(path), t)

    def dense(port, path):
        leaf(f"{port}.weight", path + ("kernel",), t=True)
        leaf(f"{port}.bias", path + ("bias",))

    def norm(port, path, batch_stats=False):
        leaf(f"{port}.weight", path + ("scale",))
        leaf(f"{port}.bias", path + ("bias",))
        if batch_stats:
            leaf(f"{port}.running_mean", path + ("mean",), "batch_stats")
            leaf(f"{port}.running_var", path + ("var",), "batch_stats")

    def node_encoder(port, enc):
        if isinstance(enc, ASTNodeEncoder):
            for name in ("type_emb", "attr_emb", "depth_emb"):
                leaf(f"{port}.{name}.weight", ("node_encoder", name))
        elif isinstance(enc, LinearNodeEncoder):
            dense(f"{port}.lin", ("node_encoder", "TDense_0"))
        else:
            for i in range(len(enc.embs)):
                leaf(f"{port}.embs.{i}.weight", ("node_encoder", f"emb_{i}"))

    def encoder(port, enc):          # its flax name is the port's
        fe = (port,)
        leaf(f"{port}.cls_embedding", fe + ("cls_embedding",))
        if enc.norm_input is not None:
            norm(f"{port}.norm_input", fe + ("norm_input",))
        norm(f"{port}.final_norm", fe + ("final_norm",))
        for i in range(len(enc.layers)):
            p, fp = f"{port}.layers.{i}", fe + (f"layer_{i}",)
            fa = fp + ("MultiheadSelfAttention_0",)
            leaf(f"{p}.self_attn.in_proj.weight", fa + ("in_proj",), t=True)
            leaf(f"{p}.self_attn.in_proj.bias", fa + ("in_proj_bias",))
            leaf(f"{p}.self_attn.out_proj.weight", fa + ("out_proj",), t=True)
            leaf(f"{p}.self_attn.out_proj.bias", fa + ("out_proj_bias",))
            dense(f"{p}.linear1", fp + ("TDense_0",))
            dense(f"{p}.linear2", fp + ("TDense_1",))
            norm(f"{p}.norm1", fp + ("LayerNorm_0",))
            norm(f"{p}.norm2", fp + ("LayerNorm_1",))

    def head(h):
        if h.max_seq_len is None:
            dense("head.head", ("head", "head"))
        else:
            for i in range(h.max_seq_len):
                dense(f"head.heads.{i}", ("head", f"head_{i}"))

    if not hasattr(model, "gnn_node"):          # the Transformer-only model
        node_encoder("node_encoder", model.node_encoder)
        encoder("transformer", model.transformer)
        head(model.head)
        return P
    g = model.gnn_node
    node_encoder("gnn_node.atom_encoder", g.atom_encoder)
    for i, conv in enumerate(g.convs):
        c, fc = f"gnn_node.convs.{i}", ("gnn_node", f"conv_{i}")
        if isinstance(conv, GCNConv):
            dense(f"{c}.lin", fc + ("TDense_0",))
            if isinstance(conv.edge_encoder, LinearEdgeEncoder):
                dense(f"{c}.edge_encoder.lin",
                      fc + ("edge_encoder", "TDense_0"))
            leaf(f"{c}.root_emb", fc + ("root_emb",))
        else:
            leaf(f"{c}.eps", fc + ("eps",))
            for k in range(len(conv.edge_encoder.embs)):
                leaf(f"{c}.edge_encoder.embs.{k}.weight",
                     fc + ("edge_encoder", f"emb_{k}"))
            dense(f"{c}.lin1", fc + ("TDense_0",))
            norm(f"{c}.mlp_bn", fc + ("mlp_bn",), batch_stats=True)
            dense(f"{c}.lin2", fc + ("TDense_1",))
        norm(f"gnn_node.batch_norms.{i}", ("gnn_node", f"bn_{i}"),
             batch_stats=True)
    if g.virtual_node:
        leaf("gnn_node.virtualnode_embedding",
             ("gnn_node", "virtualnode_embedding"))
        for i in range(len(g.vn_mlps)):
            v, fv = f"gnn_node.vn_mlps.{i}", ("gnn_node", f"vn_mlp_{i}")
            dense(f"{v}.lin1", fv + ("TDense_0",))
            norm(f"{v}.bn1", fv + ("MaskedBatchNorm_0",), batch_stats=True)
            dense(f"{v}.lin2", fv + ("TDense_1",))
            norm(f"{v}.bn2", fv + ("MaskedBatchNorm_1",), batch_stats=True)
    dense("gnn2transformer", ("gnn2transformer",))
    encoder("transformer_encoder", model.transformer_encoder)
    head(model.head)
    return P


def load_flax_variables(model, params: dict, batch_stats: dict):
    """Copy the flax variables into ``model`` (a ``GNNTransformer`` or a
    ``TransformerModule``) in place and return it."""
    leaves = {("params",) + p: v for p, v in _flatten(params)}
    leaves.update({("batch_stats",) + p: v for p, v in _flatten(batch_stats)})
    plan = _plan(model)
    state = model.state_dict()
    unset = sorted(set(state) - set(plan))
    if unset:
        raise KeyError(f"no flax counterpart for port entries {unset}")
    used = set()
    with torch.no_grad():
        for key, (coll, path, transpose) in plan.items():
            src = (coll,) + path
            if src not in leaves:
                raise KeyError(f"flax leaf {'/'.join(src)} missing (for {key})")
            arr = np.array(leaves[src], np.float32)   # a writable copy
            if transpose:
                arr = arr.T
            dst = state[key]
            if tuple(arr.shape) != tuple(dst.shape):
                raise ValueError(f"{'/'.join(src)} has shape {arr.shape}, "
                                 f"{key} needs {tuple(dst.shape)}")
            dst.copy_(torch.from_numpy(np.ascontiguousarray(arr)))
            used.add(src)
    unused = sorted("/".join(k) for k in set(leaves) - used)
    if unused:
        raise KeyError(f"flax leaves left unused: {unused}")
    return model
