"""Weights of the JAX package's GraphTrans model carried into the port.

``load_flax_variables(model, params, batch_stats)`` takes the flax
``params`` and ``batch_stats`` trees as nested dicts of numpy arrays (keys
are flax paths) and fills the port's ``GNNTransformer``. Dense kernels are
stored ``[in, out]`` by flax and ``[out, in]`` by ``nn.Linear``, so they are
transposed; ``in_proj`` is ``[d, 3d]`` with q|k|v in that order, as in
``nn.Linear(d, 3d)``. Every flax leaf must be consumed and every parameter
and buffer of the port set, or it raises.
"""

from __future__ import annotations

import numpy as np
import torch


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

    g = model.gnn_node
    for i in range(len(g.atom_encoder.embs)):
        leaf(f"gnn_node.atom_encoder.embs.{i}.weight", ("node_encoder", f"emb_{i}"))
    for i, conv in enumerate(g.convs):
        c, fc = f"gnn_node.convs.{i}", ("gnn_node", f"conv_{i}")
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
    enc, fe = model.transformer_encoder, ("transformer_encoder",)
    leaf("transformer_encoder.cls_embedding", fe + ("cls_embedding",))
    if enc.norm_input is not None:
        norm("transformer_encoder.norm_input", fe + ("norm_input",))
    norm("transformer_encoder.final_norm", fe + ("final_norm",))
    for i in range(len(enc.layers)):
        p, fp = f"transformer_encoder.layers.{i}", fe + (f"layer_{i}",)
        fa = fp + ("MultiheadSelfAttention_0",)
        leaf(f"{p}.self_attn.in_proj.weight", fa + ("in_proj",), t=True)
        leaf(f"{p}.self_attn.in_proj.bias", fa + ("in_proj_bias",))
        leaf(f"{p}.self_attn.out_proj.weight", fa + ("out_proj",), t=True)
        leaf(f"{p}.self_attn.out_proj.bias", fa + ("out_proj_bias",))
        dense(f"{p}.linear1", fp + ("TDense_0",))
        dense(f"{p}.linear2", fp + ("TDense_1",))
        norm(f"{p}.norm1", fp + ("LayerNorm_0",))
        norm(f"{p}.norm2", fp + ("LayerNorm_1",))
    dense("head.head", ("head", "head"))
    return P


def load_flax_variables(model, params: dict, batch_stats: dict):
    """Copy the flax variables into ``model`` (a ``GNNTransformer``) in
    place and return it."""
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
            arr = np.asarray(leaves[src], np.float32)
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
