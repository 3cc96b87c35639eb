"""Padded graph batch container and host-side collation (numpy).

Copy of ``graphtrans_tpu/data/batch.py`` restricted to what the serving path
uses: the flat node/edge/graph fields, the strided ("dense") layout
(``node_stride`` + per-graph edge tables) and one tier of variable-length
sequence packing for the transformer stage. Graph slot ``G-1`` is reserved
as a padding graph; in the strided layout graph ``g`` owns flat node rows
``[g*stride, g*stride + n)``, so ``[N, d]`` node tensors view as
``[G, stride, d]``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np
import torch

from ..ops.pack import build_pack_fields

# collate options of the JAX package that later slices bring over
_LATER = {
    "with_dense_adj": "slice 5 (masked transformer encoder)",
    "bsp_chunks_cap": "slice 3 (flat-layout aggregation, code2)",
    "scatter_free": "slice 3 (flat-layout aggregation, code2)",
    "sfa_eb": "slice 3 (flat-layout aggregation, code2)",
    "sfa_explicit": "slice 3 (flat-layout aggregation, code2)",
    "ell_explicit": "slice 4 (PNA)",
    "seq_pack_w2": "slice 3 (multi-tier packing, code2)",
    "seq_pack_rows2": "slice 3 (multi-tier packing, code2)",
    "seq_pack_w3": "slice 3 (multi-tier packing, code2)",
    "seq_pack_rows3": "slice 3 (multi-tier packing, code2)",
    "max_seq_len": "slice 3 (code2 sequence targets)",
}


@dataclasses.dataclass(frozen=True)
class GraphBatch:
    """A padded batch of graphs. Array fields are numpy arrays after
    ``collate`` and torch tensors after ``.to(device)``.

    Shapes: N node slots, E edge slots, G graph slots, Em edge slots per
    graph in the strided layout, R*W packed transformer slots."""

    node_feat: Any        # [N, F] raw features (int for molecules)
    node_graph: Any       # [N] int32 graph id per node (padding -> G-1)
    node_pos: Any         # [N] int32 column in a dense [G, S] packing
    node_mask: Any        # [N] bool
    node_depth: Any       # [N] int32 (zeros for molecules)
    edge_src: Any         # [E] int32 flat, dst-sorted (padding -> N-1)
    edge_dst: Any         # [E] int32
    edge_attr: Any        # [E, Fe]
    edge_mask: Any        # [E] bool
    graph_mask: Any       # [G] bool
    num_nodes: Any        # [G] int32
    y: Any                # [G, T] float32 or [G] int32
    y_arr: Any            # [G, 0] int32
    graph_ids: Any        # [G] int32 index into the source split (-1 = pad)
    edge_src_dense: Any = None   # [G, Em] int32 graph-local src (pad 0)
    edge_dst_dense: Any = None   # [G, Em] int32 graph-local dst (pad 0)
    edge_mask_dense: Any = None  # [G, Em] bool
    edge_attr_dense: Any = None  # [G, Em, Fe]
    pack_node: Any = None        # [R*W] int32 slot -> flat node row (N = none)
    pack_seg: Any = None         # [R*W] int32 graph id per slot (-1 = pad)
    pack_cls_slot: Any = None    # [G] int32 CLS readout slot per graph
    pack_inv: Any = None         # [N] int32 node -> slot (R*W = absent)
    max_nodes_dense: int = 0
    node_stride: int = 0
    pack_w: int = 0
    pack_rows: int = 0

    @property
    def num_graph_slots(self) -> int:
        return self.graph_mask.shape[0]

    @property
    def num_node_slots(self) -> int:
        return self.node_graph.shape[0]

    def to(self, device) -> "GraphBatch":
        """A copy whose array fields are torch tensors on ``device``."""
        def conv(v):
            if isinstance(v, np.ndarray):
                return torch.from_numpy(np.ascontiguousarray(v)).to(device)
            if isinstance(v, torch.Tensor):
                return v.to(device)
            return v

        return dataclasses.replace(self, **{
            f.name: conv(getattr(self, f.name))
            for f in dataclasses.fields(self)})


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def bucket_size(n: int, multiple: int = 128) -> int:
    """Round ``n`` up to a power of two times ``multiple``, subdivided into
    quarters (1.0x, 1.25x, 1.5x, 1.75x)."""
    n = max(n, 1)
    b = multiple
    while b < n:
        b *= 2
    if b == multiple:
        return b
    lower = b // 2
    for frac in (1.25, 1.5, 1.75):
        cand = _round_up(int(lower * frac), multiple)
        if cand >= n:
            return cand
    return b


def collate(
    graphs: list[dict],
    num_graphs_cap: int,
    num_nodes_cap: int,
    num_edges_cap: int,
    max_input_len: int = 1000,
    num_tasks: int = 1,
    y_dtype: str = "int32",
    dense_cap: Optional[int] = None,
    node_stride: int = 0,
    dense_edge_cap: int = 0,
    seq_pack_w: int = 0,
    seq_pack_rows: int = 0,
    **later,
) -> GraphBatch:
    """Assemble host graph dicts (``x [n,F]``, ``edge_index [2,e]``,
    optional ``edge_attr [e,Fe]`` and ``y``) into one padded GraphBatch.

    Mirrors the reference semantics: graphs longer than ``max_input_len``
    keep their LAST nodes in the transformer packing, and flat edges are
    sorted by destination. ``seq_pack_w > 0`` adds one tier of packed
    transformer rows (``ops/pack.py``)."""
    for name, value in later.items():
        if name not in _LATER:
            raise TypeError(f"collate() got an unexpected argument {name!r}")
        if value:
            raise NotImplementedError(
                f"collate option {name!r} arrives with {_LATER[name]}")
    G, N, E = num_graphs_cap, num_nodes_cap, num_edges_cap
    if len(graphs) > G:
        raise ValueError(f"batch of {len(graphs)} graphs exceeds cap {G}")
    if node_stride > 0:
        if node_stride > max_input_len:
            raise ValueError(f"node_stride {node_stride} exceeds "
                             f"max_input_len {max_input_len}")
        if N != G * node_stride:
            raise ValueError(f"strided layout needs num_nodes_cap == "
                             f"G*stride ({G}*{node_stride}), got {N}")
        if dense_edge_cap <= 0:
            raise ValueError("strided layout requires dense_edge_cap")

    total_nodes = sum(int(g["x"].shape[0]) for g in graphs)
    total_edges = sum(int(g["edge_index"].shape[1]) for g in graphs)
    if node_stride == 0 and total_nodes > N:
        raise ValueError(f"{total_nodes} nodes exceed cap {N}")
    if total_edges > E:
        raise ValueError(f"{total_edges} edges exceed cap {E}")

    feat_dim = graphs[0]["x"].shape[1] if graphs[0]["x"].ndim == 2 else 1
    ea0 = graphs[0].get("edge_attr")
    edge_dim = 0 if ea0 is None else (ea0.shape[1] if ea0.ndim == 2 else 1)
    edge_dtype = np.float32 if ea0 is None else ea0.dtype

    node_feat = np.zeros((N, feat_dim), dtype=graphs[0]["x"].dtype)
    node_graph = np.full((N,), G - 1, dtype=np.int32)
    node_pos = np.zeros((N,), dtype=np.int32)
    node_mask = np.zeros((N,), dtype=bool)
    node_depth = np.zeros((N,), dtype=np.int32)
    edge_src = np.full((E,), N - 1, dtype=np.int32)
    edge_dst = np.full((E,), N - 1, dtype=np.int32)
    edge_attr = np.zeros((E, max(edge_dim, 1)), dtype=edge_dtype)
    edge_mask = np.zeros((E,), dtype=bool)
    graph_mask = np.zeros((G,), dtype=bool)
    num_nodes = np.zeros((G,), dtype=np.int32)
    graph_ids = np.full((G,), -1, dtype=np.int32)
    y_arr = np.zeros((G, 0), dtype=np.int32)
    if y_dtype == "int32":
        y = np.zeros((G,), dtype=np.int32)
    else:
        y = np.full((G, num_tasks), np.nan, dtype=np.float32)

    if node_stride > 0:
        S = node_stride
    elif dense_cap is not None:
        S = min(dense_cap, max_input_len)
    else:
        max_n = max((int(g["x"].shape[0]) for g in graphs), default=1)
        S = min(bucket_size(max_n, 16), max_input_len)

    dense = None
    if node_stride > 0:
        Em = dense_edge_cap
        dense = dict(
            edge_src_dense=np.zeros((G, Em), dtype=np.int32),
            edge_dst_dense=np.zeros((G, Em), dtype=np.int32),
            edge_mask_dense=np.zeros((G, Em), dtype=bool),
            edge_attr_dense=np.zeros((G, Em, max(edge_dim, 1)),
                                     dtype=edge_dtype))

    node_offsets = np.zeros((G,), dtype=np.int64)
    node_off = edge_off = 0
    for i, g in enumerate(graphs):
        n = int(g["x"].shape[0])
        e = int(g["edge_index"].shape[1])
        if node_stride > 0:
            if n > node_stride:
                raise ValueError(f"graph of {n} nodes exceeds stride "
                                 f"{node_stride}")
            if e > dense_edge_cap:
                raise ValueError(f"graph of {e} edges exceeds dense edge cap "
                                 f"{dense_edge_cap}")
            node_off = i * node_stride
        node_offsets[i] = node_off
        node_feat[node_off:node_off + n] = g["x"].reshape(n, -1)
        node_graph[node_off:node_off + n] = i
        node_mask[node_off:node_off + n] = True
        if g.get("node_depth") is not None:
            node_depth[node_off:node_off + n] = g["node_depth"].reshape(-1)
        # keep the LAST min(n, S) nodes, packed from column 0
        n_keep = min(n, S)
        pos = np.full((n,), S, dtype=np.int32)
        pos[n - n_keep:] = np.arange(n_keep, dtype=np.int32)
        node_pos[node_off:node_off + n] = pos

        ei = g["edge_index"]
        edge_src[edge_off:edge_off + e] = ei[0] + node_off
        edge_dst[edge_off:edge_off + e] = ei[1] + node_off
        if edge_dim > 0:
            edge_attr[edge_off:edge_off + e] = g["edge_attr"].reshape(e, -1)
        edge_mask[edge_off:edge_off + e] = True
        if dense is not None:
            dense["edge_src_dense"][i, :e] = ei[0]
            dense["edge_dst_dense"][i, :e] = ei[1]
            dense["edge_mask_dense"][i, :e] = True
            if edge_dim > 0:
                dense["edge_attr_dense"][i, :e] = g["edge_attr"].reshape(e, -1)

        graph_mask[i] = True
        num_nodes[i] = n
        graph_ids[i] = int(g.get("_id", -1))
        gy = g.get("y")
        if gy is not None:
            if y_dtype == "int32":
                y[i] = int(np.asarray(gy).reshape(-1)[0])
            else:
                arr = np.asarray(gy, dtype=np.float32).reshape(-1)
                y[i, :arr.shape[0]] = arr
        node_off += n
        edge_off += e

    # sort flat edges by destination (stable)
    order = np.argsort(edge_dst[:edge_off], kind="stable")
    full_order = np.concatenate([order, np.arange(edge_off, E)])
    edge_src = edge_src[full_order]
    edge_dst = edge_dst[full_order]
    edge_attr = edge_attr[full_order]
    edge_mask = edge_mask[full_order]

    pack = {}
    if seq_pack_w > 0:
        pack = build_pack_fields(num_nodes, graph_mask, node_offsets, N,
                                 seq_pack_w, min(max_input_len,
                                                 seq_pack_w - 1),
                                 seq_pack_rows)
        if pack is None:
            raise ValueError(f"packing overflows the pinned row cap "
                             f"{seq_pack_rows}")

    return GraphBatch(
        node_feat=node_feat, node_graph=node_graph, node_pos=node_pos,
        node_mask=node_mask, node_depth=node_depth, edge_src=edge_src,
        edge_dst=edge_dst, edge_attr=edge_attr, edge_mask=edge_mask,
        graph_mask=graph_mask, num_nodes=num_nodes, y=y, y_arr=y_arr,
        graph_ids=graph_ids, **(dense or {}), **pack, max_nodes_dense=S,
        node_stride=node_stride)
