"""Flat node rows to a dense ``[G, S, d]`` batch for the unpacked
transformer route (the forward half of ``graphtrans_tpu/ops/dense.py``,
without its shard and psum contexts, which belong to the parallel modes).

Each graph's kept nodes fill columns ``0 .. n_kept-1`` of its row, in the
order ``data/batch.py:collate`` gave them (``node_pos``): a graph longer
than S keeps its LAST S nodes. Truncated nodes (``node_pos == S``) and
masked nodes land in a trash column S that is sliced off."""

from __future__ import annotations

import torch


def nodes_to_dense(h_node: torch.Tensor, node_graph: torch.Tensor,
                   node_pos: torch.Tensor, node_mask: torch.Tensor,
                   num_graphs: int, max_len: int, node_stride: int = 0):
    """[N, d] node rows -> (dense [G, S, d], valid [G, S] bool), S =
    ``max_len``. In the strided layout with ``node_stride == max_len`` the
    flat rows already are the dense batch: a reshape, no scatter."""
    d = h_node.shape[-1]
    if node_stride > 0 and node_stride == max_len:
        return (h_node.reshape(num_graphs, node_stride, d),
                node_mask.reshape(num_graphs, node_stride))
    width = max_len + 1
    pos = torch.where(node_mask, node_pos.long(), max_len)
    slot = node_graph.long() * width + pos
    # only the trash column takes several writes, and it is sliced off
    dense = h_node.new_zeros(num_graphs * width, d).index_copy(0, slot, h_node)
    valid = torch.zeros(num_graphs * width, dtype=torch.bool,
                        device=h_node.device).index_copy(0, slot, node_mask)
    return (dense.reshape(num_graphs, width, d)[:, :max_len],
            valid.reshape(num_graphs, width)[:, :max_len])
