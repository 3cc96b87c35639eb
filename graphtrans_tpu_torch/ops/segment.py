"""Masked segment reductions in plain PyTorch (counterparts of
``graphtrans_tpu/ops/segment.py``; the JAX package runs these in XLA, not
in a kernel). Padded slots carry ``mask`` False and add nothing."""

from __future__ import annotations

from typing import Optional

import torch


def segment_sum(data: torch.Tensor, segment_ids: torch.Tensor,
                num_segments: int,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """out[s] = sum of the rows of ``data`` whose id is s (and mask True)."""
    if mask is not None:
        data = data.masked_fill(~mask.reshape(mask.shape + (1,) * (
            data.dim() - mask.dim())), 0.0)
    out = data.new_zeros((num_segments,) + data.shape[1:])
    return out.index_add_(0, segment_ids.long(), data)


def out_degree(edge_src: torch.Tensor, num_nodes: int,
               edge_mask: Optional[torch.Tensor] = None,
               dtype=torch.float32) -> torch.Tensor:
    """Outgoing edges per node; the reference GCN normalises by the SOURCE
    index's degree + 1."""
    ones = torch.ones(edge_src.shape[0], dtype=dtype, device=edge_src.device)
    return segment_sum(ones, edge_src, num_nodes, edge_mask)
