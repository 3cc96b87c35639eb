"""OGB molecule encoders: one embedding table per categorical feature column,
summed (counterparts of ``graphtrans_tpu/nn/encoders.py``)."""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

# OGB molecule categorical feature cardinalities
# (ogb.utils.features.get_atom_feature_dims / get_bond_feature_dims)
ATOM_FEATURE_DIMS = (119, 4, 12, 12, 10, 6, 6, 2, 2)
BOND_FEATURE_DIMS = (5, 6, 2)


class AtomEncoder(nn.Module):
    def __init__(self, emb_dim: int,
                 feature_dims: Sequence[int] = ATOM_FEATURE_DIMS, device=None):
        super().__init__()
        self.feature_dims = tuple(feature_dims)
        self.embs = nn.ModuleList(nn.Embedding(n, emb_dim, device=device)
                                  for n in self.feature_dims)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: [N, F] int -> [N, emb_dim]; each column is clipped to its
        table."""
        x = x.long()
        out = 0
        for i, n in enumerate(self.feature_dims[:x.shape[-1]]):
            out = out + self.embs[i](x[..., i].clamp(0, n - 1))
        return out


class BondEncoder(nn.Module):
    """Bond tables, consumed by the GIN aggregation kernel directly: the
    per-edge embeddings are looked up inside the kernel and never stored."""

    def __init__(self, emb_dim: int,
                 feature_dims: Sequence[int] = BOND_FEATURE_DIMS, device=None):
        super().__init__()
        self.feature_dims = tuple(feature_dims)
        self.embs = nn.ModuleList(nn.Embedding(n, emb_dim, device=device)
                                  for n in self.feature_dims)

    def tables(self, num_features: int):
        """(concatenated tables [sum(dims), d], dims) for the first
        ``num_features`` feature columns."""
        dims = self.feature_dims[:num_features]
        return torch.cat([self.embs[i].weight for i in range(len(dims))]), dims
