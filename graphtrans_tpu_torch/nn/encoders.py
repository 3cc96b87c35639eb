"""Node and edge encoders (counterparts of ``graphtrans_tpu/nn/encoders.py``):
OGB's molecule encoders (one embedding table per categorical feature
column, summed), code2's AST node encoder and linear edge encoder, and the
TU datasets' linear node encoder and zero edge encoder."""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from .init import normal_

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


class ASTNodeEncoder(nn.Module):
    """type_emb(x[:, 0]) + attr_emb(x[:, 1]) + depth_emb(min(depth, 20)),
    tables drawn from N(0, 1)."""

    takes_depth = True
    MAX_DEPTH = 20

    def __init__(self, emb_dim: int, num_nodetypes: int,
                 num_nodeattributes: int, device=None):
        super().__init__()
        self.type_emb = nn.Embedding(num_nodetypes, emb_dim, device=device)
        self.attr_emb = nn.Embedding(num_nodeattributes, emb_dim,
                                     device=device)
        self.depth_emb = nn.Embedding(self.MAX_DEPTH + 1, emb_dim,
                                      device=device)

    def init_from(self, gen):
        for m in (self.type_emb, self.attr_emb, self.depth_emb):
            normal_(m.weight, 1.0, gen)

    def forward(self, x: torch.Tensor, depth: torch.Tensor) -> torch.Tensor:
        x = x.long()
        return (self.type_emb(x[..., 0]) + self.attr_emb(x[..., 1])
                + self.depth_emb(depth.long().clamp(0, self.MAX_DEPTH)))


class LinearEdgeEncoder(nn.Module):
    """code2's augmented edge attributes [E, 2] -> [E, emb_dim], taken in
    the weight's dtype, as TDense takes a float input."""

    def __init__(self, emb_dim: int, device=None):
        super().__init__()
        self.lin = nn.Linear(2, emb_dim, device=device)

    def forward(self, e: torch.Tensor) -> torch.Tensor:
        return self.lin(e.to(self.lin.weight.dtype))


class LinearNodeEncoder(nn.Module):
    """TU node features (one-hot node labels, float) [N, in_dim] ->
    [N, emb_dim], a Linear that takes its input in its weight's dtype (the
    JAX package's TDense casts a float input to its kernel's dtype)."""

    def __init__(self, in_dim: int, emb_dim: int, device=None):
        super().__init__()
        self.lin = nn.Linear(in_dim, emb_dim, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.lin(x.to(self.lin.weight.dtype))


class ZeroEdgeEncoder(nn.Module):
    """The edge "encoder" of datasets without edge features: zeros
    ``[..., emb_dim]`` from the attribute tensor's leading shape, so a
    message is ``relu(x_j)`` as in the reference TU path. No parameters.
    ``GCNConv`` on the strided layout does not call it: K6 takes None for
    these zeros, so the layer makes no ``[G, Em, emb_dim]`` tensor."""

    def __init__(self, emb_dim: int):
        super().__init__()
        self.emb_dim = emb_dim

    def forward(self, e: torch.Tensor) -> torch.Tensor:
        return e.new_zeros(e.shape[:-1] + (self.emb_dim,),
                           dtype=torch.float32)
