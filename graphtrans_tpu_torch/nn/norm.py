"""Masked BatchNorm over padded node (or graph) rows.

Counterpart of ``graphtrans_tpu/nn/norm.py:MaskedBatchNorm``. Serving runs
in eval mode, which normalises with the running statistics; padded rows are
zeroed again afterwards so the padded-rows-are-zero invariant holds. Batch
statistics over valid rows only come with the training slice."""

from __future__ import annotations

import torch
from torch import nn


class MaskedBatchNorm(nn.Module):
    def __init__(self, features: int, eps: float = 1e-5, device=None):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features, device=device))
        self.bias = nn.Parameter(torch.zeros(features, device=device))
        self.register_buffer("running_mean",
                             torch.zeros(features, device=device))
        self.register_buffer("running_var", torch.ones(features, device=device))

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        if self.training:
            raise NotImplementedError(
                "MaskedBatchNorm batch statistics arrive with the training "
                "slice (slice 2); call .eval()")
        y = ((x - self.running_mean) * torch.rsqrt(self.running_var + self.eps)
             * self.weight + self.bias)
        return y.masked_fill(~mask[:, None], 0.0)
