"""Prediction head (counterpart of ``graphtrans_tpu/models/heads.py``): one
linear layer from the pooled graph embedding to the task logits. The module
and its layer are both named ``head`` there (flax path ``head/head``), and
so here. The per-position sequence heads of ogbg-code2 and PNA's MLP head
arrive with later slices."""

from __future__ import annotations

import torch
from torch import nn


class PredictionHead(nn.Module):
    def __init__(self, in_features: int, num_tasks: int, device=None):
        super().__init__()
        self.head = nn.Linear(in_features, num_tasks, device=device)

    def forward(self, h_graph: torch.Tensor) -> torch.Tensor:
        """[G, in_features] -> [G, num_tasks]."""
        return self.head(h_graph)
