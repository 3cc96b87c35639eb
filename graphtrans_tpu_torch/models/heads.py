"""Prediction heads (counterpart of ``graphtrans_tpu/models/heads.py``): one
linear layer from the pooled graph embedding to the task logits (flax path
``head/head``), or for ogbg-code2 one linear layer per target position
(``head/head_0`` .. ``head/head_{L-1}``) stacked to ``[G, L, vocab]``. PNA's
MLP head arrives with a later slice."""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn


class PredictionHead(nn.Module):
    def __init__(self, in_features: int, num_tasks: int,
                 max_seq_len: Optional[int] = None, device=None):
        super().__init__()
        self.max_seq_len = max_seq_len
        if max_seq_len is None:
            self.head = nn.Linear(in_features, num_tasks, device=device)
        else:
            self.heads = nn.ModuleList(
                nn.Linear(in_features, num_tasks, device=device)
                for _ in range(max_seq_len))

    def forward(self, h_graph: torch.Tensor) -> torch.Tensor:
        """[G, in_features] -> [G, num_tasks], or [G, L, num_tasks]."""
        if self.max_seq_len is None:
            return self.head(h_graph)
        return torch.stack([h(h_graph) for h in self.heads], dim=1)
