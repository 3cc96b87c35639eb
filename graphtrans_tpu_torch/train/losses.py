"""Loss of the molecule datasets (copy of
``graphtrans_tpu/train/losses.py:binary_multitask_loss``): BCE-with-logits
on the labelled entries of valid graphs only."""

from __future__ import annotations

import torch


def masked_mean(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    m = mask.to(x.dtype)
    return (x * m).sum() / m.sum().clamp_min(1.0)


def binary_multitask_loss(pred: torch.Tensor, batch) -> torch.Tensor:
    """pred [G, T] logits; ``batch.y`` [G, T] float with NaN where a task is
    unlabelled; padding graph slots (``graph_mask`` False) count nowhere.
    Numerically stable: ``max(p, 0) - p*y + log1p(exp(-|p|))``."""
    y = batch.y
    is_labeled = (y == y) & batch.graph_mask[:, None]
    y_safe = torch.where(is_labeled, y, torch.zeros_like(y))
    p = pred.float()
    bce = torch.relu(p) - p * y_safe + torch.log1p(torch.exp(-p.abs()))
    return masked_mean(torch.where(is_labeled, bce, torch.zeros_like(bce)),
                       is_labeled)
