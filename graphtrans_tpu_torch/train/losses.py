"""Losses (copies of ``graphtrans_tpu/train/losses.py``), masked over valid
graphs: BCE-with-logits on the labelled entries of the molecule datasets,
and ogbg-code2's per-position sequence cross-entropy."""

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


def softmax_cross_entropy(logits: torch.Tensor,
                          labels: torch.Tensor) -> torch.Tensor:
    """``logsumexp(logits) - logits[label]`` over the last axis, in f32."""
    logits = logits.float()
    gold = logits.gather(-1, labels.long()[..., None])[..., 0]
    return torch.logsumexp(logits, dim=-1) - gold


def seq_token_loss(pred: torch.Tensor, batch) -> torch.Tensor:
    """pred [G, L, V] logits, ``batch.y_arr`` [G, L] token ids: the
    cross-entropy of each position averaged over valid graphs, then the
    mean over the L positions (code2, ``code.py:36-47`` of the reference)."""
    L = pred.shape[1]
    ce = softmax_cross_entropy(pred, batch.y_arr)                  # [G, L]
    per_pos = torch.stack([masked_mean(ce[:, i], batch.graph_mask)
                           for i in range(L)])
    return per_pos.sum() / L
