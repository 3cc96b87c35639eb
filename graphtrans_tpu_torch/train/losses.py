"""Losses (copies of ``graphtrans_tpu/train/losses.py``), masked over valid
graphs: BCE-with-logits on the labelled entries of the molecule datasets,
ogbg-code2's per-position sequence cross-entropy, and the TU datasets'
cross-entropy over one class id per graph."""

from __future__ import annotations

from typing import Callable

import torch

from ..data import dataset_kind


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


def classification_loss(pred: torch.Tensor, batch) -> torch.Tensor:
    """pred [G, C] logits, ``batch.y`` [G] int class ids: the mean
    cross-entropy over valid graphs (the TU datasets; the reference's FLAG
    divisor is ignored, as in ``tud.py``)."""
    return masked_mean(softmax_cross_entropy(pred, batch.y), batch.graph_mask)


def seq_token_loss(pred: torch.Tensor, batch) -> torch.Tensor:
    """pred [G, L, V] logits, ``batch.y_arr`` [G, L] token ids: the
    cross-entropy of each position averaged over valid graphs, then the
    mean over the L positions (code2, ``code.py:36-47`` of the reference)."""
    L = pred.shape[1]
    ce = softmax_cross_entropy(pred, batch.y_arr)                  # [G, L]
    per_pos = torch.stack([masked_mean(ce[:, i], batch.graph_mask)
                           for i in range(L)])
    return per_pos.sum() / L


# each dataset kind's loss, as the JAX package's dataset utils choose it
# (``MolUtil``, ``CodeUtil``, ``TUUtil.loss_fn``)
LOSSES = {"mol": binary_multitask_loss, "code2": seq_token_loss,
          "tu": classification_loss}


def dataset_loss(dataset: str) -> Callable:
    """The training loss of ``dataset``: masked BCE on the molecule
    datasets, the per-position sequence loss on ogbg-code2, cross-entropy
    over one class per graph on the TU datasets."""
    return LOSSES[dataset_kind(dataset)]
