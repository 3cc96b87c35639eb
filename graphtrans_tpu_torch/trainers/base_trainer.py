"""Baseline trainer: one train step (forward in train mode -> loss ->
backward -> clip -> AdamW -> schedule) and the host-side epoch loop
(counterpart of ``graphtrans_tpu/trainers/base_trainer.py:91-166``).

The step returns its loss as a device tensor and the loop takes the epoch
mean at the end, so no step waits for the card on a ``.item()``. Degenerate
batches (<= 1 valid node or <= 1 valid graph) are skipped for BatchNorm's
sake, checked on the host numpy batch before it is copied to the card."""

from __future__ import annotations

from typing import Callable, Iterable, Optional

import numpy as np
import torch


def make_train_step(model: torch.nn.Module, loss_fn: Callable, optimizer,
                    gen) -> Callable:
    """``step(batch) -> loss`` (a 0-d device tensor) for a batch already on
    the model's device; ``gen`` is the run's ``nn.dropout.Generators``."""

    def step(batch):
        model.train()
        optimizer.zero_grad()
        loss = loss_fn(model(batch, gen), batch)
        loss.backward()
        optimizer.step()
        return loss.detach()

    return step


def train(step: Callable, loader: Iterable, device,
          stats: Optional[dict] = None) -> float:
    """One epoch over the host batches of ``loader``; returns the mean
    loss (0.0 for an epoch without a step). ``stats`` gathers the steps
    taken and the graphs they trained on."""
    losses = []
    for batch in loader:
        n_nodes = int(np.asarray(batch.node_mask).sum())
        n_graphs = int(np.asarray(batch.graph_mask).sum())
        if n_nodes <= 1 or n_graphs <= 1:
            continue
        if stats is not None:
            stats["steps"] = stats.get("steps", 0) + 1
            stats["graphs"] = stats.get("graphs", 0) + n_graphs
        losses.append(step(batch.to(device)))
    if not losses:
        return 0.0
    return float(torch.stack(losses).double().mean())
