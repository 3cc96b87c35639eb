"""Baseline trainer: one train step (forward in train mode -> loss ->
backward -> clip -> AdamW -> schedule) and the host-side epoch loop
(counterpart of ``graphtrans_tpu/trainers/base_trainer.py:91-166``).

Under ``--precision bf16`` the forward runs on a bfloat16 copy of the
float32 master parameters (``train/precision.py``, the JAX trainer's
``make_param_cast`` and ``loss_fn``, ``:25-38``, ``:79-104``): the loss,
the gradients, clipping and AdamW stay float32.

The step returns its loss as a device tensor and the loop takes the epoch
mean at the end, so no step waits for the card on a ``.item()``. Degenerate
batches (<= 1 valid node or <= 1 valid graph) are skipped for BatchNorm's
sake, checked on the host numpy batch before it is copied to the card."""

from __future__ import annotations

from typing import Callable, Iterable, Optional

import numpy as np
import torch
from torch.func import functional_call

from ..train.precision import cast_params


def make_train_step(model: torch.nn.Module, loss_fn: Callable, optimizer,
                    gen, precision: str = "f32") -> Callable:
    """``step(batch) -> loss`` (a 0-d float32 device tensor) for a batch
    already on the model's device; ``gen`` is the run's
    ``nn.dropout.Generators``; ``precision`` "f32" or "bf16" (the forward
    on a bfloat16 copy of the parameters, its logits taken by the loss in
    float32)."""
    if precision == "bf16":
        # cuBLAS sums a bf16 product in float32, as the JAX package's
        # preferred_element_type=f32 does, not at its default reduced
        # precision (a process-wide flag, as PyTorch keeps it)
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = (
            False)
    elif precision != "f32":
        raise ValueError(f"precision {precision!r} is not f32 or bf16")

    def forward(batch):
        if precision == "f32":
            return model(batch, gen)
        return functional_call(model, cast_params(model, torch.bfloat16),
                               (batch, gen))

    def step(batch):
        model.train()
        optimizer.zero_grad()
        loss = loss_fn(forward(batch), batch)
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
