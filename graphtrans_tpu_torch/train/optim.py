"""Optimizer, learning-rate schedules and gradient clipping (counterpart of
``graphtrans_tpu/train/optim.py``).

AdamW with b1 0.9, b2 0.999, eps 1e-8 and the run's ``--weight_decay``
(given explicitly: torch's default is 0.01, the JAX package's 0). Optional
global-norm clipping with optax's formula (``clip_by_global_norm``): the
gradients are left as they are while ``||g|| < max``, else become
``(g / ||g||) * max``. Schedules:

- ``None``/``plateau``: a constant lr. ``plateau`` is a host-side
  ``PlateauScheduler`` (copied, pure Python) stepped on a valid metric
  after each epoch; evaluation arrives with slice 12, so until then the lr
  stays at ``--lr``, as the JAX package's does until its first plateau
  step;
- ``cosine``: optax's ``cosine_decay_schedule`` (alpha 0) over
  ``epochs * steps_per_epoch`` updates, as a ``LambdaLR`` stepped once per
  update;
- ``onecycle`` arrives with slice 12.
"""

from __future__ import annotations

import math
from typing import Optional

import torch


def clip_by_global_norm_(params, max_norm: float) -> torch.Tensor:
    """Clip the ``.grad`` of ``params`` in place with optax's formula and
    return the global norm (a device tensor: no host sync)."""
    grads = [p.grad for p in params if p.grad is not None]
    norm = torch.sqrt(sum((g * g).sum() for g in grads))
    keep = norm < max_norm
    for g in grads:
        g.copy_(torch.where(keep, g, g / norm * max_norm))
    return norm


class PlateauScheduler:
    """Host-side ReduceLROnPlateau with torch semantics (threshold rel 1e-4)."""

    def __init__(self, init_lr, mode="min", factor=0.5, patience=20,
                 min_lr=1e-4):
        self.lr = init_lr
        self.mode = mode
        self.factor = factor
        self.patience = patience
        self.min_lr = min_lr
        self.best = None
        self.num_bad = 0

    def is_better(self, metric):
        if self.best is None:
            return True
        if self.mode == "min":
            return metric < self.best * (1 - 1e-4)
        return metric > self.best * (1 + 1e-4)

    def step(self, metric) -> float:
        if self.is_better(metric):
            self.best = metric
            self.num_bad = 0
        else:
            self.num_bad += 1
        if self.num_bad > self.patience:
            self.lr = max(self.lr * self.factor, self.min_lr)
            self.num_bad = 0
        return self.lr

    def state_dict(self):
        return {"lr": self.lr, "best": self.best, "num_bad": self.num_bad}

    def load_state_dict(self, d):
        self.lr = d["lr"]
        self.best = d["best"]
        self.num_bad = d["num_bad"]


def cosine_decay(step: int, decay_steps: int, alpha: float = 0.0) -> float:
    """optax.cosine_decay_schedule's factor at update ``step``."""
    t = min(step, decay_steps) / decay_steps
    return (1 - alpha) * 0.5 * (1 + math.cos(math.pi * t)) + alpha


class Optimizer:
    """AdamW + optional clipping + optional per-update schedule, stepped as
    one: ``zero_grad()``, then after ``backward()``, ``step()``."""

    def __init__(self, params, args, steps_per_epoch: int):
        self.params = [p for p in params if p.requires_grad]
        self.grad_clip = args.grad_clip
        self.adamw = torch.optim.AdamW(
            self.params, lr=args.lr, betas=(0.9, 0.999), eps=1e-8,
            weight_decay=args.weight_decay)
        sched = args.scheduler
        self.schedule: Optional[torch.optim.lr_scheduler.LambdaLR] = None
        if sched == "cosine":
            total = max(args.epochs * steps_per_epoch, 1)
            self.schedule = torch.optim.lr_scheduler.LambdaLR(
                self.adamw, lambda s: cosine_decay(s, total))
        elif sched == "onecycle":
            raise NotImplementedError(
                "--scheduler onecycle arrives with slice 12 (trainers)")
        elif sched not in (None, "none", "plateau"):
            raise NotImplementedError(f"scheduler {sched}")

    @property
    def lr(self) -> float:
        return self.adamw.param_groups[0]["lr"]

    def zero_grad(self):
        self.adamw.zero_grad(set_to_none=True)

    def step(self):
        if self.grad_clip:
            with torch.no_grad():
                clip_by_global_norm_(self.params, self.grad_clip)
        self.adamw.step()
        if self.schedule is not None:
            self.schedule.step()


def build_optimizer(model: torch.nn.Module, args,
                    steps_per_epoch: int) -> Optimizer:
    return Optimizer(model.parameters(), args, steps_per_epoch)
