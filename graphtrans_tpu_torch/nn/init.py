"""Random initialisation from an explicit ``torch.Generator``.

The JAX package's ``TDense`` is a plain ``nn.Linear`` here, and its init is
torch's default (weight and bias uniform in +-1/sqrt(fan_in)). Values are
drawn on the CPU from the generator and copied into each parameter, so one
seed gives the same weights on every device."""

from __future__ import annotations

import math

import torch
from torch import nn


def uniform_(t: torch.Tensor, bound: float, gen: torch.Generator):
    with torch.no_grad():
        t.copy_((torch.rand(t.shape, generator=gen) * 2 - 1) * bound)


def normal_(t: torch.Tensor, std: float, gen: torch.Generator):
    with torch.no_grad():
        t.copy_(torch.randn(t.shape, generator=gen) * std)


def xavier_uniform_(t: torch.Tensor, gen: torch.Generator):
    fan_out, fan_in = t.shape
    uniform_(t, math.sqrt(6.0 / (fan_in + fan_out)), gen)


def init_weights(model: nn.Module, gen: torch.Generator) -> nn.Module:
    """Linear layers get torch's default init, embeddings xavier-uniform
    (OGB's encoders), LayerNorms ones/zeros; BatchNorm keeps its
    constructor values. A module with parameters of its own defines
    ``init_from(gen)``, which runs after these defaults."""
    for m in model.modules():
        if isinstance(m, nn.Linear):
            bound = 1.0 / math.sqrt(m.in_features)
            uniform_(m.weight, bound, gen)
            if m.bias is not None:
                uniform_(m.bias, bound, gen)
        elif isinstance(m, nn.Embedding):
            xavier_uniform_(m.weight, gen)
        elif isinstance(m, nn.LayerNorm):
            nn.init.ones_(m.weight)
            nn.init.zeros_(m.bias)
    for m in model.modules():
        if hasattr(m, "init_from"):
            m.init_from(gen)
    return model
