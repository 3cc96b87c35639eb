"""Masked BatchNorm over padded node (or graph) rows.

Counterpart of ``graphtrans_tpu/nn/norm.py:MaskedBatchNorm``. In training
mode the statistics come from the valid rows only, with the JAX package's
single-pass formula: biased variance ``max(E[x^2] - E[x]^2, 0)`` normalises,
and the running variance takes the unbiased estimate
``var * cnt / max(cnt - 1, 1)``, at momentum 0.1. In eval
mode the running statistics normalise. Padded rows are zeroed again
afterwards so the padded-rows-are-zero invariant holds. A bfloat16 x (the
bf16 step) is normalised as the JAX module does it: the statistics in
float32 from x, the normalisation in float32 with the bf16 scale and bias
promoted, the result rounded once to x's dtype; the running statistics
are float32 buffers either way."""

from __future__ import annotations

import torch
from torch import nn


MOMENTUM = 0.1  # torch's convention: new = (1 - m) * old + m * batch


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
        if x.dtype == torch.bfloat16:
            return self._forward(x.float(), mask, self.weight.float(),
                                 self.bias.float()).to(x.dtype)
        return self._forward(x, mask, self.weight, self.bias)

    def _forward(self, x, mask, weight, bias):
        if self.training:
            m = mask.to(x.dtype)[:, None]
            cnt = m.sum()
            s1 = (x * m).sum(dim=0)
            s2 = (x * x * m).sum(dim=0)
            cnt_safe = cnt.clamp_min(1.0)
            mean = s1 / cnt_safe
            var = (s2 / cnt_safe - mean * mean).clamp_min(0.0)   # biased
            with torch.no_grad():
                unbiased = var * cnt_safe / (cnt - 1.0).clamp_min(1.0)
                self.running_mean.copy_((1 - MOMENTUM) * self.running_mean
                                        + MOMENTUM * mean)
                self.running_var.copy_((1 - MOMENTUM) * self.running_var
                                       + MOMENTUM * unbiased)
        else:
            mean, var = self.running_mean, self.running_var
        y = (x - mean) * torch.rsqrt(var + self.eps) * weight + bias
        return y.masked_fill(~mask[:, None], 0.0)
