"""Byte-mask dropout and the generators that training draws from.

``ByteDropout`` copies ``graphtrans_tpu/nn/dropout.py:ByteDropout``: one
uniform byte per element, kept iff ``byte >= t`` with ``t = round(rate*256)``,
and a kept element scaled by ``1/(1 - t/256)`` (rate 0.3 keeps 179/256).
The bytes come from an explicit ``torch.Generator`` on the activation's
device. Rate 0, and eval mode, are exact identities.

``Generators`` holds the two generators of a training run: ``host`` (CPU)
draws one attention-dropout seed per encoder layer per step as a Python int
(K2 draws its mask in the kernel from it; a card generator would cost a
synchronising ``.item()`` per layer), and ``device`` draws ByteDropout's
bytes where the activations live."""

from __future__ import annotations

import dataclasses

import torch
from torch import nn


@dataclasses.dataclass
class Generators:
    host: torch.Generator
    device: torch.Generator

    @classmethod
    def seeded(cls, seed: int, device) -> "Generators":
        dev = torch.device(device)
        return cls(host=torch.Generator().manual_seed(seed),
                   device=torch.Generator(device=dev).manual_seed(seed))

    def attention_seed(self) -> int:
        """A K2 dropout seed in [0, 2**31 - 1), as the JAX package draws
        one per layer (``jax.random.randint(..., 0, 2**31 - 1)``)."""
        return int(torch.randint(0, 2**31 - 1, (1,), generator=self.host))


class ByteDropout(nn.Module):
    def __init__(self, rate: float):
        super().__init__()
        self.rate = rate

    def forward(self, x: torch.Tensor, gen) -> torch.Tensor:
        """``gen`` is the run's ``Generators`` (may be None in eval mode or
        at rate 0)."""
        if not self.training or self.rate == 0.0:
            return x
        t = int(round(self.rate * 256.0))
        if t <= 0:
            return x
        if t >= 256:
            return torch.zeros_like(x)
        if gen is None:
            raise ValueError("ByteDropout in training mode needs the run's "
                             "Generators")
        bits = torch.randint(0, 256, x.shape, dtype=torch.uint8,
                             device=x.device, generator=gen.device)
        scale = 1.0 / (1.0 - t / 256.0)
        return torch.where(bits >= t, x * scale, torch.zeros_like(x))
