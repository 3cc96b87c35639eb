"""Byte-mask dropout and the generators that training draws from.

``ByteDropout`` copies ``graphtrans_tpu/nn/dropout.py:ByteDropout``: one
uniform byte per element, kept iff ``byte >= t`` with ``t = round(rate*256)``,
and a kept element scaled by ``1/(1 - t/256)`` (rate 0.3 keeps 179/256),
that scale rounded to x's dtype first, as the JAX module does.
The bytes come from an explicit ``torch.Generator`` on the activation's
device. Rate 0, and eval mode, are exact identities.

With ``FUSED`` set (off by default, as the JAX package's ``_PALLAS_FUSED``:
there the fused kernel measured slower than XLA's fused mask on the TPU), a
tensor whose last dim is a multiple of 128 and which holds at least
``MIN_SIZE`` elements takes K11 (``ops/kernels/dropout.py:byte_dropout``)
instead, which draws the same kind of bytes from a counter hash inside the
kernel and stores no mask; its seed is drawn from the host generator, one
per site per step.

``Generators`` holds the two generators of a training run: ``host`` (CPU)
draws the kernels' dropout seeds as Python ints (K2-K5's one per attention
layer per step, K11's one per site per step; a card generator would cost a
synchronising ``.item()`` each), and ``device`` draws ByteDropout's bytes
where the activations live."""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from ..ops.kernels import byte_dropout, byte_dropout_plain
from ..train.precision import refuse_bf16

FUSED = False          # route large lane-aligned tensors to K11
MIN_SIZE = 1 << 18     # graphtrans_tpu/nn/dropout.py:_PALLAS_MIN_SIZE


@dataclasses.dataclass
class Generators:
    host: torch.Generator
    device: torch.Generator

    @classmethod
    def seeded(cls, seed: int, device) -> "Generators":
        dev = torch.device(device)
        return cls(host=torch.Generator().manual_seed(seed),
                   device=torch.Generator(device=dev).manual_seed(seed))

    def kernel_seed(self) -> int:
        """A kernel's dropout seed in [0, 2**31 - 1), as the JAX package
        draws one (``jax.random.randint(..., 0, 2**31 - 1)``)."""
        return int(torch.randint(0, 2**31 - 1, (1,), generator=self.host))


def fused_route(x: torch.Tensor) -> bool:
    """K11 takes x (``graphtrans_tpu/nn/dropout.py:_pallas_route``)."""
    return (FUSED and x.dim() >= 2 and x.shape[-1] % 128 == 0
            and x.numel() >= MIN_SIZE)


class ByteDropout(nn.Module):
    def __init__(self, rate: float):
        super().__init__()
        self.rate = rate
        self.use_kernel = True

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
        if fused_route(x):
            refuse_bf16(x, "K11 (the fused byte dropout)", "3c")
            fn = byte_dropout if self.use_kernel else byte_dropout_plain
            return fn(x, gen.kernel_seed(), t)
        bits = torch.randint(0, 256, x.shape, dtype=torch.uint8,
                             device=x.device, generator=gen.device)
        scale = 1.0 / (1.0 - t / 256.0)
        if x.dtype == torch.bfloat16:
            # jnp.asarray(scale, x.dtype): in bf16, 1/(1 - 77/256) is
            # 1.4296875, and x * scale is rounded once
            scale = float(torch.tensor(scale, dtype=x.dtype))
        return torch.where(bits >= t, x * scale, torch.zeros_like(x))
