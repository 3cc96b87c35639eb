"""Rounding points of the kernels' plain bf16 versions.

A bf16 Pallas kernel of the JAX package computes in float32 from bf16
inputs and rounds to bf16 at a few points of its forward and of its
backward, which are two kernels: where the forward rounds, its backward
does not round the gradient, and the backward rounds gradients that the
forward never formed. A plain version written as float32 autograd marks
those points with these two functions."""

from __future__ import annotations

import torch


class _RoundValue(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dtype):
        return x.to(dtype).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _RoundGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dtype):
        ctx.dtype = dtype
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g.to(ctx.dtype).to(g.dtype), None


def round_value(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """x rounded to ``dtype`` and back (a forward rounding point); the
    gradient passes unrounded."""
    return _RoundValue.apply(x, dtype)


def round_grad(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """x unchanged; its gradient is rounded to ``dtype`` and back (a
    backward rounding point)."""
    return _RoundGrad.apply(x, dtype)
