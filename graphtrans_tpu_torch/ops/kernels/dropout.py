"""K11: byte-threshold dropout with the mask drawn inside the kernel, and
its backward (the same kernel on the cotangent).

x (any rank, last dim C a multiple of 128) is viewed as ``[R, C]`` over its
last axis and cut into programs of ``br = min(1024, max(8, ceil8(R)))``
rows, as the JAX kernel's grid cuts it. Element (row, col) of program ``p =
row // br`` is kept iff ``hash_bits((row % br)*C + col, seed + p) >> 24 >=
t`` (int32 wrap-around of the seed), and a survivor is scaled by ``1/(1 -
t/256)``: rate ``t/256`` quantised as ``ByteDropout`` quantises it, with
the bytes the JAX kernel draws in interpret mode
(``graphtrans_tpu/ops/pallas/prng.py:random_bytes_u8``). The mask is never
stored: the backward draws it again from the seed.

Replaces ``graphtrans_tpu/ops/pallas/dropout.py:byte_dropout`` (forward and
backward ``_apply``, ``pallas_call`` at ``:74``). The JAX package measured
it as a standalone pass slower than XLA's fused mask on the TPU and keeps
it behind a switch that is off by default; so does the port
(``nn/dropout.py:FUSED``).

What bounds it on the H100: memory. It reads x and writes the result, 8
bytes an element (2.1 GB at the FF activation of 513 x 1001 tokens x 512,
~0.63 ms at 3.35 TB/s), while the hash costs ~12 integer operations an
element. Design (``csrc/dropout.cu``): one thread per four elements, one
16-byte load and store each, grid-stride over the tensor.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .attention_packed import _stream, hash_bits

BR = 1024   # the JAX kernel's rows a program


def program_rows(R: int) -> int:
    """The rows of one program (one mask seed) for a view of R rows."""
    return min(BR, max(8, -(-R // 8) * 8))


def byte_keep(R: int, C: int, seed: int, t: int, device) -> torch.Tensor:
    """Bool [R, C]: the element is kept (drawn with torch on ``device``)."""
    br = program_rows(R)
    row = torch.arange(R, device=device)[:, None]
    col = torch.arange(C, device=device)[None, :]
    pos = (row % br) * C + col
    s = (seed % 2**32 + row // br) & 0xFFFFFFFF
    return (hash_bits(pos, s) >> 24) >= t


def byte_dropout_plain(x: torch.Tensor, seed: int, t: int) -> torch.Tensor:
    """Plain PyTorch version of K11: the same mask and scale; autograd
    differentiates it (the same mask on the cotangent)."""
    C = x.shape[-1]
    keep = byte_keep(x.numel() // C, C, seed, t, x.device).reshape(x.shape)
    scale = 1.0 / (1.0 - t / 256.0)
    return torch.where(keep, x * scale, torch.zeros_like(x))


def _check(x, t):
    if x.dim() < 1 or x.shape[-1] % 128:
        raise ValueError(f"byte_dropout: last dim of {tuple(x.shape)} is not "
                         f"a multiple of 128")
    if not 0 < t < 256:
        raise ValueError(f"byte_dropout: threshold {t} not in [1, 255]")
    if x.dtype != torch.float32 or not x.is_contiguous():
        raise ValueError("byte_dropout: expected contiguous float32")
    if x.data_ptr() % 16:
        raise ValueError("byte_dropout: x must be 16-byte aligned (the "
                         "kernel loads four floats at a time)")


def _launch(x: torch.Tensor, seed: int, t: int) -> torch.Tensor:
    _check(x, t)
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    C = x.shape[-1]
    R = x.numel() // C
    seed32 = (int(seed) + 2**31) % 2**32 - 2**31    # the int32 it wraps to
    lib = _load()
    err = lib.byte_dropout_fwd(
        ctypes.c_void_p(x.data_ptr()), ctypes.c_void_p(out.data_ptr()), R, C,
        program_rows(R), seed32, t, ctypes.c_float(1.0 / (1.0 - t / 256.0)),
        _stream(x))
    _build.check(lib, err, "byte_dropout_fwd")
    byte_dropout.launches += 1
    return out


class _ByteDropout(torch.autograd.Function):
    """K11 on CUDA tensors; its backward is the kernel on the cotangent."""

    @staticmethod
    def forward(ctx, x, seed, t):
        ctx.args = (seed, t)
        return _launch(x, seed, t)

    @staticmethod
    def backward(ctx, g):
        return _launch(g.contiguous(), *ctx.args), None, None


def byte_dropout(x: torch.Tensor, seed: int, t: int) -> torch.Tensor:
    """K11: dropout of x (last dim % 128 == 0) with keep probability ``1 -
    t/256``, the mask drawn from ``seed``. CPU tensors take
    ``byte_dropout_plain``; CUDA tensors launch the kernel or raise, and
    where a gradient is wanted the result's backward launches it on the
    cotangent (each launch counts)."""
    if x.device.type == "cpu":
        return byte_dropout_plain(x, seed, t)
    if x.device.type != "cuda":
        raise ValueError(f"byte_dropout: unsupported device {x.device}")
    if torch.is_grad_enabled() and x.requires_grad:
        return _ByteDropout.apply(x, seed, t)
    return _launch(x, seed, t)


byte_dropout.launches = 0


def _load():
    lib = _build.load("dropout")
    if lib.byte_dropout_fwd.argtypes is None:
        lib.byte_dropout_fwd.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_long, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float,
            ctypes.c_void_p]
        lib.byte_dropout_fwd.restype = ctypes.c_int
    return lib
