"""K5: attention over long unpacked rows (a graph's nodes and its CLS
column, S up to 1001 at code2's ``max_input_len``) with a key-padding or a
segment mask, streaming the keys in tiles with an online softmax; forward.

qkv ``[B, S, 3d]`` is the combined projection output with heads in lanes,
as K2 and K3 take it, so no head transposes surround the kernel; segq and
segk ``[B, S]`` int32. Query i attends key j iff ``segq[i] == segk[j] >=
0``: the key-padding form is segq = 0, segk = valid ? 0 : -1
(``key_padding_segs``), the segment form segq = segk = seg. Scores are
scaled by ``1/sqrt(hd)`` and the output is normalised by ``max(l,
1e-16)``, so a query with no key (a fully masked row) outputs exact zeros.
Output ``[B, S, d]``.

Replaces ``graphtrans_tpu/ops/pallas/flash_attention.py:flash_attention``
and ``flash_attention_seg`` (forward ``_fwd_kernel``), which take per-head
``[B*H, S, hd]`` operands; the tests hold the plain version to them by
reshaping. The backward (``_dq_kernel``, ``_dkv_kernel``) and the dropout,
which draws from the TPU's own PRNG, arrive with the slice that trains the
Transformer-only family: a gradient through the kernel raises.

What bounds it on the H100: operations. At the code2 throughput shape (513
graph rows of S = 1001, d 256, 4 heads of 64) it must read q and write out
for every query and read K and V for the valid keys only (~1.18 GB, ~0.35
ms at 3.35 TB/s), while every query of a row attends that row's valid
keys: 1001 x (kept nodes + CLS) pairs a row, ~62 M pairs, x 4 heads x ~260
f32 flops, ~65 GFLOP, ~0.97 ms at 67 TFLOP/s. Design
(``csrc/flash_attention.cu``): one block per (row, head, 128 queries), one
thread per query with q and the output accumulator in registers; K_h and
V_h stream through shared memory 4096/hd keys at a time (K3's loop), and a
key tile that no query of the block can attend is skipped whole. A graph's
valid keys are a prefix plus the CLS column, so at code2's mean of ~125
nodes most tiles are skipped: without the skip the kernel would do ~8x the
work. Heads of width 32, 64 and 128 are compiled.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .attention_packed import _stream, masked_attention

HEAD_DIMS = (32, 64, 128)     # the head widths the kernel compiles
PLAIN_SCORE_BYTES = 1 << 30   # the plain version's score budget per chunk


def key_padding_segs(key_valid: torch.Tensor):
    """(segq, segk) int32 of the key-padding mask: every query attends the
    valid keys of its row."""
    segk = torch.where(key_valid, 0, -1).to(torch.int32)
    return torch.zeros_like(segk), segk


def flash_attention_plain(qkv: torch.Tensor, segq: torch.Tensor,
                          segk: torch.Tensor, nhead: int) -> torch.Tensor:
    """Plain PyTorch version of K5: the masked softmax of the JAX package
    over whole rows, taken a few rows at a time so the ``[rows, H, S, S]``
    scores stay within ``PLAIN_SCORE_BYTES``."""
    B, S, _ = qkv.shape
    step = max(1, PLAIN_SCORE_BYTES // (nhead * S * S * 4))
    outs = []
    for b0 in range(0, B, step):
        sq = segq[b0:b0 + step].long()
        sk = segk[b0:b0 + step].long()
        mask = ((sq[:, :, None] == sk[:, None, :])
                & (sk >= 0)[:, None, :])[:, None]            # [b, 1, S, S]
        outs.append(masked_attention(qkv[b0:b0 + step], nhead, mask))
    return outs[0] if len(outs) == 1 else torch.cat(outs)


def _check(qkv, segq, segk, nhead):
    B, S, d3 = qkv.shape
    d = d3 // 3
    if d3 % 3 or d % nhead:
        raise ValueError(f"flash_attention: width {d3} is not 3*nhead*hd")
    if d // nhead not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head width {d // nhead}; the "
                         f"kernel is built for {HEAD_DIMS}")
    if qkv.dtype != torch.float32:
        raise ValueError("flash_attention: expected float32 qkv")
    for name, t in (("segq", segq), ("segk", segk)):
        if (t.dtype != torch.int32 or tuple(t.shape) != (B, S)
                or t.device != qkv.device):
            raise ValueError(f"flash_attention: {name} {t.dtype} "
                             f"{tuple(t.shape)} on {t.device} does not "
                             f"match qkv (int32 [B, S])")
    if not all(t.is_contiguous() for t in (qkv, segq, segk)):
        raise ValueError("flash_attention: inputs must be contiguous")
    if qkv.data_ptr() % 16:
        raise ValueError("flash_attention: qkv must be 16-byte aligned (the "
                         "kernel loads K and V four floats at a time)")


def _launch(qkv, segq, segk, nhead):
    B, S, d3 = qkv.shape
    out = torch.empty((B, S, d3 // 3), dtype=qkv.dtype, device=qkv.device)
    if out.numel() == 0:
        return out
    lib = _load()
    err = lib.flash_attention_fwd(
        *(ctypes.c_void_p(t.data_ptr()) for t in (qkv, segq, segk, out)),
        B, S, d3 // 3, nhead, _stream(qkv))
    _build.check(lib, err, "flash_attention_fwd")
    flash_attention.launches += 1
    return out


class _FlashAttention(torch.autograd.Function):
    """K5 on CUDA tensors; its backward kernels are still to port."""

    @staticmethod
    def forward(ctx, qkv, segq, segk, nhead):
        return _launch(qkv, segq, segk, nhead)

    @staticmethod
    def backward(ctx, gout):
        raise NotImplementedError(
            "K5's backward (graphtrans_tpu/ops/pallas/flash_attention.py:326 "
            "dq, :350 dk/dv) arrives with slice 6, training the "
            "Transformer-only model")


def flash_attention(qkv: torch.Tensor, segq: torch.Tensor,
                    segk: torch.Tensor, nhead: int) -> torch.Tensor:
    """K5 forward. CPU tensors take ``flash_attention_plain``; CUDA tensors
    launch the kernel or raise (and a gradient through it raises: no
    backward kernel yet)."""
    if qkv.device.type == "cpu":
        return flash_attention_plain(qkv, segq, segk, nhead)
    if qkv.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {qkv.device}")
    _check(qkv, segq, segk, nhead)
    if torch.is_grad_enabled() and qkv.requires_grad:
        return _FlashAttention.apply(qkv, segq, segk, nhead)
    return _launch(qkv, segq, segk, nhead)


flash_attention.launches = 0


def _load():
    lib = _build.load("flash_attention")
    if lib.flash_attention_fwd.argtypes is None:
        lib.flash_attention_fwd.argtypes = ([ctypes.c_void_p] * 4
                                            + [ctypes.c_int] * 4
                                            + [ctypes.c_void_p])
        lib.flash_attention_fwd.restype = ctypes.c_int
    return lib
