"""K2: segment-masked attention over packed transformer rows (forward).

qkv ``[R, W, 3d]`` is the combined projection output with heads in lanes
(lane c of each d-slice belongs to head ``c // hd``); seg ``[R, W]`` holds
each token's graph id (-1 = padding). Token i attends token j iff
``seg[i] == seg[j] >= 0``; scores are scaled by ``1/sqrt(hd)``, the softmax
subtracts the row max and divides by ``max(sum, 1e-16)``, and a query with
no valid key (seg -1) outputs exact zeros. Output ``[R, W, d]``, same layout.

Replaces ``graphtrans_tpu/ops/pallas/attention_packed.py:
attention_packed_seg_qkv`` (forward, ``_fwd_kernel`` with
``_head_masks_seg`` and ``_probs_all``). The TPU kernel's block-diagonal
"heads-in-lanes" K/V construct works around 128-lane padding of hd=32
heads; on the card the kernel works per (row, head) directly.

What bounds it on the H100: memory. For 923 rows of W=128 at d=128 (4096
molecules) it must move ~242 MB (qkv and seg in, out back; ~72 us at
3.35 TB/s), while the same-segment (query, key) pairs need only ~1.6 GFLOP
of f32 work (~24 us at 67 TFLOP/s off the tensor cores): a row holds
several small graphs, so most of the W x W score matrix is masked out.
Design (``csrc/attention_packed.cu``): one block per (row, head),
one thread per query; K_h, V_h and the row's segment ids are staged in
shared memory and every thread reads them as broadcasts, keeping q and the
output accumulator in registers with an online softmax (one pass over the
keys). Keys of other segments are skipped; nothing but qkv, seg and the
output crosses device memory.
"""

from __future__ import annotations

import ctypes
import math

import torch

from . import _build

W_MAX = 384          # wider packed rows need flash_hil (K3), a later slice
HEAD_DIM = 32        # the head width csrc/attention_packed.cu compiles


def attention_seg_plain(qkv: torch.Tensor, seg: torch.Tensor,
                        nhead: int) -> torch.Tensor:
    """Plain PyTorch version of K2: same arguments, same result."""
    R, W, d3 = qkv.shape
    d = d3 // 3
    hd = d // nhead
    q, k, v = (t.reshape(R, W, nhead, hd).transpose(1, 2)
               for t in qkv.split(d, dim=-1))                 # [R, H, W, hd]
    s = torch.matmul(q, k.transpose(-1, -2)) / math.sqrt(hd)
    seg = seg.long()
    mask = ((seg[:, :, None] == seg[:, None, :])
            & (seg >= 0)[:, None, :])[:, None]               # [R, 1, W, W]
    s = s.masked_fill(~mask, -1e30)
    e = torch.exp(s - s.amax(dim=-1, keepdim=True)).masked_fill(~mask, 0.0)
    p = e / e.sum(dim=-1, keepdim=True).clamp_min(1e-16)
    return torch.matmul(p, v).transpose(1, 2).reshape(R, W, d)


def _check(qkv, seg, nhead):
    R, W, d3 = qkv.shape
    d = d3 // 3
    if d3 % 3 or d % nhead:
        raise ValueError(f"attention_seg: width {d3} is not 3*nhead*hd")
    if d != nhead * HEAD_DIM:
        raise ValueError(f"attention_seg: head width {d // nhead}; the "
                         f"kernel is built for {HEAD_DIM}")
    if W > W_MAX:
        raise ValueError(f"attention_seg: rows of {W} > {W_MAX} tokens")
    if qkv.dtype != torch.float32 or seg.dtype != torch.int32:
        raise ValueError("attention_seg: expected float32 qkv, int32 seg")
    if tuple(seg.shape) != (R, W) or seg.device != qkv.device:
        raise ValueError(f"attention_seg: seg {tuple(seg.shape)} on "
                         f"{seg.device} does not match qkv")
    if not (qkv.is_contiguous() and seg.is_contiguous()):
        raise ValueError("attention_seg: inputs must be contiguous")


def attention_seg(qkv: torch.Tensor, seg: torch.Tensor,
                  nhead: int) -> torch.Tensor:
    """K2 forward. CPU tensors take ``attention_seg_plain``; CUDA tensors
    launch the kernel or raise."""
    if qkv.device.type == "cpu":
        return attention_seg_plain(qkv, seg, nhead)
    if qkv.device.type != "cuda":
        raise ValueError(f"attention_seg: unsupported device {qkv.device}")
    _check(qkv, seg, nhead)
    R, W, d3 = qkv.shape
    out = torch.empty((R, W, d3 // 3), dtype=qkv.dtype, device=qkv.device)
    if out.numel() == 0:
        return out
    lib = _load()
    err = lib.attention_seg_fwd(
        ctypes.c_void_p(qkv.data_ptr()), ctypes.c_void_p(seg.data_ptr()),
        ctypes.c_void_p(out.data_ptr()), R, W, d3 // 3, nhead,
        ctypes.c_void_p(torch.cuda.current_stream(qkv.device).cuda_stream))
    _build.check(lib, err, "attention_seg_fwd")
    attention_seg.launches += 1
    return out


attention_seg.launches = 0


def _load():
    lib = _build.load("attention_packed")
    if lib.attention_seg_fwd.argtypes is None:
        lib.attention_seg_fwd.argtypes = ([ctypes.c_void_p] * 3
                                          + [ctypes.c_int] * 4
                                          + [ctypes.c_void_p])
        lib.attention_seg_fwd.restype = ctypes.c_int
    return lib
