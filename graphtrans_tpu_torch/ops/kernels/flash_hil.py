"""K3: segment-masked attention over wide packed rows (the W=1024 tier of
code2), streaming the keys in blocks with an online softmax.

The contract is K2's (``attention_packed.py``) for rows of any width:
qkv ``[R, W, 3d]`` with heads in lanes, seg ``[R, W]`` int32 graph ids (-1 =
padding); query i attends key j iff ``seg[i] == seg[j] >= 0``, scores are
scaled by ``1/sqrt(hd)``, and a padding query, or one whose segment has no
valid key, gives exact zeros. Output ``[R, W, d]``.

Replaces the forward of ``graphtrans_tpu/ops/pallas/flash_hil.py:
flash_hil_seg_qkv`` (``_fwd_kernel``). Its backward (``_dq_kernel``,
``_dkv_kernel``) and attention dropout, whose counter follows flash_hil's
seed schedule ``seed + ((b*H + h)*16384 + qi)*1024 + kc``, arrive with
slice 4 (code2 training); this wrapper raises on ``rate > 0`` and where a
gradient would be needed. The TPU kernel's block-diagonal ``k2`` construct
and its iota lane broadcasts work around Mosaic's 128 lanes at hd=32; the
card works per (row, head) directly.

What bounds it on the H100: memory. It must read qkv and write out,
``R*W*4d*4`` bytes (about 16 MB a W=1024 row at d=128), while the
same-segment pairs need ``4*hd*H`` flops each; a 1024 row holds a few large
graphs, so most of its W x W scores are masked out. Design
(``csrc/flash_hil.cu``): one block per (row, head, 128 queries), one thread
per query with q and the output accumulator in registers; keys stream
through shared memory 128 at a time, and a key block whose segment ids
cannot meet the query block's is skipped whole (segments in a packed row
are contiguous, ``ops/pack.py``). Every output cell has one writer.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .attention_packed import HEAD_DIM, attention_seg_plain

SLICE_TRAINING = "slice 4 (code2 training)"


def flash_hil_seg_plain(qkv: torch.Tensor, seg: torch.Tensor,
                        nhead: int) -> torch.Tensor:
    """Plain PyTorch version of K3: the segment-masked softmax attention of
    K2's plain version, without dropout, over rows of any width."""
    return attention_seg_plain(qkv, seg, nhead)


def _check(qkv, seg, nhead):
    R, W, d3 = qkv.shape
    d = d3 // 3
    if d3 % 3 or d % nhead:
        raise ValueError(f"flash_hil_seg: width {d3} is not 3*nhead*hd")
    if d != nhead * HEAD_DIM:
        raise ValueError(f"flash_hil_seg: head width {d // nhead}; the "
                         f"kernel is built for {HEAD_DIM}")
    if qkv.dtype != torch.float32 or seg.dtype != torch.int32:
        raise ValueError("flash_hil_seg: expected float32 qkv, int32 seg")
    if tuple(seg.shape) != (R, W) or seg.device != qkv.device:
        raise ValueError(f"flash_hil_seg: seg {tuple(seg.shape)} on "
                         f"{seg.device} does not match qkv")
    if not (qkv.is_contiguous() and seg.is_contiguous()):
        raise ValueError("flash_hil_seg: inputs must be contiguous")


def flash_hil_seg(qkv: torch.Tensor, seg: torch.Tensor, nhead: int,
                  rate: float = 0.0) -> torch.Tensor:
    """K3 forward. CPU tensors take ``flash_hil_seg_plain``; CUDA tensors
    launch the kernel or raise. Dropout (``rate > 0``) and gradients arrive
    with slice 4 and raise NotImplementedError here."""
    if rate > 0.0:
        raise NotImplementedError(
            f"flash_hil_seg: attention dropout arrives with {SLICE_TRAINING}")
    if qkv.device.type == "cpu":
        return flash_hil_seg_plain(qkv, seg, nhead)
    if qkv.device.type != "cuda":
        raise ValueError(f"flash_hil_seg: unsupported device {qkv.device}")
    _check(qkv, seg, nhead)
    if torch.is_grad_enabled() and qkv.requires_grad:
        raise NotImplementedError(
            "flash_hil_seg: K3 has no backward kernel yet; gradients through "
            f"wide packed rows arrive with {SLICE_TRAINING}")
    R, W, d3 = qkv.shape
    out = torch.empty((R, W, d3 // 3), dtype=qkv.dtype, device=qkv.device)
    if out.numel() == 0:
        return out
    lib = _load()
    err = lib.flash_hil_fwd(
        ctypes.c_void_p(qkv.data_ptr()), ctypes.c_void_p(seg.data_ptr()),
        ctypes.c_void_p(out.data_ptr()), R, W, d3 // 3, nhead,
        ctypes.c_void_p(torch.cuda.current_stream(qkv.device).cuda_stream))
    _build.check(lib, err, "flash_hil_fwd")
    flash_hil_seg.launches += 1
    return out


flash_hil_seg.launches = 0


def _load():
    lib = _build.load("flash_hil")
    if lib.flash_hil_fwd.argtypes is None:
        lib.flash_hil_fwd.argtypes = ([ctypes.c_void_p] * 3
                                      + [ctypes.c_int] * 4 + [ctypes.c_void_p])
        lib.flash_hil_fwd.restype = ctypes.c_int
    return lib
