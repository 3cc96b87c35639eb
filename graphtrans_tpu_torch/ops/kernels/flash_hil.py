"""K3: segment-masked attention over wide packed rows (code2's tiers of 512
and 1024 tokens), with attention dropout, and its backward.

The contract is K2's (``attention_packed.py``) for rows of any width:
qkv ``[R, W, 3d]`` with heads in lanes, seg ``[R, W]`` int32 graph ids (-1 =
padding); query i attends key j iff ``seg[i] == seg[j] >= 0``, scores are
scaled by ``1/sqrt(hd)``, and a padding query, or one whose segment has no
valid key, gives exact zeros. Output ``[R, W, d]``; the backward returns
dqkv in the combined ``[R, W, 3d]`` layout, exact zeros on padding tokens.

Dropout at ``rate > 0`` follows torch (normalise by the undropped
denominator, then drop and scale a kept probability by ``1/(1-rate)``) and
follows flash_hil's seed schedule, not K2's: (r, h, i, j) is kept iff
``hash(pos, seed') < keep_threshold(rate)`` with ``seed' = seed + ((r*H +
h)*16384 + i//512)*1024 + j//128`` (int32 wrap-around) and ``pos =
(i%512)*128 + j%128``, the JAX kernel's per-(query block, key block) seeds
at its BQ=512 and BK=128 (``graphtrans_tpu/ops/pallas/flash_hil.py:131``),
hashed as its interpret mode hashes them (``prng.py:_hash_bits_u32``). The
kernels and the plain version draw the same mask; nothing is stored.

Replaces ``graphtrans_tpu/ops/pallas/flash_hil.py:flash_hil_seg_qkv``: the
forward (``_fwd_kernel``) and the backward (``_dq_kernel``,
``_dkv_kernel``, after ``_bwd_rule``'s per-head ``delta = sum(dO * O)``).
The TPU kernel's block-diagonal ``k2`` construct and its iota lane
broadcasts work around Mosaic's 128 lanes at hd=32; the card works per
(row, head) directly.

What bounds it on the H100: operations. It must read qkv and write out,
``R*W*4d*4`` bytes (about 16 MB a W=1024 row at d=128), while the
same-segment pairs need ``4*hd*H`` flops each forward and ``10*hd*H``
backward; a 1024 row holds a few large graphs. At code2's bench512 (R=15,
W=1024, 4 heads of 32) the forward's bound is its products as 3xTF32 on
the tensor cores, about 0.024 ms (0.061 ms at the f32 SIMT peak).

Forward (``csrc/flash_hil.cu``): the long-row forward of
``csrc/attention_fwd.cuh`` that K5 and K2's 384 tier run, under K3's own
kernel with seg as both tag arrays and K3's mask as its dropout policy.
The kernel it replaces ran one thread per query, each key one 32-long
dependent FMA chain from shared memory, and walked 128-key positional
blocks key by key; at code2's serving batch (R=4) its 128 blocks left
the card part idle, and it lost to SDPA. The design: one block of four
warps per (row, head, 64 queries); the keys whose segment meets one of
the tile's are ranked by a block-wide prefix count and gathered 64 at a
time with ``cp.async``; each warp owns 16 query rows whole, their scores,
online softmax and P V in registers, the products as 3xTF32 ``mma.sync``
(f32 accuracy). The launch is ``fwd_geometry``
(``attention_packed.long_fwd_geometry`` at hd 32), which the C entry
checks. Where a gradient is wanted the forward also writes the softmax
statistics m and l ``[R, W, H]``, as every launch with dropout does
(dropout is for training); the serving launch writes none.

The backward is the long-row pair of ``csrc/attention_bwd.cuh`` that K5-bwd
and K9-bwd's long instance run, under K3's own two kernels, with seg as
both tag arrays and K3's mask as its dropout policy. At bench512 its bound
is the pairs' products, ~0.06 ms as 3xTF32 on the tensor cores against
0.16 ms at the f32 SIMT peak. The design: a dq kernel over 64-query tiles
(it also writes delta = dO . O) walks only the keys whose segment meets
one of its queries', gathered 64 at a time by rank; a dk/dv kernel over
chunks of 64 valid keys by rank walks the query tiles whose segments can
meet them. A tile or chunk that straddles segments takes keys of both, and
the pair mask separates them. Each step is a 64 x 64 pair tile staged with
``cp.async``, its products as 3xTF32 ``mma.sync``. Every output cell has
one writer: padding tokens get exact zeros, and a run gives the same bits
every time. The launch is the long backward's
(``attention_smalls.bwd_geometry``'s long instance at hd 32).
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .attention_packed import (HEAD_DIM, Geometry, _stream,
                               attention_seg_plain, keep_threshold,
                               long_fwd_geometry)
from .flash_attention import tile_keep_mask

MASK_BQ, MASK_BK = 512, 128   # the JAX kernel's blocks, which seed its mask


def flash_hil_keep_mask(R: int, W: int, nhead: int, rate: float, seed: int,
                        device=None) -> torch.Tensor:
    """Bool [R, H, W, W]: query i keeps key j of row r, head h, under
    flash_hil's seed schedule (K5's over 512 x 128 tiles)."""
    return tile_keep_mask(torch.arange(R, device=device), W, nhead, rate,
                          seed, MASK_BQ, MASK_BK)


def flash_hil_seg_plain(qkv: torch.Tensor, seg: torch.Tensor, nhead: int,
                        rate: float = 0.0, seed: int = 0) -> torch.Tensor:
    """Plain PyTorch version of K3: K2's plain segment-masked softmax
    attention over rows of any width, with flash_hil's dropout mask;
    autograd differentiates it."""
    keep = None
    if rate > 0.0:
        R, W, _ = qkv.shape
        keep = flash_hil_keep_mask(R, W, nhead, rate, seed, qkv.device)
    return attention_seg_plain(qkv, seg, nhead, rate, keep=keep)


def flash_hil_seg_bwd_plain(qkv, seg, nhead, gout, rate=0.0, seed=0):
    """Plain version of K3's backward: autograd through
    ``flash_hil_seg_plain``. Returns dqkv [R, W, 3d]."""
    with torch.enable_grad():
        leaf = qkv.detach().requires_grad_()
        out = flash_hil_seg_plain(leaf, seg, nhead, rate, seed)
        return torch.autograd.grad(out, leaf, gout)[0]


def _check(qkv, seg, nhead, rate, gout=None):
    R, W, d3 = qkv.shape
    d = d3 // 3
    if d3 % 3 or d % nhead:
        raise ValueError(f"flash_hil_seg: width {d3} is not 3*nhead*hd")
    if d != nhead * HEAD_DIM:
        raise ValueError(f"flash_hil_seg: head width {d // nhead}; the "
                         f"kernel is built for {HEAD_DIM}")
    if not 0.0 <= rate < 1.0:
        raise ValueError(f"flash_hil_seg: dropout rate {rate} not in [0, 1)")
    if qkv.dtype != torch.float32 or seg.dtype != torch.int32:
        raise ValueError("flash_hil_seg: expected float32 qkv, int32 seg")
    if tuple(seg.shape) != (R, W) or seg.device != qkv.device:
        raise ValueError(f"flash_hil_seg: seg {tuple(seg.shape)} on "
                         f"{seg.device} does not match qkv")
    if gout is not None and (gout.dtype != torch.float32
                             or tuple(gout.shape) != (R, W, d)
                             or gout.device != qkv.device):
        raise ValueError(f"flash_hil_seg_bwd: gout {gout.dtype} "
                         f"{tuple(gout.shape)} does not match the output")
    if not all(t.is_contiguous() for t in (qkv, seg, gout) if t is not None):
        raise ValueError("flash_hil_seg: inputs must be contiguous")


def fwd_geometry(R: int, W: int, nhead: int) -> Geometry:
    """K3's forward launch for R rows of W tokens: the long forward's, a
    block of four warps per (row, head, 64 queries)."""
    return long_fwd_geometry(R, W, HEAD_DIM, nhead)


def _dropout_args(rate: float, seed: int):
    on = rate > 0.0
    seed32 = (int(seed) + 2**31) % 2**32 - 2**31   # the int32 it wraps to
    return (int(on), ctypes.c_uint(keep_threshold(rate) if on else 0),
            ctypes.c_float(1.0 / (1.0 - rate)), seed32)


def flash_hil_seg_with_stats(qkv: torch.Tensor, seg: torch.Tensor,
                             nhead: int, rate: float = 0.0, seed: int = 0,
                             stats: bool = True):
    """K3's forward kernel on CUDA tensors: (out [R, W, d], m, l), with the
    softmax statistics m and l [R, W, H] that the backward reads (None,
    None when ``stats`` is False and ``rate`` 0: the serving launch writes
    none; with dropout the kernel always writes them)."""
    _check(qkv, seg, nhead, rate)
    R, W, d3 = qkv.shape
    out = torch.empty((R, W, d3 // 3), dtype=qkv.dtype, device=qkv.device)
    m = l = None
    if stats or rate > 0.0:
        m = torch.empty((R, W, nhead), dtype=torch.float32, device=qkv.device)
        l = torch.empty_like(m)
    if out.numel() == 0:
        return out, m, l
    ptr = lambda t: ctypes.c_void_p(None if t is None else t.data_ptr())
    lib = _load()
    err = lib.flash_hil_fwd(
        ptr(qkv), ptr(seg), ptr(out), ptr(m), ptr(l), R, W, d3 // 3, nhead,
        *_dropout_args(rate, seed), *fwd_geometry(R, W, nhead).args(),
        _stream(qkv))
    _build.check(lib, err, "flash_hil_fwd")
    flash_hil_seg.launches += 1
    return out, m, l


class _FlashHilSeg(torch.autograd.Function):
    """K3 on CUDA tensors with K3's backward kernels as its gradient."""

    @staticmethod
    def forward(ctx, qkv, seg, nhead, rate, seed):
        out, m, l = flash_hil_seg_with_stats(qkv, seg, nhead, rate, seed)
        ctx.save_for_backward(qkv, seg, out, m, l)
        ctx.args = (nhead, rate, seed)
        return out

    @staticmethod
    def backward(ctx, gout):
        qkv, seg, out, m, l = ctx.saved_tensors
        nhead, rate, seed = ctx.args
        return (flash_hil_seg_bwd(qkv, seg, nhead, gout.contiguous(),
                                  (out, m, l), rate, seed),
                None, None, None, None)


def flash_hil_seg(qkv: torch.Tensor, seg: torch.Tensor, nhead: int,
                  rate: float = 0.0, seed: int = 0) -> torch.Tensor:
    """K3 forward with dropout ``rate`` (0 = none) drawn from ``seed``.
    CPU tensors take ``flash_hil_seg_plain``; CUDA tensors launch the
    kernel or raise, and where a gradient is wanted the result carries K3's
    backward kernels (``flash_hil_seg_bwd``)."""
    if qkv.device.type == "cpu":
        return flash_hil_seg_plain(qkv, seg, nhead, rate, seed)
    if qkv.device.type != "cuda":
        raise ValueError(f"flash_hil_seg: unsupported device {qkv.device}")
    if torch.is_grad_enabled() and qkv.requires_grad:
        return _FlashHilSeg.apply(qkv, seg, nhead, rate, seed)
    return flash_hil_seg_with_stats(qkv, seg, nhead, rate, seed,
                                    stats=False)[0]


flash_hil_seg.launches = 0


def flash_hil_seg_bwd(qkv: torch.Tensor, seg: torch.Tensor, nhead: int,
                      gout: torch.Tensor, saved, rate: float = 0.0,
                      seed: int = 0) -> torch.Tensor:
    """K3 backward: dqkv [R, W, 3d] for the cotangent ``gout`` [R, W, d] of
    ``flash_hil_seg(qkv, seg, nhead, rate, seed)``, the dropout mask drawn
    again from ``seed``. ``saved`` is the forward's (out, m, l) from
    ``flash_hil_seg_with_stats``, which the kernels read. CPU tensors take
    ``flash_hil_seg_bwd_plain`` (which ignores ``saved``); CUDA tensors
    launch the dq and dk/dv kernels or raise."""
    if qkv.device.type == "cpu":
        return flash_hil_seg_bwd_plain(qkv, seg, nhead, gout, rate, seed)
    if qkv.device.type != "cuda":
        raise ValueError(f"flash_hil_seg_bwd: unsupported device {qkv.device}")
    _check(qkv, seg, nhead, rate, gout)
    R, W, d3 = qkv.shape
    out, m, l = saved if saved is not None else (None, None, None)
    if not (m is not None and out.shape == gout.shape
            and tuple(m.shape) == tuple(l.shape) == (R, W, nhead)):
        raise ValueError("flash_hil_seg_bwd: needs the forward's (out, m, "
                         "l) from flash_hil_seg_with_stats")
    dqkv = torch.empty_like(qkv)
    if dqkv.numel() == 0:
        return dqkv
    delta = torch.empty_like(m)
    lib = _load()
    err = lib.flash_hil_bwd(
        *(ctypes.c_void_p(t.data_ptr())
          for t in (qkv, seg, out, gout, m, l, delta, dqkv)),
        R, W, d3 // 3, nhead, *_dropout_args(rate, seed), _stream(qkv))
    _build.check(lib, err, "flash_hil_bwd")
    flash_hil_seg_bwd.launches += 1
    return dqkv


flash_hil_seg_bwd.launches = 0


def _load():
    lib = _build.load("flash_hil")
    if lib.flash_hil_fwd.argtypes is None:
        drop = [ctypes.c_int, ctypes.c_uint, ctypes.c_float, ctypes.c_int]
        lib.flash_hil_fwd.argtypes = ([ctypes.c_void_p] * 5
                                      + [ctypes.c_int] * 4 + drop
                                      + [ctypes.c_int] * 8
                                      + [ctypes.c_void_p])
        lib.flash_hil_fwd.restype = ctypes.c_int
        lib.flash_hil_bwd.argtypes = ([ctypes.c_void_p] * 8
                                      + [ctypes.c_int] * 4 + drop
                                      + [ctypes.c_void_p])
        lib.flash_hil_bwd.restype = ctypes.c_int
    return lib
