"""K2: segment-masked attention over packed transformer rows, with
attention dropout, and its backward; and K4: key-padding attention over
unpacked rows, optionally block-diagonal, forward (``attention_dense``,
below).

qkv ``[R, W, 3d]`` is the combined projection output with heads in lanes
(lane c of each d-slice belongs to head ``c // hd``); seg ``[R, W]`` holds
each token's graph id (-1 = padding). Token i attends token j iff
``seg[i] == seg[j] >= 0``; scores are scaled by ``1/sqrt(hd)``, the softmax
subtracts the row max and divides by ``max(sum, 1e-16)``, and a query with
no valid key (seg -1) outputs exact zeros. Output ``[R, W, d]``, same layout.

Dropout at ``rate > 0`` follows torch: the probabilities are normalised by
the undropped denominator, then a kept one is scaled by ``1/(1-rate)``.
(r, h, i, j) is kept iff ``hash(pos, seed') < uint32((1-rate)*0xFFFFFFFF)``
with ``pos = ((r % bt)*W + i)*sp + j``, ``seed' = seed + (r // bt)*H + h``
(int32 wrap-around), ``sp = ceil(W/128)*128`` and ``bt = 8 if sp <= 128
else 4``: the counter hash and the tiling that the JAX kernel uses in
interpret mode (``graphtrans_tpu/ops/pallas/prng.py:_hash_bits_u32``,
``attention_packed.py:_keep_mask``). The kernels and the plain version draw
the same mask from (seed, r, h, i, j); nothing is stored.

Replaces ``graphtrans_tpu/ops/pallas/attention_packed.py:
attention_packed_seg_qkv``: the forward (``_fwd_kernel`` with
``_head_masks_seg`` and the dropout of ``_probs_all``) and the backward
(``attn_bwd_math``, ``_bwd_kernel``), which returns dqkv in the combined
``[R, W, 3d]`` layout. The TPU kernel's block-diagonal "heads-in-lanes"
K/V construct works around 128-lane padding of hd=32 heads; on the card
the kernels work per (row, head) directly.

What bounds it on the H100: memory. For 923 rows of W=128 at d=128 (4096
molecules) the forward must move ~242 MB (qkv and seg in, out back; ~72 us
at 3.35 TB/s) and the backward ~424 MB (qkv, seg, dO in, dqkv back), while
the same-segment (query, key) pairs need ~1.6 GFLOP forward and ~4 GFLOP
backward of f32 work: a row holds several small graphs, so most of the
W x W score matrix is masked out. Design (``csrc/attention_packed.cu``):
one block per (row, head). Forward: one thread per query; K_h, V_h and the
row's segment ids in shared memory, read as broadcasts; q and the output
accumulator in registers with an online softmax. Backward: Q_h, K_h, V_h
and dO_h in shared memory; a pass with one thread per query recomputes the
softmax statistics and delta and writes dq, then a pass with one thread per
key writes dk and dv. Keys (queries) of other segments are skipped; every
output cell has one writer, so there are no atomics.

K4 replaces ``graphtrans_tpu/ops/pallas/attention_packed.py:
attention_packed_qkv`` (forward ``_call_fwd``, mask ``_head_masks``): qkv
``[B, S, 3d]``, key_valid ``[B, S]``, ``block``; key j is attendable by
query i iff ``key_valid[j]`` and, with ``block > 0``, ``i // block == j //
block``. Unlike K2 a padding query is not masked: it attends its block's
valid keys; only a query whose block has no valid key outputs zeros. Its
main path is the Transformer-only model on molecules, where ``128 // S``
graphs of S tokens share a row and ``block = S`` (1366 rows of 99 at 4096
molecules, d 256, 4 heads of 64). Bound on the H100: memory (q in and out
back for every query, K and V in for the valid keys only: ~503 MB, ~0.15
ms; the same-block pairs need ~3.8 GFLOP). The kernel reads key_valid as
torch's one-byte bool, so no conversion precedes a launch. Design:
K2's forward kernel with the mask as a template policy (``PadMask``); a
query walks only its own block's keys, and K/V of a row of up to 384
tokens sit in dynamic shared memory (196 KB at hd 64). Heads of width 32
and 64. The backward and dropout arrive with the slice that trains the
Transformer-only family.
"""

from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from . import _build

W_MAX = 384          # wider packed rows take flash_hil_seg (K3)
HEAD_DIM = 32        # the head width csrc/attention_packed.cu compiles


def hash_bits(pos: np.ndarray, seed: np.ndarray) -> np.ndarray:
    """u32 counter hash of (position, seed), numpy uint32 arrays (copy of
    the JAX package's interpret-mode stand-in for the TPU PRNG, in the
    arithmetic that wraps as its does)."""
    x = pos * np.uint32(2654435761) + seed * np.uint32(0x9E3779B9)
    x ^= x >> np.uint32(16)
    x *= np.uint32(0x7FEB352D)
    x ^= x >> np.uint32(15)
    x *= np.uint32(0x846CA68B)
    return x ^ (x >> np.uint32(16))


def u32(a) -> np.ndarray:
    """``a`` (ints below 2**32) as a numpy uint32 array."""
    return np.asarray(a, np.uint32)


def dropout_tiling(W: int):
    """(sp, bt): the key block and the rows per tile that index the mask."""
    sp = -(-W // 128) * 128
    return sp, (8 if sp <= 128 else 4)


def keep_threshold(rate: float) -> int:
    """Keep iff bits < this u32 (truncated as numpy truncates)."""
    return int(min(max(1.0 - rate, 0.0), 1.0) * 0xFFFFFFFF)


def keep_mask(R: int, W: int, nhead: int, rate: float, seed: int,
              device) -> torch.Tensor:
    """Bool [R, H, W, W]: query i keeps key j of row r, head h (drawn on
    the host a row at a time)."""
    sp, bt = dropout_tiling(W)
    h = u32(np.arange(nhead))[:, None, None]
    i = u32(np.arange(W))[None, :, None]
    j = u32(np.arange(W))[None, None, :]
    thresh = u32(keep_threshold(rate))
    keep = np.empty((R, nhead, W, W), bool)
    for r in range(R):
        pos = (u32(r % bt) * u32(W) + i) * u32(sp) + j
        keep[r] = hash_bits(pos, h + u32(r // bt * nhead)
                            + u32(seed % 2**32)) < thresh
    return torch.from_numpy(keep).to(device)


def masked_attention(qkv: torch.Tensor, nhead: int, mask: torch.Tensor,
                     rate: float = 0.0, keep=None) -> torch.Tensor:
    """Softmax attention of qkv ``[R, W, 3d]`` (heads in lanes) under the
    bool ``mask`` ``[R, 1, W, W]`` (query, key), as the JAX package's
    ``masked_softmax``: scores scaled by ``1/sqrt(hd)``, the row max
    subtracted, the sum clamped at 1e-16 (a query with no key gets zeros),
    then ``keep`` (bool ``[R, H, W, W]``) dropout at ``rate``. Output
    ``[R, W, d]``."""
    R, W, d3 = qkv.shape
    d = d3 // 3
    hd = d // nhead
    q, k, v = (t.reshape(R, W, nhead, hd).transpose(1, 2)
               for t in qkv.split(d, dim=-1))                 # [R, H, W, hd]
    s = torch.matmul(q, k.transpose(-1, -2)) / math.sqrt(hd)
    s = s.masked_fill(~mask, -1e30)
    e = torch.exp(s - s.amax(dim=-1, keepdim=True).detach()).masked_fill(
        ~mask, 0.0)
    p = e / e.sum(dim=-1, keepdim=True).clamp_min(1e-16)
    if rate > 0.0:
        p = p * keep.to(p.dtype) * (1.0 / (1.0 - rate))
    return torch.matmul(p, v).transpose(1, 2).reshape(R, W, d)


def attention_seg_plain(qkv: torch.Tensor, seg: torch.Tensor, nhead: int,
                        rate: float = 0.0, seed: int = 0,
                        keep=None) -> torch.Tensor:
    """Plain PyTorch version of K2: same arguments, same result (the same
    dropout mask); autograd differentiates it. ``keep`` (bool [R, H, W, W])
    replaces K2's mask at ``rate > 0`` (K3 draws its own)."""
    R, W, _ = qkv.shape
    seg = seg.long()
    mask = ((seg[:, :, None] == seg[:, None, :])
            & (seg >= 0)[:, None, :])[:, None]               # [R, 1, W, W]
    if rate > 0.0 and keep is None:
        keep = keep_mask(R, W, nhead, rate, seed, qkv.device)
    return masked_attention(qkv, nhead, mask, rate, keep)


def attention_seg_bwd_plain(qkv, seg, nhead, gout, rate=0.0, seed=0):
    """Plain version of K2's backward: autograd through
    ``attention_seg_plain``. Returns dqkv [R, W, 3d]."""
    with torch.enable_grad():
        leaf = qkv.detach().requires_grad_()
        out = attention_seg_plain(leaf, seg, nhead, rate, seed)
        return torch.autograd.grad(out, leaf, gout)[0]


def _check(qkv, seg, nhead, rate, gout=None):
    R, W, d3 = qkv.shape
    d = d3 // 3
    if d3 % 3 or d % nhead:
        raise ValueError(f"attention_seg: width {d3} is not 3*nhead*hd")
    if d != nhead * HEAD_DIM:
        raise ValueError(f"attention_seg: head width {d // nhead}; the "
                         f"kernel is built for {HEAD_DIM}")
    if W > W_MAX:
        raise ValueError(f"attention_seg: rows of {W} > {W_MAX} tokens")
    if not 0.0 <= rate < 1.0:
        raise ValueError(f"attention_seg: dropout rate {rate} not in [0, 1)")
    if qkv.dtype != torch.float32 or seg.dtype != torch.int32:
        raise ValueError("attention_seg: expected float32 qkv, int32 seg")
    if tuple(seg.shape) != (R, W) or seg.device != qkv.device:
        raise ValueError(f"attention_seg: seg {tuple(seg.shape)} on "
                         f"{seg.device} does not match qkv")
    if gout is not None and (gout.dtype != torch.float32
                             or tuple(gout.shape) != (R, W, d)
                             or gout.device != qkv.device):
        raise ValueError(f"attention_seg_bwd: gout {gout.dtype} "
                         f"{tuple(gout.shape)} does not match the output")
    if not all(t.is_contiguous() for t in (qkv, seg, gout) if t is not None):
        raise ValueError("attention_seg: inputs must be contiguous")


def _dropout_args(W: int, rate: float, seed: int):
    sp, bt = dropout_tiling(W)
    on = rate > 0.0
    # the seed as the int32 it wraps to in the reference
    seed32 = (int(seed) + 2**31) % 2**32 - 2**31
    return (int(on), ctypes.c_uint(keep_threshold(rate) if on else 0),
            ctypes.c_float(1.0 / (1.0 - rate)), seed32, bt, sp)


def _stream(t: torch.Tensor):
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def _launch_fwd(qkv, seg, nhead, rate, seed):
    R, W, d3 = qkv.shape
    out = torch.empty((R, W, d3 // 3), dtype=qkv.dtype, device=qkv.device)
    if out.numel() == 0:
        return out
    lib = _load()
    err = lib.attention_seg_fwd(
        ctypes.c_void_p(qkv.data_ptr()), ctypes.c_void_p(seg.data_ptr()),
        ctypes.c_void_p(out.data_ptr()), R, W, d3 // 3, nhead,
        *_dropout_args(W, rate, seed), _stream(qkv))
    _build.check(lib, err, "attention_seg_fwd")
    attention_seg.launches += 1
    return out


class _AttentionSeg(torch.autograd.Function):
    """K2 on CUDA tensors with K2's backward kernel as its gradient."""

    @staticmethod
    def forward(ctx, qkv, seg, nhead, rate, seed):
        ctx.save_for_backward(qkv, seg)
        ctx.args = (nhead, rate, seed)
        return _launch_fwd(qkv, seg, nhead, rate, seed)

    @staticmethod
    def backward(ctx, gout):
        qkv, seg = ctx.saved_tensors
        nhead, rate, seed = ctx.args
        return (attention_seg_bwd(qkv, seg, nhead, gout.contiguous(), rate,
                                  seed), None, None, None, None)


def attention_seg(qkv: torch.Tensor, seg: torch.Tensor, nhead: int,
                  rate: float = 0.0, seed: int = 0) -> torch.Tensor:
    """K2 forward with dropout ``rate`` (0 = none) drawn from ``seed``.
    CPU tensors take ``attention_seg_plain``; CUDA tensors launch the
    kernel or raise, and where a gradient is wanted the result carries K2's
    backward kernel (``attention_seg_bwd``)."""
    if qkv.device.type == "cpu":
        return attention_seg_plain(qkv, seg, nhead, rate, seed)
    if qkv.device.type != "cuda":
        raise ValueError(f"attention_seg: unsupported device {qkv.device}")
    _check(qkv, seg, nhead, rate)
    if torch.is_grad_enabled() and qkv.requires_grad:
        return _AttentionSeg.apply(qkv, seg, nhead, rate, seed)
    return _launch_fwd(qkv, seg, nhead, rate, seed)


attention_seg.launches = 0


def attention_seg_bwd(qkv: torch.Tensor, seg: torch.Tensor, nhead: int,
                      gout: torch.Tensor, rate: float = 0.0,
                      seed: int = 0) -> torch.Tensor:
    """K2 backward: dqkv [R, W, 3d] for the cotangent ``gout`` [R, W, d]
    of ``attention_seg(qkv, seg, nhead, rate, seed)``, the dropout mask
    drawn again from ``seed``. CPU tensors take
    ``attention_seg_bwd_plain``; CUDA tensors launch the kernel or raise."""
    if qkv.device.type == "cpu":
        return attention_seg_bwd_plain(qkv, seg, nhead, gout, rate, seed)
    if qkv.device.type != "cuda":
        raise ValueError(f"attention_seg_bwd: unsupported device {qkv.device}")
    _check(qkv, seg, nhead, rate, gout)
    R, W, d3 = qkv.shape
    dqkv = torch.empty_like(qkv)
    if dqkv.numel() == 0:
        return dqkv
    lib = _load()
    err = lib.attention_seg_bwd(
        ctypes.c_void_p(qkv.data_ptr()), ctypes.c_void_p(seg.data_ptr()),
        ctypes.c_void_p(gout.data_ptr()), ctypes.c_void_p(dqkv.data_ptr()),
        R, W, d3 // 3, nhead, *_dropout_args(W, rate, seed), _stream(qkv))
    _build.check(lib, err, "attention_seg_bwd")
    attention_seg_bwd.launches += 1
    return dqkv


attention_seg_bwd.launches = 0


# ---- K4: key-padding attention, optionally block-diagonal -----------------

DENSE_HEAD_DIMS = (32, 64)   # the head widths attention_dense_fwd compiles


def attention_dense_plain(qkv: torch.Tensor, key_valid: torch.Tensor,
                          nhead: int, block: int = 0) -> torch.Tensor:
    """Plain PyTorch version of K4: key j is attendable by query i iff
    ``key_valid[j]`` and, with ``block > 0``, ``i // block == j // block``.
    A padding query attends its block's valid keys; a query whose block
    has no valid key gets exact zeros."""
    S = qkv.shape[1]
    mask = key_valid.bool()[:, None, None, :]                 # [B, 1, 1, S]
    if block > 0:
        grp = torch.arange(S, device=qkv.device) // block
        mask = mask & (grp[:, None] == grp[None, :])
    return masked_attention(qkv, nhead, mask.expand(-1, 1, S, S))


def _check_dense(qkv, key_valid, nhead, block):
    B, S, d3 = qkv.shape
    d = d3 // 3
    if d3 % 3 or d % nhead:
        raise ValueError(f"attention_dense: width {d3} is not 3*nhead*hd")
    if d // nhead not in DENSE_HEAD_DIMS:
        raise ValueError(f"attention_dense: head width {d // nhead}; the "
                         f"kernel is built for {DENSE_HEAD_DIMS}")
    if S > W_MAX:
        raise ValueError(f"attention_dense: rows of {S} > {W_MAX} tokens")
    if block < 0:
        raise ValueError(f"attention_dense: block {block} < 0")
    if qkv.dtype != torch.float32 or key_valid.dtype != torch.bool:
        raise ValueError("attention_dense: expected float32 qkv, bool "
                         "key_valid")
    if tuple(key_valid.shape) != (B, S) or key_valid.device != qkv.device:
        raise ValueError(f"attention_dense: key_valid "
                         f"{tuple(key_valid.shape)} on {key_valid.device} "
                         f"does not match qkv")
    if not qkv.is_contiguous():
        raise ValueError("attention_dense: qkv must be contiguous")


def _launch_dense(qkv, key_valid, nhead, block):
    B, S, d3 = qkv.shape
    out = torch.empty((B, S, d3 // 3), dtype=qkv.dtype, device=qkv.device)
    if out.numel() == 0:
        return out
    valid = key_valid.contiguous()     # the bool itself: one byte a key
    lib = _load()
    err = lib.attention_dense_fwd(
        ctypes.c_void_p(qkv.data_ptr()), ctypes.c_void_p(valid.data_ptr()),
        ctypes.c_void_p(out.data_ptr()), B, S, d3 // 3, nhead, block,
        _stream(qkv))
    _build.check(lib, err, "attention_dense_fwd")
    attention_dense.launches += 1
    return out


class _AttentionDense(torch.autograd.Function):
    """K4 on CUDA tensors; its backward kernel is still to port."""

    @staticmethod
    def forward(ctx, qkv, key_valid, nhead, block):
        return _launch_dense(qkv, key_valid, nhead, block)

    @staticmethod
    def backward(ctx, gout):
        raise NotImplementedError(
            "K4's backward (graphtrans_tpu/ops/pallas/attention_packed.py:"
            "393) arrives with slice 6, training the Transformer-only model")


def attention_dense(qkv: torch.Tensor, key_valid: torch.Tensor, nhead: int,
                    block: int = 0) -> torch.Tensor:
    """K4 forward: qkv ``[B, S, 3d]`` (heads in lanes), key_valid bool
    ``[B, S]``, ``block`` 0 or the width of each graph in a graph-packed
    row. CPU tensors take ``attention_dense_plain``; CUDA tensors launch
    the kernel or raise (and a gradient through it raises: no backward
    kernel yet)."""
    if qkv.device.type == "cpu":
        return attention_dense_plain(qkv, key_valid, nhead, block)
    if qkv.device.type != "cuda":
        raise ValueError(f"attention_dense: unsupported device {qkv.device}")
    _check_dense(qkv, key_valid, nhead, block)
    if torch.is_grad_enabled() and qkv.requires_grad:
        return _AttentionDense.apply(qkv, key_valid, nhead, block)
    return _launch_dense(qkv, key_valid, nhead, block)


attention_dense.launches = 0


def _load():
    lib = _build.load("attention_packed")
    if lib.attention_seg_fwd.argtypes is None:
        lib.attention_dense_fwd.argtypes = ([ctypes.c_void_p] * 3
                                            + [ctypes.c_int] * 5
                                            + [ctypes.c_void_p])
        lib.attention_dense_fwd.restype = ctypes.c_int
        drop = [ctypes.c_int, ctypes.c_uint, ctypes.c_float, ctypes.c_int,
                ctypes.c_int, ctypes.c_int]
        lib.attention_seg_fwd.argtypes = ([ctypes.c_void_p] * 3
                                          + [ctypes.c_int] * 4 + drop
                                          + [ctypes.c_void_p])
        lib.attention_seg_fwd.restype = ctypes.c_int
        lib.attention_seg_bwd.argtypes = ([ctypes.c_void_p] * 4
                                          + [ctypes.c_int] * 4 + drop
                                          + [ctypes.c_void_p])
        lib.attention_seg_bwd.restype = ctypes.c_int
    return lib
