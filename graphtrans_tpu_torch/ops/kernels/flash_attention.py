"""K5: attention over long unpacked rows (a graph's nodes and its CLS
column, S up to 1001 at code2's ``max_input_len``) with a key-padding or a
segment mask, streaming the keys in tiles with an online softmax, with
attention dropout; and its backward.

qkv ``[B, S, 3d]`` is the combined projection output with heads in lanes,
as K2 and K3 take it, so no head transposes surround the kernel; segq and
segk ``[B, S]`` int32. Query i attends key j iff ``segq[i] == segk[j] >=
0``: the key-padding form is segq = 0, segk = valid ? 0 : -1
(``key_padding_segs``), the segment form segq = segk = seg. Scores are
scaled by ``1/sqrt(hd)`` and the output is normalised by ``max(l,
1e-16)``, so a query with no key (a fully masked row) outputs exact zeros.
Output ``[B, S, d]``; the backward returns dqkv in the combined ``[B, S,
3d]`` layout.

Dropout at ``rate > 0`` follows torch (``l`` sums the undropped
probabilities, a kept one is scaled by ``1/(1-rate)``) and the JAX
kernel's seed schedule: (b, h, i, j) is kept iff ``hash(pos, s) <
keep_threshold(rate)`` with ``pos = (i % 256)*256 + j % 256`` and ``s =
seed + ((b*H + h)*16384 + i // 256)*1024 + j // 256`` (int32 wrap-around):
its BQ = BK = 256 and its ``bh`` from the ``[B, H, S, hd] -> [B*H, S,
hd]`` reshape (``graphtrans_tpu/ops/pallas/flash_attention.py:101``),
hashed by the counter hash its package uses in interpret mode. The JAX
kernel draws from the TPU's own PRNG there; a test that swaps its
``_dropout_keep`` for that hash holds the two to the same mask. The
kernels and the plain version draw the same mask; nothing is stored.

Replaces ``graphtrans_tpu/ops/pallas/flash_attention.py:flash_attention``
and ``flash_attention_seg``: the forward (``_fwd_kernel``) and the backward
(``_dq_kernel``, ``_dkv_kernel``, after ``_flash_bwd_rule``'s ``delta =
sum(o * g)``), which take per-head ``[B*H, S, hd]`` operands; the tests
hold the plain version to them by reshaping.

What bounds it on the H100: operations. At the code2 throughput shape (513
graph rows of S = 1001, d 256, 4 heads of 64) the forward must read q and
write out for every query and read K and V for the valid keys only (~1.18
GB, ~0.35 ms at 3.35 TB/s), while every query of a row attends that row's
valid keys: 1001 x (kept nodes + CLS) pairs a row, ~62 M pairs, x 4 heads x
~260 f32 flops, ~65 GFLOP, ~0.97 ms at 67 TFLOP/s; the backward does about
2.5 times those flops. Design (``csrc/flash_attention.cu``, the long-row
body of ``csrc/attention_fwd.cuh``, shared with K9's long instance and
K4's wide spans): one block of four warps per (row, head, 64 queries)
walks only the keys whose tags meet its queries' tags, gathered 64 at a
time by rank with their token indices (a block-wide prefix count over the
row's tags), their K and V staged in shared memory with ``cp.async``.
Each warp owns 16 query rows whole: S = Q K^T and O += P_drop V run on
the tensor cores as 3xTF32 ``mma.sync`` (each operand split into two TF32
parts, three products summed in f32, so f32 accuracy is kept), and the
online softmax runs in its registers, with a finite running max until
the first key, so a chunk without a key for a row changes nothing. One
K/V buffer up to hd 64 lets three blocks share an SM (two buffers at hd
128). A graph's valid keys are a prefix plus the CLS column, so at
code2's mean of ~125 nodes a row's 1001 queries walk two chunks of keys.
Bound: operations (4 hd flops a pair of products, ~65 GFLOP at bench512:
0.39 ms as 3xTF32 on the tensor cores, 0.97 ms at the f32 SIMT peak).
Where a gradient is wanted the forward also writes m and l ``[B, S, H]``
(dropout and statistics are template parameters, so the serving launch
runs the loop without either); ``long_fwd_geometry`` computes the launch,
which the C entry checks. The backward is the long-row pair of
``csrc/attention_bwd.cuh`` (shared with K9-bwd's long instance), on 64 x
64 pair tiles staged in shared
memory with ``cp.async``, their products on the tensor cores as 3xTF32
``mma.sync`` (each operand split into two TF32 parts, three products
summed in f32, so f32 accuracy is kept): a dq kernel, one block per (row,
head, 64 queries), that writes delta = dO.O and walks the row's keys whose
tags meet its queries', gathered 64 at a time by rank, with its dQ sums in
registers; then a dk/dv kernel, one block per (row, head, chunk of 64 valid
keys by rank), that walks the query tiles whose tags can meet its keys
with dK and dV in registers, and writes zeros for the padding keys.
Gathering fills 80 % of the chunk slots at bench512, where positional
tiles filled 56 %. Bound: operations (10 hd flops a pair of products;
~0.97 ms at bench512 as 3xTF32 on the tensor cores, 2.41 ms at the f32
SIMT peak); the pair terms are computed in both kernels. Every output cell
has one writer: no atomics. Heads of width 32, 64 and 128 are compiled.

bf16 (the bf16 step: the Transformer-only model's rows at heads of 64;
GraphTrans's packed rows of 256-384 tokens under ``--attn_backend flash``,
the segment form, at heads of 32): the JAX kernel asks for precision None
(DEFAULT, one bf16 MXU pass) on bf16 inputs, so its products round their
operands to bf16 on the TPU: the online softmax's unnormalised p (dropped
and rescaled) before P V, and in the backward dS = p (dp_drop - delta),
whose products are scaled after their sums, and P_drop; delta = dO . O over
the rounded output. The plain bf16 version (``OnlineBf16``, K3's, with dS
rounded before its scale) rounds p against the row's final max; the kernels
round it against the running one. The kernels are the bf16 key-list bodies
of ``csrc/attention_list16.cuh`` (K4's and K9's bf16 instances run them
too), at ``attention_packed.list16_geometry``'s launch over the whole row:
a block of four warps per (row, head, 64 queries) walks the keys whose tags
meet its queries', ranked and gathered 64 at a time; the backward is a dq
kernel (it writes delta) and a dk/dv kernel over chunks of 64 valid keys by
rank; every product a bf16 ``mma.sync`` with float32 sums. Launches count
by dtype in ``flash_attention.instances`` and
``flash_attention_bwd.instances``.
"""

from __future__ import annotations

import ctypes
import math

import torch

from . import _build
from .attention_packed import (LIST16_HDS, _stream, hash_bits, keep_drop,
                               keep_threshold, list16_geometry,
                               long_fwd_geometry, masked_attention)

HEAD_DIMS = (32, 64, 128)     # the head widths the kernel compiles
BF16_HEAD_DIMS = LIST16_HDS   # and its bf16 instances
DTYPES = (torch.float32, torch.bfloat16)
PLAIN_SCORE_BYTES = 1 << 30   # the plain version's score budget per chunk
MASK_TILE = 256               # the JAX kernel's BQ = BK, which seed its mask


def key_padding_segs(key_valid: torch.Tensor):
    """(segq, segk) int32 of the key-padding mask: every query attends the
    valid keys of its row."""
    segk = torch.where(key_valid, 0, -1).to(torch.int32)
    return torch.zeros_like(segk), segk


def tile_keep_mask(rows: torch.Tensor, S: int, nhead: int, rate: float,
                   seed: int, bq: int = MASK_TILE,
                   bk: int = MASK_TILE) -> torch.Tensor:
    """Bool ``[len(rows), H, S, S]``: query i keeps key j of row
    ``rows[n]`` and head h under the flash kernels' seed schedule over
    ``bq`` x ``bk`` tiles (K5's 256 x 256; K3's 512 x 128): ``s = seed +
    ((b*H + h)*16384 + i // bq)*1024 + j // bk``, ``pos = (i % bq)*bk + j %
    bk``. Drawn with torch on the rows' device."""
    dev = rows.device
    i = torch.arange(S, device=dev)[:, None]
    j = torch.arange(S, device=dev)[None, :]
    pos = (i % bq) * bk + j % bk                                 # [S, S]
    tile = (i // bq) * 1024 + j // bk
    bh = rows[:, None] * nhead + torch.arange(nhead, device=dev)  # [b, H]
    s = bh[:, :, None, None] * (16384 * 1024) + tile
    s += seed % 2**32
    s.bitwise_and_(0xFFFFFFFF)
    return hash_bits(pos, s) < keep_threshold(rate)


def flash_attention_plain(qkv: torch.Tensor, segq: torch.Tensor,
                          segk: torch.Tensor, nhead: int, rate: float = 0.0,
                          seed: int = 0) -> torch.Tensor:
    """Plain PyTorch version of K5: the masked softmax of the JAX package
    over whole rows, with K5's dropout mask at ``rate > 0``, taken a few
    rows at a time so the ``[rows, H, S, S]`` scores stay within
    ``PLAIN_SCORE_BYTES``. Autograd differentiates it. A bf16 qkv rounds at
    the points of the JAX kernel in bf16 on the TPU (``OnlineBf16``, as K3
    rounds, with dS rounded before its scale)."""
    B, S, _ = qkv.shape
    step = max(1, PLAIN_SCORE_BYTES // (nhead * S * S * 4))
    outs = []
    for b0 in range(0, B, step):
        sq = segq[b0:b0 + step].long()
        sk = segk[b0:b0 + step].long()
        mask = ((sq[:, :, None] == sk[:, None, :])
                & (sk >= 0)[:, None, :])[:, None]            # [b, 1, S, S]
        keep = None
        if rate > 0.0:
            rows = torch.arange(b0, b0 + len(sq), device=qkv.device)
            keep = tile_keep_mask(rows, S, nhead, rate, seed)
        part = qkv[b0:b0 + step]
        if qkv.dtype == torch.bfloat16:
            outs.append(OnlineBf16.apply(part, mask, nhead, keep, rate,
                                         False))
        else:
            drop = None if keep is None else keep_drop(keep, rate)
            outs.append(masked_attention(part, nhead, mask, drop))
    return outs[0] if len(outs) == 1 else torch.cat(outs)


def _heads(t: torch.Tensor, nhead: int) -> torch.Tensor:
    """[R, W, H*hd] -> float32 [R, H, W, hd]."""
    R, W, d = t.shape
    return t.float().reshape(R, W, nhead, d // nhead).transpose(1, 2)


class OnlineBf16(torch.autograd.Function):
    """The flash kernels in bf16 (K3, K5) with the JAX kernels' rounding
    points on the TPU, where their products take one bf16 MXU pass: forward
    and backward written out in float32 over the bf16 inputs, each rounding
    point an explicit cast. Forward: q.k from the bf16 operands, m and l in
    float32, the unnormalised p = exp(s - m) (here against the row's final
    max; the kernels round against the running one), dropped and rescaled,
    rounded before P V, the sum normalised by 1/l in float32 and rounded
    once. Backward: p = exp(s - m) / l and dp in float32, delta = dO . O
    over the rounded output, dS = p (dp_drop - delta) rounded, times the
    scale before it is rounded (``scale_ds``: K3) or after its products'
    sums (K5), P_drop rounded; dQ, dK, dV summed in float32 and rounded
    once. ``mask`` bool [R, 1, W, W]; ``keep`` (bool [R, H, W, W]) the
    dropout mask at ``rate``, or None."""

    @staticmethod
    def _probs(qkv, mask, nhead):
        """(q, k, v [R, H, W, hd] float32, the scale, the undropped exp(s -
        m) [R, H, W, W] (0 off the mask) and l [R, H, W, 1])."""
        q, k, v = (_heads(t, nhead) for t in qkv.split(qkv.shape[-1] // 3,
                                                      dim=-1))
        scale = torch.tensor(1.0 / math.sqrt(q.shape[-1]),
                             dtype=torch.float32)
        s = (torch.matmul(q, k.transpose(-1, -2)) * scale).masked_fill(
            ~mask, -1e30)
        e = torch.exp(s - s.amax(dim=-1, keepdim=True)).masked_fill(~mask,
                                                                    0.0)
        return q, k, v, scale, e, e.sum(dim=-1, keepdim=True)

    @staticmethod
    def forward(ctx, qkv, mask, nhead, keep, rate, scale_ds):
        q, k, v, scale, e, l = OnlineBf16._probs(qkv, mask, nhead)
        drop = None if keep is None else keep.float() * (1.0 / (1.0 - rate))
        pu = e if drop is None else e * drop
        acc = torch.matmul(pu.to(qkv.dtype).float(), v)
        out = (acc / l.clamp_min(1e-16)).to(qkv.dtype)
        R, W, _ = qkv.shape
        out = out.transpose(1, 2).reshape(R, W, -1)
        ctx.save_for_backward(qkv, mask, out, keep)
        ctx.nhead, ctx.rate, ctx.scale_ds = nhead, rate, scale_ds
        return out

    @staticmethod
    def backward(ctx, g):
        qkv, mask, out, keep = ctx.saved_tensors
        nhead, dt = ctx.nhead, qkv.dtype
        q, k, v, scale, e, l = OnlineBf16._probs(qkv, mask, nhead)
        p = e / l.clamp_min(1e-16)
        gh = _heads(g.to(dt), nhead)
        delta = (gh * _heads(out, nhead)).sum(dim=-1, keepdim=True)
        dp = torch.matmul(gh, v.transpose(-1, -2))
        pd = p
        if keep is not None:
            drop = keep.float() * (1.0 / (1.0 - ctx.rate))
            dp, pd = dp * drop, p * drop
        pre, post = (scale, 1.0) if ctx.scale_ds else (1.0, scale)
        ds = (p * (dp - delta) * pre).to(dt).float()
        dq = torch.matmul(ds, k) * post
        dk = torch.matmul(ds.transpose(-1, -2), q) * post
        dv = torch.matmul(pd.to(dt).float().transpose(-1, -2), gh)
        R, W, _ = qkv.shape
        dqkv = torch.cat([t.transpose(1, 2).reshape(R, W, -1)
                          for t in (dq, dk, dv)], dim=-1).to(dt)
        return dqkv, None, None, None, None, None


def flash_attention_bwd_plain(qkv, segq, segk, nhead, gout, rate=0.0,
                              seed=0):
    """Plain version of K5's backward: autograd through
    ``flash_attention_plain``. Returns dqkv [B, S, 3d]."""
    with torch.enable_grad():
        leaf = qkv.detach().requires_grad_()
        out = flash_attention_plain(leaf, segq, segk, nhead, rate, seed)
        return torch.autograd.grad(out, leaf, gout)[0]


def _check(qkv, segq, segk, nhead, rate, gout=None):
    B, S, d3 = qkv.shape
    d = d3 // 3
    if d3 % 3 or d % nhead:
        raise ValueError(f"flash_attention: width {d3} is not 3*nhead*hd")
    dims = BF16_HEAD_DIMS if qkv.dtype == torch.bfloat16 else HEAD_DIMS
    if d // nhead not in dims:
        raise ValueError(f"flash_attention: head width {d // nhead} in "
                         f"{qkv.dtype}; the kernel is built for {dims}")
    if not 0.0 <= rate < 1.0:
        raise ValueError(f"flash_attention: dropout rate {rate} not in "
                         f"[0, 1)")
    if qkv.dtype not in DTYPES:
        raise ValueError("flash_attention: expected float32 or bfloat16 qkv")
    for name, t in (("segq", segq), ("segk", segk)):
        if (t.dtype != torch.int32 or tuple(t.shape) != (B, S)
                or t.device != qkv.device):
            raise ValueError(f"flash_attention: {name} {t.dtype} "
                             f"{tuple(t.shape)} on {t.device} does not "
                             f"match qkv (int32 [B, S])")
    if gout is not None and (gout.dtype != qkv.dtype
                             or tuple(gout.shape) != (B, S, d)
                             or gout.device != qkv.device):
        raise ValueError(f"flash_attention_bwd: gout {gout.dtype} "
                         f"{tuple(gout.shape)} does not match the output")
    if not all(t.is_contiguous() for t in (qkv, segq, segk, gout)
               if t is not None):
        raise ValueError("flash_attention: inputs must be contiguous")
    if any(t.data_ptr() % 16 for t in (qkv, gout) if t is not None):
        raise ValueError("flash_attention: qkv and gout must be 16-byte "
                         "aligned (the kernels load four floats at a time)")


def _dropout_args(rate: float, seed: int):
    on = rate > 0.0
    seed32 = (int(seed) + 2**31) % 2**32 - 2**31   # the int32 it wraps to
    return (int(on), ctypes.c_uint(keep_threshold(rate) if on else 0),
            ctypes.c_float(1.0 / (1.0 - rate)), seed32)


def flash_attention_with_stats(qkv: torch.Tensor, segq: torch.Tensor,
                               segk: torch.Tensor, nhead: int,
                               rate: float = 0.0, seed: int = 0,
                               stats: bool = True):
    """K5's forward kernel on CUDA tensors: (out [B, S, d], m, l), with the
    softmax statistics m and l [B, S, H] that the backward reads (None,
    None when ``stats`` is False and ``rate`` 0: the serving launch writes
    none; with dropout the kernel always writes them)."""
    _check(qkv, segq, segk, nhead, rate)
    B, S, d3 = qkv.shape
    out = torch.empty((B, S, d3 // 3), dtype=qkv.dtype, device=qkv.device)
    m = l = None
    if stats or rate > 0.0:
        m = torch.empty((B, S, nhead), dtype=torch.float32, device=qkv.device)
        l = torch.empty_like(m)
    if out.numel() == 0:
        return out, m, l
    geo = (list16_geometry(B, S, 0, nhead, False, d3 // 3 // nhead)
           if qkv.dtype == torch.bfloat16
           else long_fwd_geometry(B, S, d3 // 3 // nhead, nhead))
    ptr = lambda t: ctypes.c_void_p(None if t is None else t.data_ptr())
    lib = _load()
    entry = _build.entry(lib, "flash_attention_fwd", qkv.dtype)
    err = entry(
        ptr(qkv), ptr(segq), ptr(segk), ptr(out), ptr(m), ptr(l), B, S,
        d3 // 3, nhead, *_dropout_args(rate, seed), *geo.args(),
        _stream(qkv))
    _build.check(lib, err, entry.__name__)
    flash_attention.launches += 1
    flash_attention.instances[_instance(qkv)] += 1
    return out, m, l


def _instance(qkv: torch.Tensor) -> str:
    """The counted instance: "f32" or "bf16"."""
    return "bf16" if qkv.dtype == torch.bfloat16 else "f32"


class _FlashAttention(torch.autograd.Function):
    """K5 on CUDA tensors with K5's backward kernels as its gradient."""

    @staticmethod
    def forward(ctx, qkv, segq, segk, nhead, rate, seed):
        out, m, l = flash_attention_with_stats(qkv, segq, segk, nhead, rate,
                                               seed)
        ctx.save_for_backward(qkv, segq, segk, out, m, l)
        ctx.args = (nhead, rate, seed)
        return out

    @staticmethod
    def backward(ctx, gout):
        qkv, segq, segk, out, m, l = ctx.saved_tensors
        nhead, rate, seed = ctx.args
        return (flash_attention_bwd(qkv, segq, segk, nhead, gout.contiguous(),
                                    rate, seed, saved=(out, m, l)),
                None, None, None, None, None)


def flash_attention(qkv: torch.Tensor, segq: torch.Tensor,
                    segk: torch.Tensor, nhead: int, rate: float = 0.0,
                    seed: int = 0) -> torch.Tensor:
    """K5 forward with dropout ``rate`` (0 = none) drawn from ``seed``.
    CPU tensors take ``flash_attention_plain``; CUDA tensors launch the
    kernel or raise, and where a gradient is wanted the result carries K5's
    backward kernels (``flash_attention_bwd``)."""
    if qkv.device.type == "cpu":
        return flash_attention_plain(qkv, segq, segk, nhead, rate, seed)
    if qkv.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {qkv.device}")
    if torch.is_grad_enabled() and qkv.requires_grad:
        _check(qkv, segq, segk, nhead, rate)
        return _FlashAttention.apply(qkv, segq, segk, nhead, rate, seed)
    return flash_attention_with_stats(qkv, segq, segk, nhead, rate, seed,
                                      stats=False)[0]


flash_attention.launches = 0
flash_attention.instances = {"f32": 0, "bf16": 0}   # launches by dtype


def flash_attention_bwd(qkv: torch.Tensor, segq: torch.Tensor,
                        segk: torch.Tensor, nhead: int, gout: torch.Tensor,
                        rate: float = 0.0, seed: int = 0,
                        saved=None) -> torch.Tensor:
    """K5 backward: dqkv [B, S, 3d] for the cotangent ``gout`` [B, S, d] of
    ``flash_attention(qkv, segq, segk, nhead, rate, seed)``, the dropout
    mask drawn again from ``seed``. ``saved`` is the forward's (out, m, l)
    from ``flash_attention_with_stats``, which the kernels read. CPU tensors
    take ``flash_attention_bwd_plain`` (no ``saved``); CUDA tensors launch
    the long-row dq and dk/dv kernels or raise."""
    if qkv.device.type == "cpu":
        return flash_attention_bwd_plain(qkv, segq, segk, nhead, gout, rate,
                                         seed)
    if qkv.device.type != "cuda":
        raise ValueError(f"flash_attention_bwd: unsupported device "
                         f"{qkv.device}")
    _check(qkv, segq, segk, nhead, rate, gout)
    B, S, d3 = qkv.shape
    out, m, l = saved if saved is not None else (None, None, None)
    if not (m is not None and out.shape == gout.shape
            and tuple(m.shape) == tuple(l.shape) == (B, S, nhead)):
        raise ValueError("flash_attention_bwd: needs the forward's (out, m, "
                         "l) from flash_attention_with_stats")
    dqkv = torch.empty_like(qkv)
    if dqkv.numel() == 0:
        return dqkv
    delta = torch.empty_like(m)
    lib = _load()
    entry = _build.entry(lib, "flash_attention_bwd", qkv.dtype)
    err = entry(
        *(ctypes.c_void_p(t.data_ptr())
          for t in (qkv, segq, segk, out, gout, m, l, delta, dqkv)),
        B, S, d3 // 3, nhead, *_dropout_args(rate, seed), _stream(qkv))
    _build.check(lib, err, entry.__name__)
    flash_attention_bwd.launches += 1
    flash_attention_bwd.instances[_instance(qkv)] += 1
    return dqkv


flash_attention_bwd.launches = 0
flash_attention_bwd.instances = {"f32": 0, "bf16": 0}   # launches by dtype


def _load():
    lib = _build.load("flash_attention")
    if lib.flash_attention_fwd.argtypes is None:
        drop = [ctypes.c_int, ctypes.c_uint, ctypes.c_float, ctypes.c_int]
        lib.flash_attention_fwd.argtypes = ([ctypes.c_void_p] * 6
                                            + [ctypes.c_int] * 4 + drop
                                            + [ctypes.c_int] * 8
                                            + [ctypes.c_void_p])
        lib.flash_attention_fwd.restype = ctypes.c_int
        lib.flash_attention_bwd.argtypes = ([ctypes.c_void_p] * 9
                                            + [ctypes.c_int] * 4 + drop
                                            + [ctypes.c_void_p])
        lib.flash_attention_bwd.restype = ctypes.c_int
    return lib
