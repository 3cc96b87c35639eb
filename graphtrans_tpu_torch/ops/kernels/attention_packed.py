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
(int32 wrap-around; inside K10's layer the stride is H + 3, not H), ``sp = ceil(W/128)*128`` and ``bt = 8 if sp <= 128
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
the work of each graph once, one attention problem per (row, graph
segment, head). Rows of up to ``SEG_TILE_MAX`` (128) tokens take the
whole-span bodies of ``csrc/attention_tile.cuh`` (K4's and K9's) with the
row's segments as their span source: one block per (row, head) finds the
runs of one graph id in seg itself (no host synchronisation), stages the
row's Q, K, V (and dO) once and runs each segment as one problem, several
segments a block; a row in which an id forms two runs (the JAX mask allows
it) takes the whole row as one problem under K2's mask itself. Wider rows
(code2's 384 tier) take the long-row forward and backward of
``csrc/attention_fwd.cuh`` and ``csrc/attention_bwd.cuh`` with seg as both
tags, as K3-bwd does. The forward writes the softmax statistics m and l
``[R, W, H]`` where a gradient is wanted (``attention_seg_with_stats``);
the backward reads them with the forward's output, computes delta = dO.O,
then p, dp and ds of each pair once (one dropout draw), then dQ, dK and
dV; every output cell has one writer, so there are no atomics.
``seg_fwd_geometry`` and ``seg_bwd_geometry`` pick the instance by W and
compute the launch; the C entries refuse one they cannot run. The bf16
instances (the bf16 step) have bodies of their own, picked by W in
``seg_bf16_geometry``. Rows of up to 128: the row's head slices staged as
bf16, a warp a 16-query tile of a segment, the tile's score rows in
registers, every product a bf16 ``mma.sync`` with float32 sums, and a
backward in two passes (by query tile: delta, dS and dQ; by key tile: dK
and dV) with no atomics. Rows of 129-384 (code2's 384 tier): the bf16 long
forward (``csrc/attention_fwd.cuh:long_fwd16``, launch
``long16_fwd_geometry``): a block per (row, head, tile slot) finds the
row's runs of one graph id on the device, cuts each run into 64-query
tiles and stages the run's keys once, a box of consecutive rows, as bf16;
a warp owns 16 query rows whole; it walks the keys twice from shared
memory (m and l, then the normalised p rounded once before P V). A row
where an id forms two runs keeps the positional tiles and the keys ranked
by tag, listed once a tile. The backward is the bf16 long pair
(``csrc/attention_bwd.cuh:long_dq16``, ``long_dkv16``, launch
``long16_bwd_geometry``), cut the same way: the dq kernel's 64-query tiles
and the dk/dv kernel's 64-key tiles lie inside one run, and a tile's
partners, the run's tokens, are staged once as a box of rows. The dq
kernel walks its keys twice from shared memory (delta summed from the
pairs, then dS and dQ) and leaves per query a record (m log2(e), 1/l and
delta with the dropout's scale, the hash's row part, ``long16_records``)
that the dk/dv kernel copies with its queries' rows.

K4 replaces ``graphtrans_tpu/ops/pallas/attention_packed.py:
attention_packed_qkv`` (forward ``_call_fwd``, backward ``_call_bwd``, mask
``_head_masks``): qkv ``[B, S, 3d]``, key_valid ``[B, S]``, ``block``; key
j is attendable by query i iff ``key_valid[j]`` and, with ``block > 0``,
``i // block == j // block``. Unlike K2 a padding query is not masked: it
attends its block's valid keys; only a query whose block has no valid key
outputs zeros (and gets zero dq), while a valid key's dk and dv sum over
every query of its block, padding queries included. Its dropout is K2's
(the JAX kernels share ``_keep_mask`` and the seeds ``seed + program *
nhead + h`` over ``bt`` rows a program), with r the (graph-packed) row.
Its main path is the Transformer-only model on molecules, where ``128 //
S`` graphs of S tokens share a row and ``block = S`` (1366 rows of 99 at
4096 molecules, d 256, 4 heads of 64). Bound on the H100: memory (q in and
out back for every query, K and V in for the valid keys only: ~503 MB,
~0.15 ms; the same-block pairs need ~3.8 GFLOP); the backward moves about
twice that. The kernel reads key_valid as torch's one-byte bool, so no
conversion precedes a launch. Design: the forward has two instances,
picked by the span width (a graph block of a packed row, or the whole row
at block 0) in ``dense_fwd_geometry``. Spans of up to ``tile_max(hd)``
(128) tokens, every K4 launch of the molecule paths, take the whole-span
forward of ``csrc/attention_tile.cuh`` (K9's): a span's Q, K and V staged
in shared memory once, the scores once into a shared tile by
register-blocked micro-tiles, an exact two-pass softmax per query row,
then O = P_drop V / l; several spans a block where one is small. Wider
spans (block 0, rows of 129-384) take the long-row forward of
``csrc/attention_fwd.cuh`` (K5's: keys gathered 64 at a time by rank, a
warp's 16 query rows whole in its registers, the products on the tensor
cores in 3xTF32). Both draw
K2's mask and, where a gradient is wanted, write m and l ``[B, S, H]``
(launches counted by instance in ``attention_dense.instances``). K4's
backward is one fused kernel per
attention block (``csrc/attention_tile.cuh``): a span is a graph block of
a packed row, or the whole row at block 0, and its Q, K, V and dO are
staged in shared memory once; delta = dO.O, p, dp and ds of every pair
are computed once (one dropout draw), then dQ, dK and dV as
register-blocked tile products. Spans of up to 64 tokens are taken whole
(the short instance, several spans a block where one is small); wider
ones (block 0, up to 384) in 64-token tiles with the span's dQ sums in
shared memory (the wide instance). ``dense_bwd_geometry`` computes each
launch; the C entry refuses one it cannot run. Heads of width 32 and 64.

K4's bf16 instances (the bf16 step of the Transformer-only model) take
heads of 64 only and round where K2's bf16 instances round (the JAX
kernels share ``_probs_all`` and ``attn_bwd_math``): the normalised,
dropped p rounded before P V, delta summed from the pairs, dS rounded
(``attention_dense_plain`` rounds the same way in bf16). Their bodies are
``csrc/attention_list16.cuh``'s, at ``list16_geometry``'s launch: a block
of four warps per (row, head, 64-token tile of a graph block, or of the
row at block 0), the keys whose tag meets the tile's ranked and gathered
64 at a time, a warp's 16 rows whole, every product a bf16 ``mma.sync``
with float32 sums, the dropout hash split into a row's part (the row's
seed made once a block) and a key's. The forward counts as ``tile_bf16``
(graph blocks: the molecule paths) or ``long_bf16`` (rows of 129-384);
the backward as ``short_bf16`` (graph blocks of up to 64 tokens: the
whole backward of a block in one kernel, its keys by position) or
``long_bf16`` (a dq kernel, then a dk/dv kernel over chunks of valid
keys by rank; delta passes between them).
"""

from __future__ import annotations

import ctypes
import functools
import math
from dataclasses import dataclass

import torch

from . import _build
from .rounding import round_grad, round_value

W_MAX = 384          # wider packed rows take flash_hil_seg (K3)
HEAD_DIM = 32        # the head width csrc/attention_packed.cu compiles


def _i32(c: int) -> int:
    """The u32 constant c as the int32 of its bits: x * _i32(c) for x in
    [0, 2**32) stays within int64, and its low 32 bits are the u32
    product's."""
    return c - 2**32 if c >= 2**31 else c


def hash_bits(pos: torch.Tensor, seed: torch.Tensor) -> torch.Tensor:
    """u32 counter hash of (position, seed): a copy of the JAX package's
    interpret-mode stand-in for the TPU PRNG, in int64 torch arithmetic on
    the tensors' own device (each product masked to 32 bits). pos and seed
    hold u32 values, and so does the result, a new tensor of their
    broadcast shape worked in place."""
    x = seed * _i32(0x9E3779B9)
    x.bitwise_and_(0xFFFFFFFF)
    x = x + ((pos * _i32(2654435761)) & 0xFFFFFFFF)
    x.bitwise_and_(0xFFFFFFFF)
    x ^= x >> 16
    x.mul_(_i32(0x7FEB352D)).bitwise_and_(0xFFFFFFFF)
    x ^= x >> 15
    x.mul_(_i32(0x846CA68B)).bitwise_and_(0xFFFFFFFF)
    x ^= x >> 16
    return x


def dropout_tiling(W: int):
    """(sp, bt): the key block and the rows per tile that index the mask."""
    sp = -(-W // 128) * 128
    return sp, (8 if sp <= 128 else 4)


def keep_threshold(rate: float) -> int:
    """Keep iff bits < this u32 (the float truncated, as the reference's
    ``jnp.uint32`` truncates it)."""
    return int(min(max(1.0 - rate, 0.0), 1.0) * 0xFFFFFFFF)


def keep_drop(keep: torch.Tensor, rate: float):
    """Dropout of the probabilities by the bool mask ``keep`` at ``rate``
    (torch semantics: a kept probability scaled by ``1/(1-rate)``)."""
    return lambda p: p * keep.to(p.dtype) * (1.0 / (1.0 - rate))


def keep_mask(R: int, W: int, nhead: int, rate: float, seed: int,
              device, stride: int = 0) -> torch.Tensor:
    """Bool [R, H, W, W]: query i keeps key j of row r, head h (drawn with
    torch on ``device``). ``stride`` is the seeds a tile of ``bt`` rows
    takes: ``nhead`` (the default, 0) for K2 and K4; K10's layer takes
    ``nhead + 3`` (its three dropout streams follow the heads')."""
    sp, bt = dropout_tiling(W)
    r = torch.arange(R, device=device)[:, None, None, None]
    h = torch.arange(nhead, device=device)[None, :, None, None]
    i = torch.arange(W, device=device)[:, None]
    j = torch.arange(W, device=device)[None, :]
    pos = ((r % bt) * W + i) * sp + j                           # [R, 1, W, W]
    s = (seed % 2**32 + (r // bt) * (stride or nhead) + h) & 0xFFFFFFFF
    return hash_bits(pos, s) < keep_threshold(rate)


def masked_attention(qkv: torch.Tensor, nhead: int, mask: torch.Tensor,
                     drop=None) -> torch.Tensor:
    """Softmax attention of qkv ``[R, W, 3d]`` (heads in lanes) under the
    bool ``mask`` ``[R, 1, W, W]`` (query, key), as the JAX package's
    ``masked_softmax``: scores scaled by ``1/sqrt(hd)``, the row max
    subtracted, the sum clamped at 1e-16 (a query with no key gets zeros),
    then ``drop`` (a function of the probabilities ``[R, H, W, W]``, e.g.
    ``keep_drop``) if given. Output ``[R, W, d]``. In bf16 it rounds as
    the JAX package's XLA route does (``graphtrans_tpu/nn/transformer.py:
    259-265``): scores and softmax in float32, the probabilities rounded to
    bf16 before ``drop``, the product with V in bf16."""
    R, W, d3 = qkv.shape
    d = d3 // 3
    hd = d // nhead
    q, k, v = (t.reshape(R, W, nhead, hd).transpose(1, 2)
               for t in qkv.split(d, dim=-1))                 # [R, H, W, hd]
    if qkv.dtype == torch.bfloat16:
        s = torch.matmul(q.float(), k.float().transpose(-1, -2)) / math.sqrt(
            hd)
        p = _softmax(s, mask).to(qkv.dtype)
        if drop is not None:
            p = drop(p)
        return torch.matmul(p, v).transpose(1, 2).reshape(R, W, d)
    p = _softmax(torch.matmul(q, k.transpose(-1, -2)) / math.sqrt(hd), mask)
    if drop is not None:
        p = drop(p)
    return torch.matmul(p, v).transpose(1, 2).reshape(R, W, d)


def _softmax(s: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """``masked_attention``'s softmax of float32 scores under ``mask``."""
    s = s.masked_fill(~mask, -1e30)
    e = torch.exp(s - s.amax(dim=-1, keepdim=True).detach()).masked_fill(
        ~mask, 0.0)
    return e / e.sum(dim=-1, keepdim=True).clamp_min(1e-16)


def seg_mask(seg: torch.Tensor) -> torch.Tensor:
    """K2's mask of seg ``[R, W]``: bool ``[R, 1, W, W]``, query i attends
    key j iff ``seg[i] == seg[j] >= 0``."""
    seg = seg.long()
    return ((seg[:, :, None] == seg[:, None, :])
            & (seg >= 0)[:, None, :])[:, None]


def _attention_k2_bf16(qkv: torch.Tensor, nhead: int, mask: torch.Tensor,
                       drop, scale_ds: bool = True) -> torch.Tensor:
    """K2 in bf16, as the JAX kernel computes it in bf16
    (``graphtrans_tpu/ops/pallas/attention_packed.py:152-206``, ``:238-285``):
    q.k from the bf16 operands summed in float32, times the f32 scale;
    softmax, dropout and normalisation in float32, the dropped, normalised
    p rounded to bf16 once; p.v summed in float32 and rounded once.
    Backward (autograd through the float32 ops): dv = pd^T g and dp = g v^T
    in float32, ds from the undropped float32 p, times the scale, rounded to
    bf16 once; dq = ds k and dk = ds^T q in float32, each rounded once. With
    ``scale_ds`` False (K9, ``attention_smallS.py:_bwd_kernel``) ds is
    rounded before the scale, which multiplies dq and dk after their
    sums."""
    R, W, d3 = qkv.shape
    d = d3 // 3
    hd = d // nhead
    q, k, v = (t.float().reshape(R, W, nhead, hd).transpose(1, 2)
               for t in qkv.split(d, dim=-1))                 # [R, H, W, hd]
    scale = torch.tensor(1.0 / math.sqrt(hd), dtype=torch.float32)
    s = torch.matmul(q, k.transpose(-1, -2))
    s = (round_grad(s, qkv.dtype) * scale if scale_ds
         else round_grad(s * scale, qkv.dtype))
    p = _softmax(s, mask)
    if drop is not None:
        p = drop(p)
    p = round_value(p, qkv.dtype)
    out = torch.matmul(p, v).transpose(1, 2).reshape(R, W, d)
    return out.to(qkv.dtype)


def attention_seg_plain(qkv: torch.Tensor, seg: torch.Tensor, nhead: int,
                        rate: float = 0.0, seed: int = 0,
                        keep=None, drop=None,
                        kernel: bool = True) -> torch.Tensor:
    """Plain PyTorch version of K2: same arguments, same result (the same
    dropout mask); autograd differentiates it. ``keep`` (bool [R, H, W, W])
    replaces K2's mask at ``rate > 0`` (K3 draws its own); ``drop`` (a
    function of the probabilities) replaces both. qkv f32, or bf16: then it
    rounds where the bf16 kernels round (``_attention_k2_bf16``), or with
    ``kernel`` False where the JAX package's XLA route rounds (the
    encoder's plain route, ``masked_attention``)."""
    R, W, _ = qkv.shape
    mask = seg_mask(seg)                                     # [R, 1, W, W]
    if drop is None and rate > 0.0:
        if keep is None:
            keep = keep_mask(R, W, nhead, rate, seed, qkv.device)
        drop = keep_drop(keep, rate)
    if qkv.dtype == torch.bfloat16 and kernel:
        return _attention_k2_bf16(qkv, nhead, mask, drop)
    return masked_attention(qkv, nhead, mask, drop)


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
    if qkv.dtype not in DTYPES or seg.dtype != torch.int32:
        raise ValueError("attention_seg: expected float32 or bfloat16 qkv, "
                         "int32 seg")
    if tuple(seg.shape) != (R, W) or seg.device != qkv.device:
        raise ValueError(f"attention_seg: seg {tuple(seg.shape)} on "
                         f"{seg.device} does not match qkv")
    if gout is not None and (gout.dtype != qkv.dtype
                             or tuple(gout.shape) != (R, W, d)
                             or gout.device != qkv.device):
        raise ValueError(f"attention_seg_bwd: gout {gout.dtype} "
                         f"{tuple(gout.shape)} does not match the output")
    if not all(t.is_contiguous() for t in (qkv, seg, gout) if t is not None):
        raise ValueError("attention_seg: inputs must be contiguous")
    if any(t.data_ptr() % 16 for t in (qkv, gout) if t is not None):
        raise ValueError("attention_seg: qkv and gout must be 16-byte "
                         "aligned (the kernels load four elements at a "
                         "time)")


def _dropout_args(W: int, rate: float, seed: int):
    sp, bt = dropout_tiling(W)
    on = rate > 0.0
    # the seed as the int32 it wraps to in the reference
    seed32 = (int(seed) + 2**31) % 2**32 - 2**31
    return (int(on), ctypes.c_uint(keep_threshold(rate) if on else 0),
            ctypes.c_float(1.0 / (1.0 - rate)), seed32, bt, sp)


def _stream(t: torch.Tensor):
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def attention_seg_with_stats(qkv: torch.Tensor, seg: torch.Tensor,
                             nhead: int, rate: float = 0.0, seed: int = 0,
                             stats: bool = True):
    """K2's forward kernel on CUDA tensors: (out [R, W, d], m, l), with the
    softmax statistics m and l [R, W, H] that the backward reads (None,
    None when ``stats`` is False and ``rate`` 0: the serving launch writes
    none; with dropout the kernel always writes them). The instance
    (``seg_fwd_geometry``) is counted in ``attention_seg.instances``."""
    _check(qkv, seg, nhead, rate)
    R, W, d3 = qkv.shape
    out = torch.empty((R, W, d3 // 3), dtype=qkv.dtype, device=qkv.device)
    m = l = None
    if stats or rate > 0.0:
        m = torch.empty((R, W, nhead), dtype=torch.float32, device=qkv.device)
        l = torch.empty_like(m)
    if out.numel() == 0:
        return out, m, l
    geo = _seg_geometry(qkv, nhead, False)
    ptr = lambda t: ctypes.c_void_p(None if t is None else t.data_ptr())
    lib = _load()
    entry = _build.entry(lib, "attention_seg_fwd", qkv.dtype)
    err = entry(
        ptr(qkv), ptr(seg), ptr(out), ptr(m), ptr(l), R, W, d3 // 3, nhead,
        *_dropout_args(W, rate, seed), *geo.args(), _stream(qkv))
    _build.check(lib, err, entry.__name__)
    attention_seg.launches += 1
    attention_seg.instances[_instance(geo, qkv)] += 1
    return out, m, l


DTYPES = (torch.float32, torch.bfloat16)   # K2's and K2-bwd's instances


def _seg_geometry(qkv: torch.Tensor, nhead: int, bwd: bool):
    """The launch of K2 (K2-bwd with ``bwd``) on qkv [R, W, 3d]: the f32
    instances' (``seg_fwd_geometry``, ``seg_bwd_geometry``) or the bf16
    ones' (``seg_bf16_geometry``)."""
    R, W, _ = qkv.shape
    if qkv.dtype == torch.bfloat16:
        return seg_bf16_geometry(R, W, nhead, bwd)
    return (seg_bwd_geometry if bwd else seg_fwd_geometry)(R, W, HEAD_DIM,
                                                           nhead)


def _instance(geo, qkv: torch.Tensor) -> str:
    """The counted instance: "tile", "long", "tile_bf16" or "long_bf16"."""
    return (geo.instance if qkv.dtype == torch.float32
            else geo.instance + "_bf16")


class _AttentionSeg(torch.autograd.Function):
    """K2 on CUDA tensors with K2's backward kernel as its gradient."""

    @staticmethod
    def forward(ctx, qkv, seg, nhead, rate, seed):
        out, m, l = attention_seg_with_stats(qkv, seg, nhead, rate, seed)
        ctx.save_for_backward(qkv, seg, out, m, l)
        ctx.args = (nhead, rate, seed)
        return out

    @staticmethod
    def backward(ctx, gout):
        qkv, seg, out, m, l = ctx.saved_tensors
        nhead, rate, seed = ctx.args
        return (attention_seg_bwd(qkv, seg, nhead, gout.contiguous(),
                                  (out, m, l), rate, seed),
                None, None, None, None)


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
    if torch.is_grad_enabled() and qkv.requires_grad:
        return _AttentionSeg.apply(qkv, seg, nhead, rate, seed)
    return attention_seg_with_stats(qkv, seg, nhead, rate, seed,
                                    stats=False)[0]


attention_seg.launches = 0
# launches by instance
attention_seg.instances = {"tile": 0, "long": 0, "tile_bf16": 0,
                           "long_bf16": 0}


def attention_seg_bwd(qkv: torch.Tensor, seg: torch.Tensor, nhead: int,
                      gout: torch.Tensor, saved, rate: float = 0.0,
                      seed: int = 0) -> torch.Tensor:
    """K2 backward: dqkv [R, W, 3d] for the cotangent ``gout`` [R, W, d]
    of ``attention_seg(qkv, seg, nhead, rate, seed)``, the dropout mask
    drawn again from ``seed``. ``saved`` is the forward's (out, m, l) from
    ``attention_seg_with_stats``, which the kernels read. CPU tensors take
    ``attention_seg_bwd_plain``, which recomputes them and ignores
    ``saved`` (None will do); CUDA tensors launch the kernel (the instance
    ``seg_bwd_geometry`` picks, counted in ``attention_seg_bwd.instances``)
    or raise."""
    if qkv.device.type == "cpu":
        return attention_seg_bwd_plain(qkv, seg, nhead, gout, rate, seed)
    if qkv.device.type != "cuda":
        raise ValueError(f"attention_seg_bwd: unsupported device {qkv.device}")
    _check(qkv, seg, nhead, rate, gout)
    R, W, d3 = qkv.shape
    out, m, l = saved
    if not (out.shape == gout.shape
            and tuple(m.shape) == tuple(l.shape) == (R, W, nhead)):
        raise ValueError("attention_seg_bwd: needs the forward's (out, m, "
                         "l) from attention_seg_with_stats")
    if out.data_ptr() % 16:
        raise ValueError("attention_seg_bwd: the forward's output must be "
                         "16-byte aligned")
    dqkv = torch.empty_like(qkv)
    if dqkv.numel() == 0:
        return dqkv
    geo = _seg_geometry(qkv, nhead, True)
    delta = None
    if geo.instance == "long":   # the long pair's scratch
        delta = (long16_records(m) if qkv.dtype == torch.bfloat16
                 else torch.empty_like(m))
    ptr = lambda t: ctypes.c_void_p(None if t is None else t.data_ptr())
    lib = _load()
    entry = _build.entry(lib, "attention_seg_bwd", qkv.dtype)
    err = entry(
        *(ptr(t) for t in (qkv, seg, out, gout, m, l, delta, dqkv)),
        R, W, d3 // 3, nhead, *_dropout_args(W, rate, seed), *geo.args(),
        _stream(qkv))
    _build.check(lib, err, entry.__name__)
    attention_seg_bwd.launches += 1
    attention_seg_bwd.instances[_instance(geo, qkv)] += 1
    return dqkv


attention_seg_bwd.launches = 0
# launches by instance
attention_seg_bwd.instances = {"tile": 0, "long": 0, "tile_bf16": 0,
                               "long_bf16": 0}


# ---- launch geometry of the kernels on csrc/attention_tile.cuh ------------

SMEM_MAX = 232448    # dynamic shared bytes a block may take on the H100
TILE_THREADS = 256   # the most threads a block of a tile kernel
TILE_GROUP_MAX = 8   # the most (row, span, head) problems a block
SHORT_MAX = 64       # the longest span the short backward takes whole
WIDE = 64            # rows of a tile of the wide backward
TILE_MAX = 128       # the longest span the tile forward takes
LONG_T = 64          # queries a tile, keys a chunk of the long kernels
LONG_THREADS = 256   # threads a block of the long backward
LONG_FWD_THREADS = 128  # threads a block of the long forward


@dataclass(frozen=True)
class Geometry:
    """One launch of a kernel on ``csrc/attention_tile.cuh``,
    ``csrc/attention_fwd.cuh`` or ``csrc/attention_bwd.cuh``: the instance, the spans
    of a row (start, end), the rows ``pad`` of a span's tile, the problems
    (row, span, head) ``group`` a CUDA block, the grid, the threads a block
    and its dynamic shared bytes. ``args`` are the ints the C entry checks
    and launches."""
    instance: str
    spans: tuple
    pad: int
    group: int
    grid: tuple
    threads: int
    smem: int

    def args(self):
        code = {"short": 1, "tile": 1, "wide": 2, "long": 3}[self.instance]
        return (code, self.pad, self.group, *self.grid, self.threads,
                self.smem)


def row_spans(S: int, block: int) -> tuple:
    """The attention blocks of a row of S tokens: graph blocks of ``block``
    tokens (the last may be shorter), or the whole row at block 0."""
    width = block if 0 < block < S else S
    return tuple((s, min(S, s + width)) for s in range(0, S, width))


def _round(n: int, k: int) -> int:
    return -(-n // k) * k


def bwd_short_bytes(pad: int, hd: int) -> int:
    """Shared bytes of one problem of the short backward: Q, K, V, dO;
    P_drop, dS; m, 1/l, delta and the key mask of each row."""
    return 4 * (4 * pad * (hd + 4) + 2 * pad * (pad + 4) + 4 * pad)


def bwd_wide_bytes(width: int, hd: int) -> int:
    """Shared bytes of the wide backward: four 64-row tiles, two score
    tiles, the span's dQ sums and statistics, a key tile's mask."""
    npad = _round(width, WIDE)
    return 4 * (4 * WIDE * (hd + 4) + 2 * WIDE * (WIDE + 4)
                + npad * (hd + 4) + 3 * npad + WIDE)


def fwd_tile_bytes(pad: int, hd: int) -> int:
    """Shared bytes of one problem of the tile forward: Q, K, V; the score
    tile; 1/l and the key mask of each row."""
    return 4 * (3 * pad * (hd + 4) + pad * (pad + 4) + 2 * pad)


def tile_max(hd: int) -> int:
    """The longest span the tile forward takes at head width ``hd``: up to
    TILE_MAX tokens, while one problem fits a block's shared memory (128
    at hd 32 and 64, 112 at hd 128)."""
    return max(n for n in range(4, TILE_MAX + 1, 4)
               if fwd_tile_bytes(n, hd) <= SMEM_MAX)


def long_fwd_bytes(hd: int) -> int:
    """Shared bytes of the long forward: the Q tile, two K/V buffers of 64
    rows, each warp's 16-row P tile, per-row tags, the buffered keys' tags
    and token indices, the prefix count's scratch
    (``csrc/attention_fwd.cuh:long_fwd_bytes``)."""
    bufs = 1 if hd <= 64 else 2
    return 4 * ((1 + 2 * bufs) * LONG_T * (hd + 4) + LONG_T * (LONG_T + 4)
                + (1 + 2 * bufs) * LONG_T + 8)


def long_bwd_bytes(hd: int) -> int:
    """Shared bytes of the long backward's dk/dv kernel (its dq kernel takes
    one score tile less): Q, dO, K, V tiles of 64 rows, the dS and P_drop
    score tiles, per-row statistics, tags and token indices, and the prefix
    count's scratch (``csrc/attention_bwd.cuh:long_dkv_bytes``)."""
    return 4 * (4 * LONG_T * (hd + 4) + 2 * LONG_T * (LONG_T + 8)
                + 6 * LONG_T + 16)


def long_fwd_geometry(B: int, S: int, hd: int, nhead: int,
                      spans: tuple = None) -> Geometry:
    """The long forward's launch (K5's, and K4's and K9's above the tile
    instance): a block of LONG_FWD_THREADS per (row, head, LONG_T
    queries); ``spans`` default to the row."""
    return Geometry("long", spans or ((0, S),), LONG_T, 1,
                    (B, nhead, -(-S // LONG_T)), LONG_FWD_THREADS,
                    long_fwd_bytes(hd))


SEG_TILE_MAX = 128   # K2: rows of up to this take the tile kernels
SEG_FWD_THREADS = 256   # threads a block of K2's tile forward
SEG_BWD_THREADS = 512   # threads a block of K2's tile backward


def seg_sld(pad: int) -> int:
    """Floats a row of a K2 segment's score tile of ``pad`` rows: an odd
    number of float4, so the softmax's eight rows a warp read distinct
    banks (``csrc/attention_tile.cuh:seg_sld``)."""
    return 4 * ((pad // 4 + 1) | 1)


@functools.lru_cache(maxsize=None)
def seg_score_floats(W: int) -> int:
    """The most score floats a row of W tokens can need: a segment of n
    tokens takes pad x seg_sld(pad) (pad: n rounded up to 4), maximised
    over every split of the row into segments (a knapsack over the
    lengths; ``csrc/attention_tile.cuh:seg_score_floats``)."""
    best = [0] * (W + 1)
    for w in range(1, W + 1):
        best[w] = max(best[w - n] + _round(n, 4) * seg_sld(_round(n, 4))
                      for n in range(1, w + 1))
    return _round(best[W], 4)


def seg_tile_bytes(W: int, hd: int, bwd: bool) -> int:
    """Shared bytes of a K2 tile block on rows of W tokens: the row's head
    slices of round4(W) + 4 rows (forward: Q, with V later in its place,
    and K; backward: Q, K, V, dO), the score tiles (P; and dS), per token
    1/l (m, 1/l, delta) and tag, per segment its first token, length,
    prefix counts and score offset
    (``csrc/attention_tile.cuh:seg_tile_words``)."""
    rows = _round(W, 4) + 4
    return 4 * ((4 if bwd else 2) * rows * (hd + 4)
                + (2 if bwd else 1) * seg_score_floats(W)
                + (3 if bwd else 1) * rows + rows + 5 * (W + 1) + 4)


def seg_instance(W: int) -> str:
    """The instance K2's forward and backward take on rows of W tokens:
    "tile" (the row's segments, each a whole-span problem) up to
    SEG_TILE_MAX, "long" (the long-row bodies under seg as both tags)
    above. A row of W tokens holds segments of at most W."""
    return "tile" if W <= SEG_TILE_MAX else "long"


@functools.lru_cache(maxsize=None)
def seg_fwd_geometry(R: int, W: int, hd: int, nhead: int) -> Geometry:
    """K2's forward launch for R rows of W tokens: the tile instance, a
    block of SEG_FWD_THREADS per (row, head), or the long forward's."""
    if seg_instance(W) == "tile":
        return Geometry("tile", ((0, W),), _round(W, 4), 1, (R * nhead, 1, 1),
                        SEG_FWD_THREADS, seg_tile_bytes(W, hd, False))
    return long_fwd_geometry(R, W, hd, nhead)


@functools.lru_cache(maxsize=None)
def seg_bwd_geometry(R: int, W: int, hd: int, nhead: int) -> Geometry:
    """K2-bwd's launch for R rows of W tokens: the tile instance, a block
    of SEG_BWD_THREADS per (row, head), or the long-row pair's (a block of
    LONG_THREADS per (row, head, LONG_T tokens), the dk/dv kernel's shared
    bytes)."""
    if seg_instance(W) == "tile":
        return Geometry("tile", ((0, W),), _round(W, 4), 1, (R * nhead, 1, 1),
                        SEG_BWD_THREADS, seg_tile_bytes(W, hd, True))
    return Geometry("long", ((0, W),), LONG_T, 1, (R, nhead, -(-W // LONG_T)),
                    LONG_THREADS, long_bwd_bytes(hd))


SEG_BF16_THREADS = 128   # threads (four warps) a block of K2's bf16 pair
SEG_BF16_LD = HEAD_DIM + 8   # bf16 a staged row of K2's bf16 pair


def seg_bf16_rows(W: int) -> int:
    """Rows a K2 bf16 block stages on rows of W tokens: a segment's last
    16-query tile reads up to 15 rows past its end
    (``csrc/attention_tile.cuh:seg16_rows``)."""
    return _round(W, 16) + 16


def seg_bf16_bytes(W: int, bwd: bool) -> int:
    """Shared bytes of a K2 bf16 block on rows of W tokens: the head slices
    in bf16, rows of SEG_BF16_LD (forward Q, K, V; backward also dO), the
    backward's m, 1/l and delta per row, the tags per row, per run its
    first token, length and tiles' prefix count, and the block's two counts
    (``csrc/attention_tile.cuh:seg16_bytes``)."""
    rows = seg_bf16_rows(W)
    return ((4 if bwd else 3) * rows * SEG_BF16_LD * 2
            + (3 if bwd else 0) * rows * 4 + rows * 4 + 3 * (W + 1) * 4 + 16)


@functools.lru_cache(maxsize=None)
def seg_bf16_geometry(R: int, W: int, nhead: int, bwd: bool) -> Geometry:
    """The launch of K2's bf16 forward (K2-bwd's with ``bwd``) for R rows of
    W tokens: up to SEG_TILE_MAX the tile instance, a block of
    SEG_BF16_THREADS per (row, head), whose warps take the segments'
    16-query tiles (``pad`` the rows staged); wider rows the bf16 long
    forward's (``long16_fwd_geometry``, the keys staged whole) or the bf16
    long pair's (``long16_bwd_geometry``, the partners staged whole; both
    kernels of the backward take it)."""
    if W > SEG_TILE_MAX:
        return (long16_bwd_geometry(R, W, nhead, True) if bwd
                else long16_fwd_geometry(R, W, nhead, True))
    return Geometry("tile", ((0, W),), seg_bf16_rows(W), 1, (R * nhead, 1, 1),
                    SEG_BF16_THREADS, seg_bf16_bytes(W, bwd))


LONG16_THREADS = 128   # four warps, 16 rows each: the bf16 long kernels
BWD16_STAGES = 3   # K3's bf16 pair: partner chunk buffers of its ring
BWD16_MISC = 16    # ints of a block's scratch in the bf16 long pair


def long16_bwd_rows(W: int, whole: bool) -> int:
    """Partner rows a block of the bf16 long pair stages: K2's (``whole``)
    a row's tokens rounded up to whole chunks of LONG_T, K3's ring of
    BWD16_STAGES chunks (``csrc/attention_bwd.cuh:bwd16_rows``)."""
    return _round(W, LONG_T) if whole else BWD16_STAGES * LONG_T


def long16_bwd_bytes(W: int, whole: bool) -> int:
    """Shared bytes of a block of either kernel of the bf16 long pair on rows
    of W tokens: the tile's own two LONG_T-row slices and the partners' two
    as bf16 rows of SEG_BF16_LD (a staged Q row carries its query's record
    in its padding); the row's tags and one past them; its runs' first
    tokens and lengths; the scratch (``csrc/attention_bwd.cuh:
    bwd16_bytes``)."""
    rows = long16_bwd_rows(W, whole)
    return ((2 * LONG_T + 2 * rows) * SEG_BF16_LD * 2
            + (3 * W + 1 + BWD16_MISC) * 4)


@functools.lru_cache(maxsize=None)
def long16_bwd_geometry(R: int, W: int, nhead: int, whole: bool) -> Geometry:
    """The launch of each kernel of the bf16 long pair (K2-bwd on rows of
    129-384 with ``whole``, K3-bwd at any width): a block of LONG16_THREADS
    per (row, head, tile slot), ``pad`` = LONG_T tokens a tile,
    ceil(W / LONG_T) + 1 slots a row, as the bf16 long forward's."""
    return Geometry("long", ((0, W),), LONG_T, 1,
                    (R, nhead, -(-W // LONG_T) + 1), LONG16_THREADS,
                    long16_bwd_bytes(W, whole))


def long16_records(m: torch.Tensor) -> torch.Tensor:
    """The bf16 long pair's scratch for the statistics m [R, W, H]: per
    (row, head, token) the record the dq kernel writes and the dk/dv
    kernel reads (m log2(e), 1 / (l (1 - rate)), delta (1 - rate), the
    dropout hash's row part), [R, H, W, 4] float32."""
    R, W, H = m.shape
    return torch.empty((R, H, W, 4), dtype=torch.float32, device=m.device)


FWD16_STAGES = 3   # K3's bf16 forward: chunk buffers of its ring
FWD16_MISC = 16    # ints of a block's scratch in the bf16 long forward


def long16_fwd_key_rows(W: int, norm: bool) -> int:
    """Key rows (K and V each) a block of the bf16 long forward stages:
    K2's (``norm``) row's keys whole, K3's ring of FWD16_STAGES chunks of
    LONG_T (``csrc/attention_fwd.cuh:fwd16_key_rows``)."""
    return _round(W, LONG_T) if norm else FWD16_STAGES * LONG_T


def long16_fwd_bytes(W: int, norm: bool) -> int:
    """Shared bytes of a block of the bf16 long forward on rows of W tokens:
    Q (LONG_T rows), K and V as bf16 rows of SEG_BF16_LD; per staged key its
    tag; the row's tags and one past them; its runs' first tokens and
    lengths; the scratch (``csrc/attention_fwd.cuh:fwd16_bytes``)."""
    rows = long16_fwd_key_rows(W, norm)
    return ((LONG_T + 2 * rows) * SEG_BF16_LD * 2
            + (rows + 3 * W + 1 + FWD16_MISC) * 4)


@functools.lru_cache(maxsize=None)
def long16_fwd_geometry(R: int, W: int, nhead: int, norm: bool) -> Geometry:
    """The launch of the bf16 long forward (K2 on rows of 129-384 with
    ``norm``, K3 at any width): a block of LONG16_THREADS per (row, head,
    tile slot), ``pad`` = LONG_T queries a tile, ceil(W / LONG_T) + 1 slots
    a row (a row's runs cut into tiles give at most one tile more than its
    positional tiles where it holds two runs)."""
    return Geometry("long", ((0, W),), LONG_T, 1,
                    (R, nhead, -(-W // LONG_T) + 1), LONG16_THREADS,
                    long16_fwd_bytes(W, norm))


LIST16_THREADS = 128   # four warps, 16 rows each: the bf16 key-list bodies
LIST16_HDS = (32, 64)  # the head widths they are built for (K5 takes both)


def list16_bytes(bwd: bool, hd: int) -> int:
    """Shared bytes of a block of the bf16 key-list bodies at heads of
    ``hd``: three 64-row bf16 tiles forward (Q, K, V), four backward, rows
    of hd + 8; the backward's m log2(e), 1/l, delta and part of the dropout
    hash per staged query; per staged query its tag, per key its tag and
    token; the prefix count's scratch
    (``csrc/attention_list16.cuh:list16_bytes``)."""
    if hd not in LIST16_HDS:
        raise ValueError(f"list16: head width {hd}; the bodies are built for "
                         f"{LIST16_HDS}")
    return ((4 if bwd else 3) * LONG_T * (hd + 8) * 2
            + (4 * LONG_T * 4 if bwd else 0)
            + (3 * LONG_T + LIST16_THREADS // 32 + 4) * 4)


@functools.lru_cache(maxsize=None)
def list16_geometry(B: int, S: int, block: int, nhead: int, bwd: bool,
                    hd: int) -> Geometry:
    """The launch of the bf16 key-list bodies (K4's, K5's and K9's bf16
    instances; their backwards' with ``bwd``, both kernels of the pair) on
    B rows of S tokens at heads of ``hd``: the row cut into spans
    (``row_spans(S, block)``, block 0: the row), a block of LIST16_THREADS
    per (row, head, 64-token tile of a span). The instance is named by the
    span width: forward "tile" up to TILE_MAX (the molecule paths' packed
    rows) and "long" above, one body for both; backward "short" up to
    LONG_T (the whole backward of a span in one kernel,
    ``csrc/attention_list16.cuh:span_bwd16``) and "long" above (the dq and
    dk/dv pair)."""
    spans = row_spans(S, block)
    span = spans[0][1] - spans[0][0]
    tiles = len(spans) * -(-span // LONG_T)
    short = ("short", LONG_T) if bwd else ("tile", TILE_MAX)
    return Geometry(short[0] if span <= short[1] else "long", spans, LONG_T,
                    1, (B, nhead, tiles), LIST16_THREADS,
                    list16_bytes(bwd, hd))


def dense_fwd_geometry(B: int, S: int, block: int, hd: int, nhead: int,
                       stats: bool, rate: float) -> Geometry:
    """The forward launch of K4 (and of K9, at any S) for rows of S tokens:
    the tile instance for spans of ``row_spans(S, block)`` up to
    ``tile_max(hd)`` tokens, else the long one (K4: block 0, rows of
    129-384; K9: code2's rows of 513 and 1001). ``stats`` and ``rate`` pick
    the compiled variant (serving, gradient, training), not the geometry;
    they are checked here as the entries check them."""
    if rate > 0.0 and not stats:
        raise ValueError("attention forward: dropout saves the statistics")
    spans = row_spans(S, block)
    width = spans[0][1] - spans[0][0]
    if width <= tile_max(hd):
        return tile_launch("tile", spans, fwd_tile_bytes(_round(width, 4),
                                                         hd),
                           B * len(spans) * nhead)
    return long_fwd_geometry(B, S, hd, nhead, spans)


def tile_launch(instance: str, spans: tuple, per: int, problems: int):
    """The geometry of a whole-span tile kernel whose problem takes ``per``
    shared bytes: a thread for each 4 x 4 micro-tile of the pair tile (at
    most TILE_THREADS), and as many problems a block (a power of two up to
    TILE_GROUP_MAX) as keep their micro-tiles within 128 threads and their
    shared memory within SMEM_MAX: spans of up to 32 tokens share a
    block."""
    width = spans[0][1] - spans[0][0]
    pad = _round(width, 4)
    tiles = (pad // 4) ** 2
    group = 1
    while (group < TILE_GROUP_MAX and 2 * group * tiles <= 128
           and 2 * group * per <= SMEM_MAX):
        group *= 2
    threads = min(TILE_THREADS, _round(group * tiles, 32))
    return Geometry(instance, spans, pad, group,
                    (-(-problems // group), 1, 1), threads, group * per)


def dense_bwd_geometry(B: int, S: int, block: int, hd: int,
                       nhead: int) -> Geometry:
    """K4-bwd's launch for rows of S tokens: one problem (row, span, head)
    per span of ``row_spans(S, block)``; spans of up to SHORT_MAX tokens
    take the short instance (whole, ``group`` a block), wider ones the
    wide instance (one a block of 256 threads, 64-token tiles)."""
    spans = row_spans(S, block)
    width = spans[0][1] - spans[0][0]
    problems = B * len(spans) * nhead
    if width <= SHORT_MAX:
        return tile_launch("short", spans, bwd_short_bytes(_round(width, 4),
                                                           hd), problems)
    return Geometry("wide", spans, WIDE, 1, (problems, 1, 1), TILE_THREADS,
                    bwd_wide_bytes(width, hd))


# ---- K4: key-padding attention, optionally block-diagonal -----------------

DENSE_HEAD_DIMS = (32, 64)   # the head widths attention_dense compiles
DENSE_BF16_HEAD_DIMS = (64,)   # and its bf16 instances


def attention_dense_plain(qkv: torch.Tensor, key_valid: torch.Tensor,
                          nhead: int, block: int = 0, rate: float = 0.0,
                          seed: int = 0, drop=None, kernel: bool = True,
                          scale_ds: bool = True) -> torch.Tensor:
    """Plain PyTorch version of K4: key j is attendable by query i iff
    ``key_valid[j]`` and, with ``block > 0``, ``i // block == j // block``.
    A padding query attends its block's valid keys; a query whose block
    has no valid key gets exact zeros. At ``rate > 0`` K2's dropout mask
    (``keep_mask``) over the rows of qkv; ``drop`` (a function of the
    probabilities) replaces it, as the encoder's plain route does with
    ``ByteDropout``. Autograd differentiates it. qkv f32, or bf16: then it
    rounds where K4's bf16 kernels round, which are K2's points (the JAX
    kernels share ``_probs_all`` and ``attn_bwd_math``:
    ``_attention_k2_bf16``; K9's with ``scale_ds`` False), or with
    ``kernel`` False where the JAX package's XLA route rounds (the
    encoder's plain route, ``masked_attention``)."""
    B, S, _ = qkv.shape
    mask = key_valid.bool()[:, None, None, :]                 # [B, 1, 1, S]
    if block > 0:
        grp = torch.arange(S, device=qkv.device) // block
        mask = mask & (grp[:, None] == grp[None, :])
    if drop is None and rate > 0.0:
        drop = keep_drop(keep_mask(B, S, nhead, rate, seed, qkv.device), rate)
    mask = mask.expand(-1, 1, S, S)
    if qkv.dtype == torch.bfloat16 and kernel:
        return _attention_k2_bf16(qkv, nhead, mask, drop, scale_ds)
    return masked_attention(qkv, nhead, mask, drop)


def attention_dense_bwd_plain(qkv, key_valid, nhead, gout, block=0, rate=0.0,
                              seed=0):
    """Plain version of K4's backward: autograd through
    ``attention_dense_plain``. Returns dqkv [B, S, 3d]."""
    with torch.enable_grad():
        leaf = qkv.detach().requires_grad_()
        out = attention_dense_plain(leaf, key_valid, nhead, block, rate, seed)
        return torch.autograd.grad(out, leaf, gout)[0]


def _check_dense(qkv, key_valid, nhead, block, rate, gout=None):
    B, S, d3 = qkv.shape
    d = d3 // 3
    if d3 % 3 or d % nhead:
        raise ValueError(f"attention_dense: width {d3} is not 3*nhead*hd")
    if d // nhead not in DENSE_HEAD_DIMS:
        raise ValueError(f"attention_dense: head width {d // nhead}; the "
                         f"kernel is built for {DENSE_HEAD_DIMS}")
    if S > W_MAX:
        raise ValueError(f"attention_dense: rows of {S} > {W_MAX} tokens; "
                         f"the kernel is built for rows of up to {W_MAX}")
    if block < 0:
        raise ValueError(f"attention_dense: block {block} < 0")
    if not 0.0 <= rate < 1.0:
        raise ValueError(f"attention_dense: dropout rate {rate} not in [0, 1)")
    if qkv.dtype not in DTYPES or key_valid.dtype != torch.bool:
        raise ValueError("attention_dense: expected float32 or bfloat16 qkv, "
                         "bool key_valid")
    if qkv.dtype == torch.bfloat16 and d // nhead not in DENSE_BF16_HEAD_DIMS:
        raise ValueError(f"attention_dense: head width {d // nhead} in bf16; "
                         f"the bf16 kernels are built for "
                         f"{DENSE_BF16_HEAD_DIMS}")
    if tuple(key_valid.shape) != (B, S) or key_valid.device != qkv.device:
        raise ValueError(f"attention_dense: key_valid "
                         f"{tuple(key_valid.shape)} on {key_valid.device} "
                         f"does not match qkv")
    if gout is not None and (gout.dtype != qkv.dtype
                             or tuple(gout.shape) != (B, S, d)
                             or gout.device != qkv.device):
        raise ValueError(f"attention_dense_bwd: gout {gout.dtype} "
                         f"{tuple(gout.shape)} does not match the output")
    if not all(t.is_contiguous() for t in (qkv, gout) if t is not None):
        raise ValueError("attention_dense: inputs must be contiguous")
    if any(t.data_ptr() % 16 for t in (qkv, gout) if t is not None):
        raise ValueError("attention_dense: qkv and gout must be 16-byte "
                         "aligned (the backward loads four floats at a time)")


def attention_dense_with_stats(qkv: torch.Tensor, key_valid: torch.Tensor,
                               nhead: int, block: int = 0, rate: float = 0.0,
                               seed: int = 0, stats: bool = True):
    """K4's forward kernel on CUDA tensors: (out [B, S, d], m, l), with the
    softmax statistics m and l [B, S, H] that the backward reads (None,
    None when ``stats`` is False and ``rate`` 0: the serving launch writes
    none; with dropout the kernel always writes them). The instance
    (``dense_fwd_geometry``) is counted in ``attention_dense.instances``."""
    _check_dense(qkv, key_valid, nhead, block, rate)
    out, m, l = res = dense_fwd_launch(qkv, key_valid, nhead, block, rate,
                                       seed, stats)
    if out.numel():
        attention_dense.launches += 1
        attention_dense.instances[_dense_geometry(
            qkv, nhead, block, False, m is not None, rate).instance
            + _suffix(qkv)] += 1
    return res


def _suffix(qkv: torch.Tensor) -> str:
    """The counted instance's suffix: "_bf16" for the bf16 instances."""
    return "_bf16" if qkv.dtype == torch.bfloat16 else ""


def _dense_geometry(qkv, nhead, block, bwd, stats=True, rate=0.0):
    """The launch of K4 (K4-bwd with ``bwd``) on qkv [B, S, 3d]: the f32
    instances' (``dense_fwd_geometry``, ``dense_bwd_geometry``) or the bf16
    ones' (``list16_geometry``)."""
    B, S, d3 = qkv.shape
    hd = d3 // 3 // nhead
    if qkv.dtype == torch.bfloat16:
        return list16_geometry(B, S, block, nhead, bwd, hd)
    if bwd:
        return dense_bwd_geometry(B, S, block, hd, nhead)
    return dense_fwd_geometry(B, S, block, hd, nhead, stats, rate)


def dense_fwd_launch(qkv, key_valid, nhead, block, rate, seed, stats,
                     stride=0):
    """K4's forward kernel on checked CUDA tensors, uncounted, with the
    dropout seeds ``stride`` a tile (``keep_mask``), at
    ``dense_fwd_geometry``'s launch: the launch that
    ``attention_dense_with_stats`` counts, and that K10's layer makes.
    Dropout always writes the statistics."""
    B, S, d3 = qkv.shape
    out = torch.empty((B, S, d3 // 3), dtype=qkv.dtype, device=qkv.device)
    m = l = None
    stats = stats or rate > 0.0
    if stats:
        m = torch.empty((B, S, nhead), dtype=torch.float32, device=qkv.device)
        l = torch.empty_like(m)
    if out.numel() == 0:
        return out, m, l
    geo = _dense_geometry(qkv, nhead, block, False, stats, rate)
    valid = key_valid.contiguous()     # the bool itself: one byte a key
    ptr = lambda t: ctypes.c_void_p(None if t is None else t.data_ptr())
    lib = _load()
    entry = _build.entry(lib, "attention_dense_fwd", qkv.dtype)
    err = entry(
        ptr(qkv), ptr(valid), ptr(out), ptr(m), ptr(l), B, S, d3 // 3, nhead,
        block, *_dropout_args(S, rate, seed), stride or nhead, *geo.args(),
        _stream(qkv))
    _build.check(lib, err, entry.__name__)
    return out, m, l


class _AttentionDense(torch.autograd.Function):
    """K4 on CUDA tensors with K4's backward kernels as its gradient."""

    @staticmethod
    def forward(ctx, qkv, key_valid, nhead, block, rate, seed):
        out, m, l = attention_dense_with_stats(qkv, key_valid, nhead, block,
                                               rate, seed)
        ctx.save_for_backward(qkv, key_valid, out, m, l)
        ctx.args = (nhead, block, rate, seed)
        return out

    @staticmethod
    def backward(ctx, gout):
        qkv, key_valid, out, m, l = ctx.saved_tensors
        nhead, block, rate, seed = ctx.args
        return (attention_dense_bwd(qkv, key_valid, nhead, gout.contiguous(),
                                    block, rate, seed, saved=(out, m, l)),
                None, None, None, None, None)


def attention_dense(qkv: torch.Tensor, key_valid: torch.Tensor, nhead: int,
                    block: int = 0, rate: float = 0.0,
                    seed: int = 0) -> torch.Tensor:
    """K4 forward: qkv ``[B, S, 3d]`` (heads in lanes), key_valid bool
    ``[B, S]``, ``block`` 0 or the width of each graph in a graph-packed
    row, dropout ``rate`` (0 = none) drawn from ``seed``. CPU tensors take
    ``attention_dense_plain``; CUDA tensors launch the kernel or raise, and
    where a gradient is wanted the result carries K4's backward kernels
    (``attention_dense_bwd``)."""
    if qkv.device.type == "cpu":
        return attention_dense_plain(qkv, key_valid, nhead, block, rate, seed)
    if qkv.device.type != "cuda":
        raise ValueError(f"attention_dense: unsupported device {qkv.device}")
    if torch.is_grad_enabled() and qkv.requires_grad:
        _check_dense(qkv, key_valid, nhead, block, rate)
        return _AttentionDense.apply(qkv, key_valid, nhead, block, rate, seed)
    return attention_dense_with_stats(qkv, key_valid, nhead, block, rate,
                                      seed, stats=False)[0]


attention_dense.launches = 0
# launches by instance
attention_dense.instances = {"tile": 0, "long": 0, "tile_bf16": 0,
                             "long_bf16": 0}


def attention_dense_bwd(qkv: torch.Tensor, key_valid: torch.Tensor,
                        nhead: int, gout: torch.Tensor, block: int = 0,
                        rate: float = 0.0, seed: int = 0,
                        saved=None) -> torch.Tensor:
    """K4 backward: dqkv [B, S, 3d] for the cotangent ``gout`` [B, S, d] of
    ``attention_dense(qkv, key_valid, nhead, block, rate, seed)``, the
    dropout mask drawn again from ``seed``. ``saved`` is the forward's
    (out, m, l) from ``attention_dense_with_stats``, which the kernels
    read. CPU tensors take ``attention_dense_bwd_plain`` (no ``saved``);
    CUDA tensors launch the kernel (the instance ``dense_bwd_geometry``
    picks, counted in ``attention_dense_bwd.instances``) or raise."""
    if qkv.device.type == "cpu":
        return attention_dense_bwd_plain(qkv, key_valid, nhead, gout, block,
                                         rate, seed)
    if qkv.device.type != "cuda":
        raise ValueError(f"attention_dense_bwd: unsupported device "
                         f"{qkv.device}")
    _check_dense(qkv, key_valid, nhead, block, rate, gout)
    B, S, d3 = qkv.shape
    out, m, l = saved if saved is not None else (None, None, None)
    if not (m is not None and out.shape == gout.shape
            and tuple(m.shape) == tuple(l.shape) == (B, S, nhead)):
        raise ValueError("attention_dense_bwd: needs the forward's (out, m, "
                         "l) from attention_dense_with_stats")
    dqkv = dense_bwd_launch(qkv, key_valid, nhead, gout, block, rate, seed,
                            saved)
    attention_dense_bwd.launches += 1
    attention_dense_bwd.instances[_dense_geometry(
        qkv, nhead, block, True).instance + _suffix(qkv)] += 1
    return dqkv


def dense_bwd_launch(qkv, key_valid, nhead, gout, block, rate, seed, saved,
                     stride=0):
    """K4's backward kernel on checked CUDA tensors, uncounted (see
    ``dense_fwd_launch``), at ``dense_bwd_geometry``'s launch."""
    B, S, d3 = qkv.shape
    out, m, l = saved
    dqkv = torch.empty_like(qkv)
    if dqkv.numel() == 0:
        return dqkv
    if out.data_ptr() % 16:
        raise ValueError("attention_dense_bwd: the forward's output must be "
                         "16-byte aligned")
    geo = _dense_geometry(qkv, nhead, block, True)
    valid = key_valid.contiguous()
    lib = _load()
    ptrs = [qkv, valid, out, gout, m, l, dqkv]
    entry = lib.attention_dense_bwd
    if qkv.dtype == torch.bfloat16:
        # the f32 entry's parameters with the bf16 pair's delta [B, S, H]
        # before dqkv
        ptrs.insert(6, torch.empty_like(m))
        entry = lib.attention_dense_bwd_bf16
        if entry.argtypes is None:
            entry.argtypes = ([ctypes.c_void_p]
                              + lib.attention_dense_bwd.argtypes)
            entry.restype = ctypes.c_int
    err = entry(*(ctypes.c_void_p(t.data_ptr()) for t in ptrs),
                B, S, d3 // 3, nhead, block, *_dropout_args(S, rate, seed),
                stride or nhead, *geo.args(), _stream(qkv))
    _build.check(lib, err, entry.__name__)
    return dqkv


attention_dense_bwd.launches = 0
# launches by instance
attention_dense_bwd.instances = {"short": 0, "wide": 0, "short_bf16": 0,
                                 "long_bf16": 0}


def _load():
    lib = _build.load("attention_packed")
    if lib.attention_seg_fwd.argtypes is None:
        drop = [ctypes.c_int, ctypes.c_uint, ctypes.c_float, ctypes.c_int,
                ctypes.c_int, ctypes.c_int]
        lib.attention_dense_fwd.argtypes = ([ctypes.c_void_p] * 5
                                            + [ctypes.c_int] * 5 + drop
                                            + [ctypes.c_int] * 9
                                            + [ctypes.c_void_p])
        lib.attention_dense_fwd.restype = ctypes.c_int
        lib.attention_dense_bwd.argtypes = ([ctypes.c_void_p] * 7
                                            + [ctypes.c_int] * 5 + drop
                                            + [ctypes.c_int] * 9
                                            + [ctypes.c_void_p])
        lib.attention_dense_bwd.restype = ctypes.c_int
        lib.attention_seg_fwd.argtypes = ([ctypes.c_void_p] * 5
                                          + [ctypes.c_int] * 4 + drop
                                          + [ctypes.c_int] * 8
                                          + [ctypes.c_void_p])
        lib.attention_seg_fwd.restype = ctypes.c_int
        lib.attention_seg_bwd.argtypes = ([ctypes.c_void_p] * 8
                                          + [ctypes.c_int] * 4 + drop
                                          + [ctypes.c_int] * 8
                                          + [ctypes.c_void_p])
        lib.attention_seg_bwd.restype = ctypes.c_int
    return lib
