"""K9: per-head attention over unpacked rows with a key-padding mask and,
with ``block > 0``, a block-diagonal one, at any row width, with attention
dropout; and its backward.

qkv ``[B, S, 3d]`` is the combined projection output with heads in lanes,
as K4 and K5 take it; key_valid ``[B, S]`` bool. Key j is attendable by
query i iff ``key_valid[j]`` and, with ``block > 0``, ``i // block == j //
block``: K4's function (``attention_dense_plain``) at any S. A padding query
attends its block's valid keys; a query whose block has no valid key
outputs exact zeros. Output ``[B, S, d]``; the backward returns dqkv in the
combined ``[B, S, 3d]`` layout.

Dropout at ``rate > 0`` follows torch and the JAX kernel's seed schedule
(``graphtrans_tpu/ops/pallas/attention_smallS.py:_keep_mask`` over its
tiles of ``ht = max(1, min(16, 4096 // S))`` (batch, head) pairs): with
``p = b*H + h``, (b, h, i, j) is kept iff ``hash(pos, seed + p // ht) <
keep_threshold(rate)`` and ``pos = ((p % ht)*S + i)*S + j`` (int32
wrap-around). The JAX kernel draws from the TPU's own PRNG there; a test
that swaps its ``_keep_mask`` for its package's interpret-mode hash holds
the two to the same mask. The kernels and the plain version draw the same
mask; nothing is stored.

Replaces ``graphtrans_tpu/ops/pallas/attention_smallS.py:attention_smallS``:
the forward (``_fwd_kernel``) and the backward (``_bwd_kernel``), which take
per-head ``[B*H, S, hd]`` operands; the tests hold the plain version to
them by reshaping. It is the attention of ``--attn_backend smalls`` (block
0, unpacked rows of any width) and ``packed_smalls`` (graph-packed rows,
block = the graphs' width).

What bounds it on the H100: memory at the molecule shapes (4096 rows of 33
tokens, d 256, 4 heads of 64: q in and out back for every query, K and V
for the valid keys, ~0.15 ms; the pairs need ~3.8 GFLOP, as K4's), and
operations at code2's rows of 1001 (K5's shape). Design: the forward has
two hand-written instances, picked by the span width (a graph block, or
the row at block 0; ``fwd_geometry``, K4's ``dense_fwd_geometry``). Spans
of up to ``tile_max(hd)``
tokens (128; 112 at hd 128, where a span's Q, K, V and scores no longer
fit a block's shared memory) take the whole-tile body of
``csrc/attention_tile.cuh``: Q, K and V of the span staged once, the
scores once into a shared tile by register-blocked micro-tiles, an exact
two-pass softmax per query row, then O = P_drop V / l; several spans a
block where one is small. Wider spans take K5's long-row body
(``csrc/attention_fwd.cuh``: one block of four warps per (row, head, 64
queries), the keys its queries can meet gathered 64 at a time by rank, a
warp's 16 query rows whole in its registers, S = Q K^T and O += P_drop V
on the tensor cores in 3xTF32). Both write the m and l that the backward reads, with
the meaning ``attention_fwd.cuh`` gives them. The backward has three
instances, picked by span width and head width (``bwd_geometry``): spans of
up to SHORT_MAX (64) tokens take ``attention_tile.cuh``'s short backward
(K4-bwd's: each span's Q, K, V and dO staged once, each pair evaluated
once, delta = dO.O computed in the kernel, several spans a block); spans
of up to 384 at hd 32 and 64 its wide one (64-token tiles, the span's dQ
in shared memory); the rest (code2's rows of 513 and 1001; hd 128 above 64
tokens, where the wide one does not fit a block) the long-row pair of
``csrc/attention_bwd.cuh`` that K5-bwd runs, with K4's mask as tags
(``PadTags``). Each instance is its own ``__global__`` in
``csrc/attention_smalls.cu`` with K9's seed schedule as the dropout
policy. Heads of width 32, 64 and 128.

bf16 (the bf16 step of the Transformer-only model under ``smalls`` and
``packed_smalls``, heads of 64): the JAX kernel asks for precision DEFAULT
(one bf16 MXU pass) on bf16 inputs, so its products round their operands
to bf16 on the TPU: the normalised, dropped p before P V, P_drop before
dV, and dS = p (dp_drop - delta) (delta from the pairs with the undropped
p) before dQ and dK, which are scaled after their sums. The plain version
rounds at the same points (``attention_smalls_plain``). The kernels are
K4's bf16 instances' key-list bodies (``csrc/attention_list16.cuh``) at
their launch (``attention_packed.list16_geometry``; the forward one body,
counted ``tile_bf16`` on spans of up to 128 tokens and ``long_bf16``
above; the backward ``short_bf16``, a span of up to 64 tokens whole in one
kernel, or ``long_bf16``, the dq and dk/dv pair), with K9's tags (K4's),
its dropout schedule split into a query's and a key's part, and its
rounding of dS. They draw the f32 instances' mask.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .attention_packed import (DTYPES, LONG_T, LONG_THREADS, SHORT_MAX,
                               SMEM_MAX, TILE_THREADS, WIDE, W_MAX, Geometry,
                               _round, _stream, attention_dense_plain,
                               bwd_short_bytes, bwd_wide_bytes,
                               dense_fwd_geometry, fwd_tile_bytes, hash_bits,
                               keep_drop, keep_threshold, list16_geometry,
                               long_bwd_bytes, row_spans, tile_launch,
                               tile_max)
from .flash_attention import HEAD_DIMS, PLAIN_SCORE_BYTES, _dropout_args


WIDE_HEAD_DIMS = (32, 64)  # the head widths of the wide backward
BF16_HEAD_DIMS = (64,)     # the head widths of the bf16 instances

# K9's forward launch is K4's at any S: the tile instance up to tile_max(hd)
# tokens, the long one above
fwd_geometry = dense_fwd_geometry


def bwd_geometry(B: int, S: int, block: int, hd: int,
                 nhead: int) -> Geometry:
    """K9-bwd's launch for rows of S tokens, by the width of the spans of
    ``row_spans(S, block)`` and the head width: up to SHORT_MAX tokens the
    short instance (whole spans, ``group`` a block), up to W_MAX at hd 32
    and 64 the wide one (a span a block of 256 threads, 64-token tiles),
    else the long one (a block per (row, head, 64 tokens), two kernels)."""
    spans = row_spans(S, block)
    width = spans[0][1] - spans[0][0]
    problems = B * len(spans) * nhead
    if width <= SHORT_MAX:
        return tile_launch("short", spans, bwd_short_bytes(_round(width, 4),
                                                           hd), problems)
    if width <= W_MAX and hd in WIDE_HEAD_DIMS:
        return Geometry("wide", spans, WIDE, 1, (problems, 1, 1),
                        TILE_THREADS, bwd_wide_bytes(width, hd))
    return Geometry("long", spans, LONG_T, 1, (B, nhead, -(-S // LONG_T)),
                    LONG_THREADS, long_bwd_bytes(hd))


def pairs_per_tile(S: int) -> int:
    """The JAX kernel's ``_ht``: (batch, head) pairs a program."""
    return max(1, min(16, 4096 // max(S, 1)))


def keep_mask(rows: torch.Tensor, S: int, nhead: int, rate: float,
              seed: int) -> torch.Tensor:
    """Bool ``[len(rows), H, S, S]``: query i keeps key j of row
    ``rows[n]`` and head h under K9's seed schedule. Drawn with torch on the
    rows' device."""
    dev = rows.device
    ht = pairs_per_tile(S)
    p = (rows[:, None] * nhead + torch.arange(nhead, device=dev))[:, :, None,
                                                                    None]
    i = torch.arange(S, device=dev)[:, None]
    j = torch.arange(S, device=dev)[None, :]
    pos = ((p % ht) * S + i) * S + j                          # [b, H, S, S]
    s = (seed % 2**32 + p // ht) & 0xFFFFFFFF                 # [b, H, 1, 1]
    return hash_bits(pos, s) < keep_threshold(rate)


def attention_smalls_plain(qkv: torch.Tensor, key_valid: torch.Tensor,
                           nhead: int, block: int = 0, rate: float = 0.0,
                           seed: int = 0) -> torch.Tensor:
    """Plain PyTorch version of K9: K4's masked softmax with K9's dropout
    mask at ``rate > 0``, taken a few rows at a time so the ``[rows, H, S,
    S]`` scores stay within ``PLAIN_SCORE_BYTES``. Autograd differentiates
    it. A bf16 qkv rounds where the JAX kernel rounds in bf16 on the TPU
    (``attention_smallS.py:_probs``, ``_fwd_kernel``, ``_bwd_kernel``:
    scores from the bf16 operands summed in float32, the normalised,
    dropped p rounded before P V; the backward's delta from the pairs with
    the undropped p, dS = p (dp_drop - delta) rounded before its products,
    which are scaled after their sums): ``attention_dense_plain``'s bf16
    version with ``scale_ds`` False."""
    B, S, _ = qkv.shape
    step = max(1, PLAIN_SCORE_BYTES // (nhead * S * S * 4))
    outs = []
    for b0 in range(0, B, step):
        drop = None
        if rate > 0.0:
            rows = torch.arange(b0, min(B, b0 + step), device=qkv.device)
            drop = keep_drop(keep_mask(rows, S, nhead, rate, seed), rate)
        outs.append(attention_dense_plain(qkv[b0:b0 + step],
                                          key_valid[b0:b0 + step], nhead,
                                          block, drop=drop, scale_ds=False))
    return outs[0] if len(outs) == 1 else torch.cat(outs)


def attention_smalls_bwd_plain(qkv, key_valid, nhead, gout, block=0,
                               rate=0.0, seed=0):
    """Plain version of K9's backward: autograd through
    ``attention_smalls_plain``. Returns dqkv [B, S, 3d]."""
    with torch.enable_grad():
        leaf = qkv.detach().requires_grad_()
        out = attention_smalls_plain(leaf, key_valid, nhead, block, rate,
                                     seed)
        return torch.autograd.grad(out, leaf, gout)[0]


def _check(qkv, key_valid, nhead, block, rate, gout=None):
    B, S, d3 = qkv.shape
    d = d3 // 3
    if d3 % 3 or d % nhead:
        raise ValueError(f"attention_smalls: width {d3} is not 3*nhead*hd")
    dims = BF16_HEAD_DIMS if qkv.dtype == torch.bfloat16 else HEAD_DIMS
    if d // nhead not in dims:
        raise ValueError(f"attention_smalls: head width {d // nhead} in "
                         f"{qkv.dtype}; the kernel is built for {dims}")
    if block < 0:
        raise ValueError(f"attention_smalls: block {block} < 0")
    if not 0.0 <= rate < 1.0:
        raise ValueError(f"attention_smalls: dropout rate {rate} not in "
                         f"[0, 1)")
    if qkv.dtype not in DTYPES or key_valid.dtype != torch.bool:
        raise ValueError("attention_smalls: expected float32 or bfloat16 "
                         "qkv, bool key_valid")
    if tuple(key_valid.shape) != (B, S) or key_valid.device != qkv.device:
        raise ValueError(f"attention_smalls: key_valid "
                         f"{tuple(key_valid.shape)} on {key_valid.device} "
                         f"does not match qkv")
    if gout is not None and (gout.dtype != qkv.dtype
                             or tuple(gout.shape) != (B, S, d)
                             or gout.device != qkv.device):
        raise ValueError(f"attention_smalls_bwd: gout {gout.dtype} "
                         f"{tuple(gout.shape)} does not match the output")
    if not all(t.is_contiguous() for t in (qkv, gout) if t is not None):
        raise ValueError("attention_smalls: inputs must be contiguous")
    if any(t.data_ptr() % 16 for t in (qkv, gout) if t is not None):
        raise ValueError("attention_smalls: qkv and gout must be 16-byte "
                         "aligned (the kernels load 16 bytes at a time)")


def _geometry(qkv: torch.Tensor, nhead: int, block: int, bwd: bool,
              stats: bool = True, rate: float = 0.0) -> Geometry:
    """The launch of K9 (K9-bwd with ``bwd``) on qkv [B, S, 3d]: the f32
    instances' (``fwd_geometry``, ``bwd_geometry``) or the bf16 ones'
    (``attention_packed.list16_geometry``, K4's bf16 launch)."""
    B, S, d3 = qkv.shape
    hd = d3 // 3 // nhead
    if qkv.dtype == torch.bfloat16:
        return list16_geometry(B, S, block, nhead, bwd, hd)
    if bwd:
        return bwd_geometry(B, S, block, hd, nhead)
    return fwd_geometry(B, S, block, hd, nhead, stats, rate)


def _suffix(qkv: torch.Tensor) -> str:
    """The counted instance's suffix: "_bf16" for the bf16 instances."""
    return "_bf16" if qkv.dtype == torch.bfloat16 else ""


def attention_smalls_with_stats(qkv: torch.Tensor, key_valid: torch.Tensor,
                                nhead: int, block: int = 0,
                                rate: float = 0.0, seed: int = 0,
                                stats: bool = True):
    """K9's forward kernel on CUDA tensors: (out [B, S, d], m, l), with the
    softmax statistics m and l [B, S, H] that the backward reads (None,
    None when ``stats`` is False and ``rate`` 0: the serving launch writes
    none; with dropout the kernel always writes them). The instance
    (``fwd_geometry``; in bf16 ``list16_geometry``) is counted in
    ``attention_smalls.instances``."""
    _check(qkv, key_valid, nhead, block, rate)
    B, S, d3 = qkv.shape
    out = torch.empty((B, S, d3 // 3), dtype=qkv.dtype, device=qkv.device)
    m = l = None
    stats = stats or rate > 0.0
    if stats:
        m = torch.empty((B, S, nhead), dtype=torch.float32, device=qkv.device)
        l = torch.empty_like(m)
    if out.numel() == 0:
        return out, m, l
    geo = _geometry(qkv, nhead, block, False, stats, rate)
    valid = key_valid.contiguous()     # the bool itself: one byte a key
    ptr = lambda t: ctypes.c_void_p(None if t is None else t.data_ptr())
    lib = _load()
    entry = _build.entry(lib, "attention_smalls_fwd", qkv.dtype)
    err = entry(
        ptr(qkv), ptr(valid), ptr(out), ptr(m), ptr(l), B, S, d3 // 3, nhead,
        block, *_dropout_args(rate, seed), *geo.args(), _stream(qkv))
    _build.check(lib, err, entry.__name__)
    attention_smalls.launches += 1
    attention_smalls.instances[geo.instance + _suffix(qkv)] += 1
    return out, m, l


class _AttentionSmalls(torch.autograd.Function):
    """K9 on CUDA tensors with K9's backward kernels as its gradient."""

    @staticmethod
    def forward(ctx, qkv, key_valid, nhead, block, rate, seed):
        out, m, l = attention_smalls_with_stats(qkv, key_valid, nhead, block,
                                                rate, seed)
        ctx.save_for_backward(qkv, key_valid, out, m, l)
        ctx.args = (nhead, block, rate, seed)
        return out

    @staticmethod
    def backward(ctx, gout):
        qkv, key_valid, out, m, l = ctx.saved_tensors
        nhead, block, rate, seed = ctx.args
        return (attention_smalls_bwd(qkv, key_valid, nhead,
                                     gout.contiguous(), block, rate, seed,
                                     saved=(out, m, l)),
                None, None, None, None, None)


def attention_smalls(qkv: torch.Tensor, key_valid: torch.Tensor, nhead: int,
                     block: int = 0, rate: float = 0.0,
                     seed: int = 0) -> torch.Tensor:
    """K9 forward: qkv ``[B, S, 3d]`` (heads in lanes), key_valid bool
    ``[B, S]``, ``block`` 0 or the width of each graph in a graph-packed
    row, dropout ``rate`` (0 = none) drawn from ``seed``. CPU tensors take
    ``attention_smalls_plain``; CUDA tensors launch the kernel or raise, and
    where a gradient is wanted the result carries K9's backward kernels
    (``attention_smalls_bwd``)."""
    if qkv.device.type == "cpu":
        return attention_smalls_plain(qkv, key_valid, nhead, block, rate,
                                      seed)
    if qkv.device.type != "cuda":
        raise ValueError(f"attention_smalls: unsupported device {qkv.device}")
    if torch.is_grad_enabled() and qkv.requires_grad:
        _check(qkv, key_valid, nhead, block, rate)
        return _AttentionSmalls.apply(qkv, key_valid, nhead, block, rate,
                                      seed)
    return attention_smalls_with_stats(qkv, key_valid, nhead, block, rate,
                                       seed, stats=False)[0]


attention_smalls.launches = 0
# launches by instance
attention_smalls.instances = {"tile": 0, "long": 0, "tile_bf16": 0,
                              "long_bf16": 0}


def attention_smalls_bwd(qkv: torch.Tensor, key_valid: torch.Tensor,
                         nhead: int, gout: torch.Tensor, block: int = 0,
                         rate: float = 0.0, seed: int = 0,
                         saved=None) -> torch.Tensor:
    """K9 backward: dqkv [B, S, 3d] for the cotangent ``gout`` [B, S, d] of
    ``attention_smalls(qkv, key_valid, nhead, block, rate, seed)``, the
    dropout mask drawn again from ``seed``. ``saved`` is the forward's
    (out, m, l) from ``attention_smalls_with_stats``, which the kernels
    read. CPU tensors take ``attention_smalls_bwd_plain`` (no ``saved``);
    CUDA tensors launch the instance of ``bwd_geometry`` or raise; it is
    counted in ``attention_smalls_bwd.instances``."""
    if qkv.device.type == "cpu":
        return attention_smalls_bwd_plain(qkv, key_valid, nhead, gout, block,
                                          rate, seed)
    if qkv.device.type != "cuda":
        raise ValueError(f"attention_smalls_bwd: unsupported device "
                         f"{qkv.device}")
    _check(qkv, key_valid, nhead, block, rate, gout)
    B, S, d3 = qkv.shape
    out, m, l = saved if saved is not None else (None, None, None)
    if not (m is not None and out.shape == gout.shape
            and tuple(m.shape) == tuple(l.shape) == (B, S, nhead)):
        raise ValueError("attention_smalls_bwd: needs the forward's (out, m, "
                         "l) from attention_smalls_with_stats")
    dqkv = torch.empty_like(qkv)
    if dqkv.numel() == 0:
        return dqkv
    geo = _geometry(qkv, nhead, block, True)
    # delta passes between the long instances' two kernels (f32: dO.O; bf16:
    # summed from the pairs); the tile instances compute it themselves
    delta = torch.empty_like(m) if geo.instance == "long" else None
    valid = key_valid.contiguous()
    ptr = lambda t: ctypes.c_void_p(None if t is None else t.data_ptr())
    lib = _load()
    entry = _build.entry(lib, "attention_smalls_bwd", qkv.dtype)
    err = entry(
        *(ptr(t) for t in (qkv, valid, out, gout, m, l, delta, dqkv)),
        B, S, d3 // 3, nhead, block, *_dropout_args(rate, seed), *geo.args(),
        _stream(qkv))
    _build.check(lib, err, entry.__name__)
    attention_smalls_bwd.launches += 1
    attention_smalls_bwd.instances[geo.instance + _suffix(qkv)] += 1
    return dqkv


attention_smalls_bwd.launches = 0
attention_smalls_bwd.instances = {"short": 0, "wide": 0, "long": 0,
                                  "short_bf16": 0, "long_bf16": 0}


def _load():
    lib = _build.load("attention_smalls")
    if lib.attention_smalls_fwd.argtypes is None:
        drop = [ctypes.c_int, ctypes.c_uint, ctypes.c_float, ctypes.c_int]
        lib.attention_smalls_fwd.argtypes = ([ctypes.c_void_p] * 5
                                             + [ctypes.c_int] * 5 + drop
                                             + [ctypes.c_int] * 8
                                             + [ctypes.c_void_p])
        lib.attention_smalls_fwd.restype = ctypes.c_int
        lib.attention_smalls_bwd.argtypes = ([ctypes.c_void_p] * 8
                                             + [ctypes.c_int] * 5 + drop
                                             + [ctypes.c_int] * 8
                                             + [ctypes.c_void_p])
        lib.attention_smalls_bwd.restype = ctypes.c_int
    return lib
