"""K10: one post-norm transformer encoder layer over graph-packed rows, with
its three dropouts and attention dropout; and its backward.

x ``[B, S, d]`` holds B packed rows of S tokens (graphs of ``block`` tokens
each), key_valid ``[B, S]`` bool, and ``params`` the layer's twelve tensors
in ``torch.nn`` layout: in_proj weight ``[3d, d]`` and bias, out_proj weight
``[d, d]`` and bias, LayerNorm 1 scale and bias, linear 1 weight ``[ff, d]``
and bias, linear 2 weight ``[d, ff]`` and bias, LayerNorm 2 scale and bias
(``PARAM_NAMES``). The function (``graphtrans_tpu/ops/pallas/
transformer_layer.py:_layer_fwd_core``):

    qkv = x Wqkv^T + b;  ao = attention(qkv) (K4's block-diagonal mask)
    y1  = LN1(x + drop1(ao Wout^T + b))
    y   = LN2(y1 + drop3(drop2(relu(y1 W1^T + b1)) W2^T + b2))

with the reference's LayerNorm: fast variance ``max(E[h^2] - mu^2, 0)``,
eps 1e-5 (not ``nn.LayerNorm``'s two-pass variance).

Dropout (``_fwd_kernel``, ``_keep``): the reference's programs take 8
packed rows, and row r's tile seeds from ``base = seed + (r // 8)*(H +
3)``. Attention head h keeps K4's mask drawn from ``base + h``
(``attention_packed.keep_mask`` with ``stride = H + 3``); drop1, drop2 and
drop3 keep element (r, t, c) of their ``[B, S, width]`` tensor iff
``hash(((r % 8)*S + t)*width + c, base + H + k) < keep_threshold(rate)``
for k = 0, 1, 2: exact u32 thresholds, not ``ByteDropout``'s 1/256. The
kernels and the plain version draw the same masks; nothing is stored.

Replaces ``graphtrans_tpu/ops/pallas/transformer_layer.py:
fused_transformer_layer``: the forward (``_fwd_kernel``) and the backward
(``_bwd_kernel``, dx and all twelve parameter gradients). It is the layer
of ``set_attn_backend(model, "packed_layer")`` on rows of at most 128
tokens with ``d % 128 == 0``.

What bounds it on the H100: operations. At 4096 molecules (1366 rows of 99
tokens, d 256, ff 512) the products need 2 T (3d^2 + d^2 + 2 d ff) = 1.42e11
flops forward, ~2.1 ms at 67 TFLOP/s in f32 outside the tensor cores and
~0.86 ms as 3xTF32 on them (three TF32 passes at 495 TFLOP/s), and twice
that backward; the bytes (~1.1 GB forward) take ~0.3 ms. Design: a chain of
hand-written launches, not one kernel: a 99 x 768 qkv tile does not fit a
block's shared memory, and each product wants a grid of its own.
``csrc/transformer_layer.cu``: a tiled product with its epilogue fused
(bias, relu, dropout, residual), a LayerNorm a warp a row, and
deterministic column sums; the attention is K4's forward and backward
kernels (``csrc/attention_packed.cu``) with K10's seed stride. The product
runs on the tensor cores with f32 accuracy: 128 x 64 tiles of C, K in
slices of 32 through a ring of three ``cp.async`` stages in shared memory,
each product ``mma.sync`` m16n8k8 in 3xTF32 (every operand split into a
TF32 high part and remainder, three products summed in f32), a slice's
sums added to the accumulators in f32;
``gemm_geometry`` mirrors its launch. The backward keeps the forward's
intermediates (qkv, the attention output and statistics, the LayerNorms'
normalised inputs and 1/sigma, y1 and the dropped FF activation) instead
of recomputing them, which the TPU kernel did for its VMEM; weight
gradients are products split over rows into partials that one pass sums
in order, as are the column sums, so a kernel run gives the same bits
every time. No library call computes any product, LayerNorm or dropout on
this route.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .attention_packed import (DENSE_HEAD_DIMS, _stream,
                               attention_dense_plain, dense_bwd_launch,
                               dense_fwd_launch, hash_bits, keep_drop,
                               keep_mask, keep_threshold)

EPS = 1e-5           # the reference's LayerNorm eps
TILE_ROWS = 8        # packed rows a program of the reference (its BT)
STREAMS = 3          # dropout streams after the heads'
PARAM_NAMES = ("in_proj.weight", "in_proj.bias", "out_proj.weight",
               "out_proj.bias", "norm1.weight", "norm1.bias",
               "linear1.weight", "linear1.bias", "linear2.weight",
               "linear2.bias", "norm2.weight", "norm2.bias")
# layer_gemm's layouts and epilogues (csrc/transformer_layer.cu)
NT, NN, TN = 0, 1, 2
EPI_NONE, EPI_BIAS, EPI_BIAS_DROP_RES, EPI_BIAS_RELU_DROP, EPI_RES, \
    EPI_DRELU = range(6)
BLOCKS_SM = 528      # blocks a split product or column sum aims for
# layer_gemm's launch (csrc/transformer_layer.cu): a GEMM_BM x GEMM_BN tile of
# C a block, K in slices of GEMM_BK through GEMM_STAGES shared stages, two
# blocks an SM
GEMM_BM, GEMM_BN, GEMM_BK = 128, 64, 32
GEMM_STAGES, GEMM_THREADS, GEMM_MIN_BLOCKS = 3, 128, 2
SM_SHARED = 233472   # shared bytes an SM (228 KB), 1 KB of it per block


def layer_keep(B: int, S: int, width: int, nhead: int, rate: float,
               seed: int, stream: int, device) -> torch.Tensor:
    """Bool [B, S, width]: K10's dropout stream ``stream`` (0, 1, 2: drop1,
    drop2, drop3) keeps element (r, t, c)."""
    r = torch.arange(B, device=device)[:, None, None]
    t = torch.arange(S, device=device)[None, :, None]
    c = torch.arange(width, device=device)[None, None, :]
    pos = ((r % TILE_ROWS) * S + t) * width + c
    s = (seed % 2**32 + (r // TILE_ROWS) * (nhead + STREAMS) + nhead
         + stream) & 0xFFFFFFFF
    return hash_bits(pos, s) < keep_threshold(rate)


def layer_norm_plain(h: torch.Tensor, scale: torch.Tensor,
                     bias: torch.Tensor) -> torch.Tensor:
    """The reference's LayerNorm: fast variance, eps ``EPS``."""
    mu = h.mean(-1, keepdim=True)
    var = ((h * h).mean(-1, keepdim=True) - mu * mu).clamp_min(0.0)
    return (h - mu) * torch.rsqrt(var + EPS) * scale + bias


def transformer_layer_plain(x: torch.Tensor, key_valid: torch.Tensor,
                            params, nhead: int, block: int,
                            rate: float = 0.0, seed: int = 0,
                            relu_mask=None) -> torch.Tensor:
    """Plain PyTorch version of K10: the layer composed in PyTorch with K10's
    masks and LayerNorm formula. Autograd differentiates it.

    ``relu_mask`` (bool [B, S, ff]) takes relu's side from the mask instead
    of the pre-activation's sign, for holding K10-bwd to this version on the
    kernel's own decisions (``relu_side``): relu's derivative jumps at 0,
    and a pre-activation within f32 rounding of 0 (about one in a million
    at these widths) may fall on either side in two correct f32
    computations, moving a whole row of the gradients by O(1)."""
    (wqkv, bqkv, wout, bout, s1, b1, w1, bf1, w2, bf2, s2,
     b2) = params
    B, S, d = x.shape
    drop = lambda t, k: t
    attn_drop = None
    if rate > 0.0:
        dev = x.device
        attn_drop = keep_drop(keep_mask(B, S, nhead, rate, seed, dev,
                                        stride=nhead + STREAMS), rate)
        drop = lambda t, k: keep_drop(layer_keep(
            B, S, t.shape[-1], nhead, rate, seed, k, dev), rate)(t)
    qkv = torch.nn.functional.linear(x, wqkv, bqkv)
    ao = attention_dense_plain(qkv, key_valid, nhead, block, drop=attn_drop)
    y1 = layer_norm_plain(
        x + drop(torch.nn.functional.linear(ao, wout, bout), 0), s1, b1)
    z = torch.nn.functional.linear(y1, w1, bf1)
    f = drop(torch.relu(z) if relu_mask is None else z * relu_mask, 1)
    return layer_norm_plain(
        y1 + drop(torch.nn.functional.linear(f, w2, bf2), 2), s2, b2)


def transformer_layer_bwd_plain(x, key_valid, params, nhead, block, gout,
                                rate=0.0, seed=0, relu_mask=None):
    """Plain version of K10's backward: autograd through
    ``transformer_layer_plain``. Returns (dx, the twelve parameter
    gradients)."""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_() for t in (x, *params)]
        out = transformer_layer_plain(leaves[0], key_valid, leaves[1:], nhead,
                                      block, rate, seed, relu_mask)
        return torch.autograd.grad(out, leaves, gout)


def relu_side(saved, shape) -> torch.Tensor:
    """The relu decisions of a K10 forward (``transformer_layer_saved``'s
    saved state) as a bool ``shape`` [B, S, ff]: the dropped FF activation
    is > 0 exactly where relu passed and dropout kept, and a dropped
    element's gradient is 0 on either side."""
    return (saved[7] > 0).view(shape)


def _check(x, key_valid, params, nhead, block, rate, gout=None):
    B, S, d = x.shape
    if d % 128 or S > 128 or block <= 0:
        raise ValueError(f"transformer_layer: rows of {S} tokens at d {d}, "
                         f"block {block}; the kernel takes d % 128 == 0, "
                         f"rows of at most 128 and block > 0")
    if len(params) != len(PARAM_NAMES):
        raise ValueError(f"transformer_layer: {len(params)} parameters, "
                         f"expected {len(PARAM_NAMES)}")
    ff = params[6].shape[0]
    shapes = ((3 * d, d), (3 * d,), (d, d), (d,), (d,), (d,), (ff, d), (ff,),
              (d, ff), (d,), (d,), (d,))
    for name, p, shape in zip(PARAM_NAMES, params, shapes):
        if (tuple(p.shape) != shape or p.dtype != torch.float32
                or p.device != x.device or not p.is_contiguous()
                or p.data_ptr() % 16):
            raise ValueError(f"transformer_layer: {name} {p.dtype} "
                             f"{tuple(p.shape)} on {p.device} is not a "
                             f"contiguous, aligned float32 {shape}")
    if x.dtype != torch.float32 or not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError("transformer_layer: x must be contiguous, 16-byte "
                         "aligned float32")
    if gout is not None and (gout.dtype != torch.float32
                             or gout.shape != x.shape
                             or not gout.is_contiguous()
                             or gout.data_ptr() % 16):
        raise ValueError("transformer_layer_bwd: gout must match x")
    if d % nhead or d // nhead not in DENSE_HEAD_DIMS:
        raise ValueError(f"transformer_layer: head width {d / nhead}; K4's "
                         f"kernels are built for {DENSE_HEAD_DIMS}")
    if not 0.0 <= rate < 1.0:
        raise ValueError(f"transformer_layer: dropout rate {rate} not in "
                         f"[0, 1)")
    if (key_valid.dtype != torch.bool or tuple(key_valid.shape) != (B, S)
            or key_valid.device != x.device):
        raise ValueError(f"transformer_layer: key_valid {key_valid.dtype} "
                         f"{tuple(key_valid.shape)} does not match x")


def _drop_args(rate: float, seed: int, stream: int, nhead: int, S: int):
    """(on, thresh, inv_keep, seed32 + stream offset, S, stride) of stream
    ``stream`` for the C entries."""
    on = rate > 0.0
    s = (int(seed) + nhead + stream + 2**31) % 2**32 - 2**31
    return (int(on), ctypes.c_uint(keep_threshold(rate) if on else 0),
            ctypes.c_float(1.0 / (1.0 - rate)), s, S, nhead + STREAMS)


def gemm_geometry(M: int, N: int, K: int, layout: int, splits: int = 1):
    """layer_gemm's launch for C [M, N] over a reduction of K in
    ``layout`` (NT, NN, TN) with ``splits`` partials: (grid, threads, dynamic
    shared bytes, K a split, blocks an SM by shared memory and launch
    bounds). A stage holds the A tile (GEMM_BM rows of C) and the B tile
    (GEMM_BN columns), each as rows of GEMM_BK + 8 floats where its rows run
    along K, else GEMM_BK rows of its width + 4."""
    tile = lambda krows, rows: (GEMM_BK * (rows + 4) if krows
                                else rows * (GEMM_BK + 8))
    smem = GEMM_STAGES * (tile(layout == TN, GEMM_BM)
                          + tile(layout != NT, GEMM_BN)) * 4
    kchunk = -(-(-(-K // splits)) // GEMM_BK) * GEMM_BK
    grid = (-(-N // GEMM_BN), -(-M // GEMM_BM), splits)
    blocks = min(GEMM_MIN_BLOCKS, SM_SHARED // (smem + 1024))
    return grid, GEMM_THREADS, smem, kchunk, blocks


_NO_DROP = (0, ctypes.c_uint(0), ctypes.c_float(1.0), 0, 1, 1)
_ptr = lambda t: ctypes.c_void_p(None if t is None else t.data_ptr())


def _gemm(lib, a, b, M, N, K, layout, epi=EPI_NONE, bias=None, res=None,
          drop=_NO_DROP, splits=1):
    """layer_gemm into a new [splits, M, N] (or [M, N]) tensor."""
    out = torch.empty((splits, M, N) if splits > 1 else (M, N),
                      dtype=torch.float32, device=a.device)
    err = lib.layer_gemm(_ptr(a), _ptr(b), _ptr(out), M, N, K, layout, splits,
                         epi, _ptr(bias), _ptr(res), *drop, _stream(a))
    _build.check(lib, err, "layer_gemm")
    return out


def _weight_grad(lib, g, a):
    """dW [N, K] = g^T a for g [M, N], a [M, K]: a product split over the
    rows into partials, summed in order."""
    M, N = g.shape
    K = a.shape[1]
    tiles = -(-N // 128) * -(-K // 128)
    splits = max(1, min(-(-BLOCKS_SM // tiles), -(-M // 256)))
    part = _gemm(lib, g, a, N, K, M, TN, splits=splits)
    if splits == 1:
        return part
    out = torch.empty((N, K), dtype=torch.float32, device=g.device)
    err = lib.layer_sum(_ptr(part), _ptr(out), splits, N * K, _stream(g))
    _build.check(lib, err, "layer_sum")
    return out


def _row_blocks(M: int):
    """(blocks, rows a block) of a column sum over M rows."""
    blocks = max(1, min(BLOCKS_SM, -(-M // 8)))
    return blocks, -(-M // blocks)


def _colsum(lib, x):
    M, N = x.shape
    blocks, rows = _row_blocks(M)
    part = torch.empty((blocks, N), dtype=torch.float32, device=x.device)
    out = torch.empty(N, dtype=torch.float32, device=x.device)
    err = lib.layer_colsum(_ptr(x), _ptr(part), _ptr(out), M, N, blocks, rows,
                           _stream(x))
    _build.check(lib, err, "layer_colsum")
    return out


def _norm(lib, h, scale, bias, save: bool):
    """(y, xhat, iv): LayerNorm of h [M, d]; xhat and iv None unless
    ``save``."""
    M, d = h.shape
    y = torch.empty_like(h)
    xhat = torch.empty_like(h) if save else None
    iv = h.new_empty(M) if save else None
    err = lib.layer_norm_fwd(_ptr(h), _ptr(scale), _ptr(bias), _ptr(y),
                             _ptr(xhat), _ptr(iv), M, d, ctypes.c_float(EPS),
                             _stream(h))
    _build.check(lib, err, "layer_norm_fwd")
    return y, xhat, iv


def _norm_bwd(lib, dy, xhat, iv, scale, drop):
    """(dh, drop(dh), dscale, dbias, the column sums of drop(dh))."""
    M, d = dy.shape
    blocks, rows = _row_blocks(M)
    dh, dd = torch.empty_like(dy), torch.empty_like(dy)
    part = dy.new_empty((blocks, 3, d))
    out = dy.new_empty((3, d))
    err = lib.layer_norm_bwd(_ptr(dy), _ptr(xhat), _ptr(iv), _ptr(scale),
                             _ptr(dh), _ptr(dd), _ptr(part), _ptr(out), M, d,
                             blocks, rows, *drop, _stream(dy))
    _build.check(lib, err, "layer_norm_bwd")
    return dh, dd, out[0], out[1], out[2]


def _forward(x, key_valid, params, nhead, block, rate, seed, save: bool):
    """The forward chain on checked CUDA tensors: y [B, S, d] and, with
    ``save``, what the backward reads."""
    (wqkv, bqkv, wout, bout, s1, b1, w1, bf1, w2, bf2, s2,
     b2) = params
    B, S, d = x.shape
    M, ff = B * S, w1.shape[0]
    lib = _load()
    drop = lambda k: _drop_args(rate, seed, k, nhead, S)
    x2 = x.reshape(M, d)
    qkv = _gemm(lib, x2, wqkv, M, 3 * d, d, NT, EPI_BIAS, bqkv)
    ao, m, l = dense_fwd_launch(qkv.view(B, S, 3 * d), key_valid, nhead,
                                block, rate, seed, save,
                                stride=nhead + STREAMS)
    ao = ao.view(M, d)
    h1 = _gemm(lib, ao, wout, M, d, d, NT, EPI_BIAS_DROP_RES, bout, x2,
               drop(0))
    y1, xhat1, iv1 = _norm(lib, h1, s1, b1, save)
    del h1
    fd = _gemm(lib, y1, w1, M, ff, d, NT, EPI_BIAS_RELU_DROP, bf1, None,
               drop(1))
    h2 = _gemm(lib, fd, w2, M, d, ff, NT, EPI_BIAS_DROP_RES, bf2, y1, drop(2))
    y, xhat2, iv2 = _norm(lib, h2, s2, b2, save)
    saved = ((qkv, ao, m, l, xhat1, iv1, y1, fd, xhat2, iv2) if save
             else None)
    return y.view(B, S, d), saved


def _backward(x, key_valid, params, nhead, block, rate, seed, gout, saved):
    """The backward chain: (dx, the twelve parameter gradients)."""
    (wqkv, bqkv, wout, bout, s1, b1, w1, bf1, w2, bf2, s2,
     b2) = params
    qkv, ao, m, l, xhat1, iv1, y1, fd, xhat2, iv2 = saved
    B, S, d = x.shape
    M, ff = B * S, w1.shape[0]
    lib = _load()
    drop = lambda k: _drop_args(rate, seed, k, nhead, S)
    g = gout.reshape(M, d)
    dh2, df2, ds2, db2, dbf2 = _norm_bwd(lib, g, xhat2, iv2, s2, drop(2))
    dw2 = _weight_grad(lib, df2, fd)
    dfpre = _gemm(lib, df2, w2, M, ff, d, NN, EPI_DRELU, None, fd, drop(1))
    del df2
    dw1 = _weight_grad(lib, dfpre, y1)
    dbf1 = _colsum(lib, dfpre)
    dy1 = _gemm(lib, dfpre, w1, M, d, ff, NN, EPI_RES, None, dh2)
    del dfpre, dh2
    dh1, da, ds1, db1, dbout = _norm_bwd(lib, dy1, xhat1, iv1, s1, drop(0))
    del dy1
    dwout = _weight_grad(lib, da, ao)
    dao = _gemm(lib, da, wout, M, d, d, NN)
    del da
    dqkv = dense_bwd_launch(qkv.view(B, S, 3 * d), key_valid, nhead,
                            dao.view(B, S, d), block, rate, seed,
                            (ao.view(B, S, d), m, l),
                            stride=nhead + STREAMS).view(M, 3 * d)
    dwqkv = _weight_grad(lib, dqkv, x.reshape(M, d))
    dbqkv = _colsum(lib, dqkv)
    dx = _gemm(lib, dqkv, wqkv, M, d, 3 * d, NN, EPI_RES, None, dh1)
    return (dx.view(B, S, d), dwqkv, dbqkv, dwout, dbout, ds1, db1, dw1, dbf1,
            dw2, dbf2, ds2, db2)


class _TransformerLayer(torch.autograd.Function):
    """K10 on CUDA tensors with K10's backward chain as its gradient."""

    @staticmethod
    def forward(ctx, x, key_valid, nhead, block, rate, seed, *params):
        y, saved = _forward(x, key_valid, params, nhead, block, rate, seed,
                            save=True)
        transformer_layer.launches += 1
        ctx.save_for_backward(x, key_valid, *params, *saved)
        ctx.args = (nhead, block, rate, seed)
        return y

    @staticmethod
    def backward(ctx, gout):
        x, key_valid, *rest = ctx.saved_tensors
        params, saved = rest[:len(PARAM_NAMES)], rest[len(PARAM_NAMES):]
        nhead, block, rate, seed = ctx.args
        grads = transformer_layer_bwd(x, key_valid, params, nhead, block,
                                      gout.contiguous(), rate, seed, saved)
        return (grads[0], None, None, None, None, None, *grads[1:])


def transformer_layer(x: torch.Tensor, key_valid: torch.Tensor, params,
                      nhead: int, block: int, rate: float = 0.0,
                      seed: int = 0) -> torch.Tensor:
    """K10 forward: the layer of ``params`` (``PARAM_NAMES``) over packed
    rows x ``[B, S, d]`` with graphs of ``block`` tokens, dropout ``rate``
    (0 = none) drawn from ``seed``. CPU tensors take
    ``transformer_layer_plain``; CUDA tensors launch the kernel chain or
    raise, and where a gradient is wanted the result carries K10's backward
    chain (``transformer_layer_bwd``)."""
    if x.device.type == "cpu":
        return transformer_layer_plain(x, key_valid, params, nhead, block,
                                       rate, seed)
    if x.device.type != "cuda":
        raise ValueError(f"transformer_layer: unsupported device {x.device}")
    _check(x, key_valid, params, nhead, block, rate)
    if torch.is_grad_enabled() and (x.requires_grad
                                    or any(p.requires_grad for p in params)):
        return _TransformerLayer.apply(x, key_valid, nhead, block, rate, seed,
                                       *params)
    y, _ = _forward(x, key_valid, params, nhead, block, rate, seed,
                    save=False)
    transformer_layer.launches += 1
    return y


transformer_layer.launches = 0


def transformer_layer_bwd(x: torch.Tensor, key_valid: torch.Tensor, params,
                          nhead: int, block: int, gout: torch.Tensor,
                          rate: float = 0.0, seed: int = 0, saved=None):
    """K10 backward: (dx, the twelve parameter gradients) for the cotangent
    ``gout`` [B, S, d] of ``transformer_layer(x, key_valid, params, nhead,
    block, rate, seed)``, the dropout masks drawn again from ``seed``.
    ``saved`` is what the forward chain kept (``transformer_layer_saved``).
    CPU tensors take ``transformer_layer_bwd_plain`` (no ``saved``); CUDA
    tensors launch the backward chain or raise."""
    if x.device.type == "cpu":
        return transformer_layer_bwd_plain(x, key_valid, params, nhead, block,
                                           gout, rate, seed)
    if x.device.type != "cuda":
        raise ValueError(f"transformer_layer_bwd: unsupported device "
                         f"{x.device}")
    _check(x, key_valid, params, nhead, block, rate, gout)
    if saved is None:
        raise ValueError("transformer_layer_bwd: needs what the forward "
                         "kept (transformer_layer_saved)")
    grads = _backward(x, key_valid, params, nhead, block, rate, seed, gout,
                      saved)
    transformer_layer_bwd.launches += 1
    return grads


transformer_layer_bwd.launches = 0


def transformer_layer_saved(x, key_valid, params, nhead, block, rate=0.0,
                            seed=0):
    """K10's forward chain on CUDA tensors, uncounted: (y, what its backward
    reads), for holding ``transformer_layer_bwd`` alone against its plain
    version."""
    _check(x, key_valid, params, nhead, block, rate)
    return _forward(x, key_valid, params, nhead, block, rate, seed, save=True)


def _load():
    lib = _build.load("transformer_layer")
    if lib.layer_gemm.argtypes is None:
        p, i, drop = ctypes.c_void_p, ctypes.c_int, [
            ctypes.c_int, ctypes.c_uint, ctypes.c_float, ctypes.c_int,
            ctypes.c_int, ctypes.c_int]
        lib.layer_gemm.argtypes = [p] * 3 + [i] * 6 + [p] * 2 + drop + [p]
        lib.layer_norm_fwd.argtypes = ([p] * 6 + [ctypes.c_long, i,
                                                  ctypes.c_float, p])
        lib.layer_norm_bwd.argtypes = ([p] * 8 + [ctypes.c_long] + [i] * 3
                                       + drop + [p])
        lib.layer_colsum.argtypes = [p] * 3 + [ctypes.c_long] + [i] * 3 + [p]
        lib.layer_sum.argtypes = [p, p, i, ctypes.c_long, p]
        for fn in (lib.layer_gemm, lib.layer_norm_fwd, lib.layer_norm_bwd,
                   lib.layer_colsum, lib.layer_sum):
            fn.restype = ctypes.c_int
    return lib
