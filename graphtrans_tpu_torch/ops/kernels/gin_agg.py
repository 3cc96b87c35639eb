"""K1: GIN aggregation with the bond-embedding lookup inside the kernel.

Computes, per graph g of the strided layout,

    out[g,s,c] = scale*x[g,s,c] + sum_{e: mask[g,e], dst[g,e]=s}
                 w[g,e] * relu(x[g,src[g,e],c] + sum_f T[attr[g,f,e], c])

with the optional ``w`` and optional ``scale`` prologue ((1+eps)*x of GIN).
``attr`` arrives clipped per feature with the table offsets folded in, so it
indexes the concatenated bond table ``T [V, d]`` directly.

Replaces ``graphtrans_tpu/ops/pallas/gin_agg.py:fused_gin_agg`` (forward,
``_fwd_kernel``). The TPU kernel builds one-hot and multi-hot matrices so the
gather, lookup and scatter run on the MXU, and packs graphs block-diagonally
to fill its 128-wide contraction; both exist for the TPU only.

What bounds it on the H100: memory. A launch must read x and write out
(2*G*Sm*d*4 bytes, ~315 MB for 4097 graphs of stride 32 at d=300) and does
about (F+3)*d flops per valid edge, a few flops per byte against the card's
~20 f32 flops per byte of bandwidth. Design (``csrc/gin_agg.cu``): one block
per (graph, 128-channel slice); the graph's x slice, an accumulator of the
same size and the 13-row bond table sit in shared memory, the edge lists are
staged once, and each thread owns one channel and walks the edges in order.
No two threads write one cell, so there are no atomics and the sum order is
fixed; every byte of x and out crosses device memory once.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import _build

_CT = 128  # channels per block (csrc/gin_agg.cu)
_SMEM_MAX = 232448  # bytes of shared memory a block can use on Hopper


def gin_agg_plain(x, src, dst, emask, attr, tbl, w=None, scale=None):
    """Plain PyTorch version of K1: same arguments, same result. x
    [G,Sm,d] f32; src/dst/emask [G,Em]; attr [G,F,Em] int; tbl [V,d];
    w [G,Em] or None; scale a 1-element tensor or None."""
    G, Sm, d = x.shape
    Em = src.shape[1]
    attr = attr.long()
    emb = tbl[attr[:, 0]]
    for f in range(1, attr.shape[1]):
        emb = emb + tbl[attr[:, f]]                          # [G, Em, d]
    xs = torch.gather(x, 1, src.long()[..., None].expand(G, Em, d))
    m = torch.relu(xs + emb)
    if w is not None:
        m = m * w[..., None]
    m = m.masked_fill(~emask[..., None], 0.0)
    out = torch.zeros_like(x).scatter_add_(
        1, dst.long()[..., None].expand(G, Em, d), m)
    if scale is not None:
        out = out + scale.reshape(()) * x
    return out


def _check(x, src, dst, emask, attr, tbl, w, scale):
    G, Sm, d = x.shape
    Em = src.shape[1]
    F = attr.shape[1]
    want = [(x, torch.float32, (G, Sm, d)), (src, torch.int32, (G, Em)),
            (dst, torch.int32, (G, Em)), (emask, torch.bool, (G, Em)),
            (attr, torch.int32, (G, F, Em)),
            (tbl, torch.float32, (tbl.shape[0], d))]
    if w is not None:
        want.append((w, torch.float32, (G, Em)))
    if scale is not None:
        want.append((scale, torch.float32, (1,)))
    for t, dtype, shape in want:
        if t.device != x.device:
            raise ValueError(f"gin_agg: tensors on {t.device} and {x.device}")
        if t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(f"gin_agg: expected {dtype} {shape}, got "
                             f"{t.dtype} {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError("gin_agg: inputs must be contiguous")
    smem = (2 * Sm + tbl.shape[0]) * _CT * 4 + Em * (3 + F) * 4
    if smem > _SMEM_MAX:
        raise ValueError(f"gin_agg: stride {Sm} and {Em} edge slots need "
                         f"{smem} bytes of shared memory (max {_SMEM_MAX})")


def _ptr(t: Optional[torch.Tensor]):
    return ctypes.c_void_p(t.data_ptr() if t is not None else 0)


def gin_agg(x: torch.Tensor, src: torch.Tensor, dst: torch.Tensor,
            emask: torch.Tensor, attr: torch.Tensor, tbl: torch.Tensor,
            w: Optional[torch.Tensor] = None,
            scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K1 forward. CPU tensors take ``gin_agg_plain``; CUDA tensors launch
    the kernel or raise. Every edge slot, masked or not, must hold src/dst
    in ``[0, Sm)`` and attr in ``[0, V)``: ``collate`` pads masked slots
    with 0 and ``dense_mp.bond_table_index`` clips attr."""
    if x.device.type == "cpu":
        return gin_agg_plain(x, src, dst, emask, attr, tbl, w, scale)
    if x.device.type != "cuda":
        raise ValueError(f"gin_agg: unsupported device {x.device}")
    _check(x, src, dst, emask, attr, tbl, w, scale)
    G, Sm, d = x.shape
    out = torch.empty_like(x)
    if out.numel() == 0:
        return out
    lib = _load()
    err = lib.gin_agg_fwd(
        _ptr(x), _ptr(src), _ptr(dst), _ptr(emask), _ptr(attr), _ptr(tbl),
        _ptr(w), _ptr(scale), _ptr(out), G, Sm, src.shape[1], attr.shape[1],
        tbl.shape[0], d,
        ctypes.c_void_p(torch.cuda.current_stream(x.device).cuda_stream))
    _build.check(lib, err, "gin_agg_fwd")
    gin_agg.launches += 1
    return out


gin_agg.launches = 0


def _load():
    lib = _build.load("gin_agg")
    if lib.gin_agg_fwd.argtypes is None:
        lib.gin_agg_fwd.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 6
                                    + [ctypes.c_void_p])
        lib.gin_agg_fwd.restype = ctypes.c_int
    return lib
