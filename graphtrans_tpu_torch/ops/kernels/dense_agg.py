"""K6: the strided-layout message-passing sum with precomputed edge
embeddings, and its backward.

Computes, per graph g of the strided layout,

    out[g,s,c] = sum_{e: mask[g,e], dst[g,e]=s}
                 w[g,e] * relu(x[g,src[g,e],c] + emb[g,e,c])

with ``relu`` (GCN/GIN's ``relu_add``; off: ``add``) and the edge weight
``w`` optional. x ``[G, Sm, d]`` and emb ``[G, Em, d]`` float32, src/dst
``[G, Em]`` int32 graph-local, mask ``[G, Em]`` bool. The backward returns
dx ``[G, Sm, d]``, demb ``[G, Em, d]`` (zero on masked slots) and dw
``[G, Em]`` (``sum_c gout[dst]*relu(pre)``), recomputing the relu mask
from x and emb; torch's relu gradient is 0 at a tie, as ``jnp.where(pre >
0, ...)`` of the JAX kernel.

Replaces ``graphtrans_tpu/ops/pallas/dense_agg.py:fused_dense_agg``: the
forward (``_fwd_kernel``) and the custom-VJP backward (``_bwd_kernel``).
The TPU kernels build one-hot matrices of src and dst so the gather and
the scatter run on the MXU, over tiles of 16 graphs (callers pad G to a
multiple of 16); both exist for the TPU only. Here any G and any d run.

What bounds it on the H100: memory. The forward must read x and the emb
rows of valid edges and write out: at 4096 NCI1-like graphs (stride 48,
160 edge slots of which 68 valid on average, d=128) about 0.35 GB against
a few flops per valid edge and channel; the backward reads x, gout and the
valid emb rows and writes dx and demb (in full), about 0.79 GB. Design
(``csrc/dense_agg.cu`` over ``csrc/strided_agg.cuh``, the walk it shares
with K1), K1's layout without the table lookup: a block owns
a 128-channel slice of one graph; the graph's x slice (and in the backward
gout's) and an accumulator sit in shared memory, the edge lists are staged
once, and each thread owns one channel and walks the edges in order, the
embedding loads of 8 edges issued before their adds. No two threads write
one cell, so there are no atomics and every sum has a fixed order. dw, a
sum over channels, is reduced across the block's warps per edge and summed
over the channel slices in order.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import _build

_CT = 128  # channels per block (csrc/dense_agg.cu)
_SMEM_MAX = 232448  # bytes of shared memory a block can use on Hopper


def dense_agg_plain(x, src, dst, emask, emb, w=None,
                    relu: bool = True) -> torch.Tensor:
    """Plain PyTorch version of K6: same arguments, same result; autograd
    differentiates it. gather -> (+emb, relu, *w) -> mask -> scatter-add."""
    G, Sm, d = x.shape
    Em = src.shape[1]
    m = torch.gather(x, 1, src.long()[..., None].expand(G, Em, d)) + emb
    if relu:
        m = torch.relu(m)
    if w is not None:
        m = m * w[..., None]
    m = m.masked_fill(~emask[..., None], 0.0)
    return torch.zeros_like(x).scatter_add_(
        1, dst.long()[..., None].expand(G, Em, d), m)


def dense_agg_bwd_plain(x, src, dst, emask, emb, w, gout, relu: bool = True):
    """Plain version of K6's backward: autograd through ``dense_agg_plain``.
    Returns (dx, demb, dw or None), as ``dense_agg_bwd``."""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_() if t is not None else None
                  for t in (x, emb, w)]
        out = dense_agg_plain(leaves[0], src, dst, emask, leaves[1],
                              leaves[2], relu)
        want = [t for t in leaves if t is not None]
        got = iter(torch.autograd.grad(out, want, gout))
    return tuple(next(got) if t is not None else None for t in leaves)


def _check(x, src, dst, emask, emb, w, gout=None):
    G, Sm, d = x.shape
    Em = src.shape[1]
    want = [(x, torch.float32, (G, Sm, d)), (src, torch.int32, (G, Em)),
            (dst, torch.int32, (G, Em)), (emask, torch.bool, (G, Em)),
            (emb, torch.float32, (G, Em, d))]
    if w is not None:
        want.append((w, torch.float32, (G, Em)))
    if gout is not None:
        want.append((gout, torch.float32, (G, Sm, d)))
    for t, dtype, shape in want:
        if t.device != x.device:
            raise ValueError(f"dense_agg: tensors on {t.device} and "
                             f"{x.device}")
        if t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(f"dense_agg: expected {dtype} {shape}, got "
                             f"{t.dtype} {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError("dense_agg: inputs must be contiguous")
    lib = _load()
    smem = lib.dense_agg_smem(Sm, Em, int(gout is not None))
    if smem > _SMEM_MAX:
        raise ValueError(f"dense_agg: stride {Sm} and {Em} edge slots need "
                         f"{smem} bytes of shared memory (max {_SMEM_MAX})")
    return lib


def _ptr(t: Optional[torch.Tensor]):
    return ctypes.c_void_p(t.data_ptr() if t is not None else 0)


def _stream(t: torch.Tensor):
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def _launch_fwd(x, src, dst, emask, emb, w, relu: bool):
    lib = _check(x, src, dst, emask, emb, w)
    G, Sm, d = x.shape
    out = torch.empty_like(x)
    if out.numel() == 0:
        return out
    err = lib.dense_agg_fwd(
        _ptr(x), _ptr(src), _ptr(dst), _ptr(emask), _ptr(emb), _ptr(w),
        _ptr(out), G, Sm, src.shape[1], d, int(relu), _stream(x))
    _build.check(lib, err, "dense_agg_fwd")
    dense_agg.launches += 1
    return out


class _DenseAgg(torch.autograd.Function):
    """K6 on CUDA tensors with K6's backward kernel as its gradient."""

    @staticmethod
    def forward(ctx, x, src, dst, emask, emb, w, relu):
        ctx.save_for_backward(x, src, dst, emask, emb, w)
        ctx.relu = relu
        return _launch_fwd(x, src, dst, emask, emb, w, relu)

    @staticmethod
    def backward(ctx, gout):
        x, src, dst, emask, emb, w = ctx.saved_tensors
        dx, demb, dw = dense_agg_bwd(x, src, dst, emask, emb, w,
                                     gout.contiguous(), ctx.relu)
        return dx, None, None, None, demb, dw, None


def dense_agg(x: torch.Tensor, src: torch.Tensor, dst: torch.Tensor,
              emask: torch.Tensor, emb: torch.Tensor,
              w: Optional[torch.Tensor] = None,
              relu: bool = True) -> torch.Tensor:
    """K6 forward. CPU tensors take ``dense_agg_plain``; CUDA tensors
    launch the kernel or raise, and where a gradient is wanted the result
    carries K6's backward kernel (``dense_agg_bwd``). Every valid edge slot
    must hold src/dst in ``[0, Sm)``; masked slots are never read."""
    if x.device.type == "cpu":
        return dense_agg_plain(x, src, dst, emask, emb, w, relu)
    if x.device.type != "cuda":
        raise ValueError(f"dense_agg: unsupported device {x.device}")
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (x, emb, w)):
        return _DenseAgg.apply(x, src, dst, emask, emb, w, relu)
    return _launch_fwd(x, src, dst, emask, emb, w, relu)


dense_agg.launches = 0


def dense_agg_bwd(x, src, dst, emask, emb, w, gout, relu: bool = True):
    """K6 backward on CUDA tensors: (dx [G,Sm,d], demb [G,Em,d], dw [G,Em]
    or None) for the cotangent ``gout`` of ``dense_agg``. CPU tensors take
    ``dense_agg_bwd_plain``."""
    if x.device.type == "cpu":
        return dense_agg_bwd_plain(x, src, dst, emask, emb, w, gout, relu)
    if x.device.type != "cuda":
        raise ValueError(f"dense_agg_bwd: unsupported device {x.device}")
    lib = _check(x, src, dst, emask, emb, w, gout)
    G, Sm, d = x.shape
    Em = src.shape[1]
    dx, demb = torch.empty_like(x), torch.empty_like(emb)
    dw = torch.empty_like(w) if w is not None else None
    if G == 0 or d == 0 or Sm == 0 or Em == 0:
        for t in (dx, demb, dw):
            if t is not None:
                t.zero_()
        return dx, demb, dw
    slices = -(-d // _CT)
    dw_part = (None if w is None else dw if slices == 1
               else torch.empty(slices, G, Em, dtype=torch.float32,
                                device=x.device))
    err = lib.dense_agg_bwd(
        _ptr(x), _ptr(src), _ptr(dst), _ptr(emask), _ptr(emb), _ptr(w),
        _ptr(gout), _ptr(dx), _ptr(demb), _ptr(dw), _ptr(dw_part), G, Sm, Em,
        d, int(relu), _stream(x))
    _build.check(lib, err, "dense_agg_bwd")
    dense_agg_bwd.launches += 1
    return dx, demb, dw


dense_agg_bwd.launches = 0


def _load():
    lib = _build.load("dense_agg")
    if lib.dense_agg_fwd.argtypes is None:
        lib.dense_agg_smem.argtypes = [ctypes.c_int] * 3
        lib.dense_agg_smem.restype = ctypes.c_long
        lib.dense_agg_fwd.argtypes = ([ctypes.c_void_p] * 7
                                      + [ctypes.c_int] * 5 + [ctypes.c_void_p])
        lib.dense_agg_fwd.restype = ctypes.c_int
        lib.dense_agg_bwd.argtypes = ([ctypes.c_void_p] * 11
                                      + [ctypes.c_int] * 5 + [ctypes.c_void_p])
        lib.dense_agg_bwd.restype = ctypes.c_int
    return lib
