"""K1: GIN aggregation with the bond-embedding lookup inside the kernel.

Computes, per graph g of the strided layout,

    out[g,s,c] = scale*x[g,s,c] + sum_{e: mask[g,e], dst[g,e]=s}
                 w[g,e] * relu(x[g,src[g,e],c] + sum_f T[attr[g,f,e], c])

with the optional ``w`` and optional ``scale`` prologue ((1+eps)*x of GIN).
``attr`` arrives clipped per feature with the table offsets folded in, so it
indexes the concatenated bond table ``T [V, d]`` directly.

Replaces ``graphtrans_tpu/ops/pallas/gin_agg.py:fused_gin_agg``: the
forward (``_fwd_kernel``) and the backward (``_bwd_kernel``), which returns
dx (with ``scale*gout``), dT summed over all graphs, dw and dscale. The TPU
kernels build one-hot and multi-hot matrices so the gather, lookup and
scatter run on the MXU, pack graphs block-diagonally to fill its 128-wide
contraction, and carry dT across the sequential grid in a revisited VMEM
block; all three exist for the TPU only.

What bounds it on the H100: memory. The forward must read x and write out
(2*G*Sm*d*4 bytes, ~315 MB for 4097 graphs of stride 32 at d=300), the
backward read x and gout and write dx (~472 MB), each doing a few flops per
valid edge and channel, against the card's ~20 f32 flops per byte of
bandwidth. Forward (``csrc/gin_agg.cu``): a block owns a 128-channel slice
of one graph; the graph's x slice, an accumulator and the 13-row bond
table sit in shared memory, the edge lists are staged once, and each
thread owns one channel and walks the edges in order. No two threads write
one cell, so there are no atomics and every sum has a fixed order.

Backward: the grid is sized to the card (``bwd_geometry``): at the
throughput batch a block covers all of d for a chunk of graphs, a few
hundred blocks, one wave; at a small batch the channels are split into
slices so that every SM gets a block. A thread owns ``vec`` neighbouring
channels (16-byte copies and loads where d % 4 == 0, so d=300 leaves 21
of 96 lanes idle, not a third of each 128-channel slice). A graph's gout
rows land by ``cp.async``, and its x with them where a block walks one
graph; where it walks a chunk, x streams through a ring of a few rows
ahead of the walk, so three blocks share an SM at the bench batch (x
staged whole, or a second buffer, would leave fewer, and the other
blocks' walks are what hides a block's loads); its valid edges are
sorted by source row in shared memory, once for all channels, so each
row's dx is summed in registers in the forward's scatter order and
written once. dT and dscale accumulate in
the block across its chunk and leave as per-block partials; one more
kernel adds them in a fixed order across the card (dT 32 columns a block,
each column's rows split over 8 threads). dw, a sum over channels, is
reduced across a block's warps per edge.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass
from typing import Optional

import torch

from . import _build

_CT = 128  # channels a forward block (csrc/gin_agg.cu)
_SMEM_MAX = 232448  # bytes of shared memory a block can use on Hopper
SM_SHARED = 228 * 1024  # shared memory of an SM; a block reserves 1 KB more
SMS = 132  # SMs of the H100 SXM, where the card cannot be asked
BWD_MAX_THREADS = 256  # threads a backward block (csrc/gin_agg.cu)
BWD_MAX_F = 4  # table rows an edge sums in the backward
MIN_SLICE_LANES = 8  # lanes a channel slice keeps when the grid is split


def gin_agg_plain(x, src, dst, emask, attr, tbl, w=None, scale=None):
    """Plain PyTorch version of K1: same arguments, same result; autograd
    differentiates it. x [G,Sm,d] f32; src/dst/emask [G,Em]; attr [G,F,Em]
    int; tbl [V,d]; w [G,Em] or None; scale a 1-element tensor or None."""
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


def gin_agg_bwd_plain(x, src, dst, emask, attr, tbl, w, scale, gout):
    """Plain version of K1's backward: autograd through ``gin_agg_plain``.
    Returns (dx, dT, dw or None, dscale or None), as ``gin_agg_bwd``."""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_() if t is not None else None
                  for t in (x, tbl, w, scale)]
        out = gin_agg_plain(leaves[0], src, dst, emask, attr, leaves[1],
                            leaves[2], leaves[3])
        want = [t for t in leaves if t is not None]
        got = iter(torch.autograd.grad(out, want, gout))
    return tuple(next(got) if t is not None else None for t in leaves)


def _check(x, src, dst, emask, attr, tbl, w, scale, gout=None):
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
    if gout is not None:
        want.append((gout, torch.float32, (G, Sm, d)))
    for t, dtype, shape in want:
        if t.device != x.device:
            raise ValueError(f"gin_agg: tensors on {t.device} and {x.device}")
        if t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(f"gin_agg: expected {dtype} {shape}, got "
                             f"{t.dtype} {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError("gin_agg: inputs must be contiguous")
    V = tbl.shape[0]
    smem = (2 * Sm + V) * _CT * 4 + Em * (3 + F) * 4
    if smem > _SMEM_MAX:
        raise ValueError(f"gin_agg: stride {Sm} and {Em} edge slots need "
                         f"{smem} bytes of shared memory (max {_SMEM_MAX})")


XRING = 8  # rows of x in flight in a backward block's ring (csrc/gin_agg.cu)


def bwd_smem(Sm: int, Em: int, F: int, V: int, channels: int, threads: int,
             has_w: bool, xrows: int) -> int:
    """Shared bytes of a K1-bwd block (``csrc/gin_agg.cu:bwd_smem``): the
    sorted edge records, one graph's gout slice, ``xrows`` rows of x (the
    slice, or a ring of XRING), the bond table's gradient, the staged edge
    lists, with ``w`` the weights and per-warp dw sums, and 32 floats of
    scratch."""
    words = 8 * Em + (Sm + xrows + V) * channels + Em * (F + 4) + 32
    if has_w:
        words += Em * (1 + threads // 32)
    return 4 * words


@dataclass(frozen=True)
class BwdGeometry:
    """One launch of K1-bwd's main kernel: ``vec`` neighbouring channels a
    thread, ``gpb`` graphs a block (``chunks`` blocks along the graphs),
    ``slices`` channel slices of ``channels`` each (``grid`` = (chunks,
    slices)), ``threads`` a block, its dynamic shared bytes and the rows of
    x it holds (``xrows``: the whole slice, or a ring of XRING). ``args``
    are the ints the C entry checks and launches."""
    vec: int
    gpb: int
    chunks: int
    slices: int
    channels: int
    threads: int
    smem: int
    xrows: int

    @property
    def grid(self) -> tuple:
        return (self.chunks, self.slices)

    def args(self) -> tuple:
        return (self.vec, self.gpb, self.slices, self.channels, self.threads,
                self.smem, self.xrows)


def _round(n: int, k: int) -> int:
    return -(-n // k) * k


@functools.lru_cache(maxsize=None)
def bwd_geometry(G: int, Sm: int, Em: int, F: int, V: int, d: int,
                 has_w: bool, sms: int = SMS, align: int = 4) -> BwdGeometry:
    """K1-bwd's launch for G graphs of stride Sm with Em edge slots and F
    table rows an edge, at width d, on a card of ``sms`` SMs; ``align`` is
    the widest vector (in floats) that the tensors' addresses allow.

    A thread takes ``vec`` channels: 4 where d and the addresses allow,
    else 1. The channels split into slices only where the graphs
    alone would leave SMs without a block (a slice keeps at least
    MIN_SLICE_LANES lanes: at d 40 one slice of 10 lanes), or where one
    block's shared memory could not hold a graph; a slice is a whole
    number of warps, its last warp maybe part idle. Where a block of each
    graph (and slice) fits the card at once, a block walks one graph and
    holds its x whole; else x streams through a ring of XRING rows, and the
    graphs a block are chosen so that as many blocks as the shared memory
    lets an SM hold take every graph in one wave."""
    if not 1 <= F <= BWD_MAX_F:
        raise ValueError(f"gin_agg_bwd: {F} table rows an edge (1 to "
                         f"{BWD_MAX_F})")
    vec = 4 if d % 4 == 0 and align % 4 == 0 else 1
    lanes = -(-d // vec)
    per = -(-lanes // max(1, min(-(-sms // G), lanes // MIN_SLICE_LANES)))
    ring = min(XRING, Sm)
    while True:   # lanes a slice
        slices = -(-lanes // per)
        threads = _round(per, 32)
        smem = bwd_smem(Sm, Em, F, V, per * vec, threads, has_w, ring)
        if threads <= BWD_MAX_THREADS and smem <= _SMEM_MAX:
            break
        if per == 1:
            raise ValueError(f"gin_agg_bwd: stride {Sm} and {Em} edge slots "
                             f"need more than {_SMEM_MAX} bytes of shared "
                             f"memory")
        per = min(per - 1, -(-lanes // (slices + 1)))
    whole = bwd_smem(Sm, Em, F, V, per * vec, threads, has_w, Sm)
    xrows = ring
    if whole <= _SMEM_MAX and G * slices <= sms * (SM_SHARED // (whole + 1024)):
        smem, xrows = whole, Sm
    chunks = max(1, min(G, sms * (SM_SHARED // (smem + 1024)) // slices))
    gpb = -(-G // chunks)
    return BwdGeometry(vec, gpb, -(-G // gpb), slices, per * vec, threads,
                       smem, xrows)


def _align(*tensors) -> int:
    """4 where every address is 16-byte aligned, else 1 (floats)."""
    return 4 if all(t.data_ptr() % 16 == 0 for t in tensors) else 1


def _sms(device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _ptr(t: Optional[torch.Tensor]):
    return ctypes.c_void_p(t.data_ptr() if t is not None else 0)


def _stream(t: torch.Tensor):
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def _launch_fwd(x, src, dst, emask, attr, tbl, w, scale):
    G, Sm, d = x.shape
    out = torch.empty_like(x)
    if out.numel() == 0:
        return out
    lib = _load()
    err = lib.gin_agg_fwd(
        _ptr(x), _ptr(src), _ptr(dst), _ptr(emask), _ptr(attr), _ptr(tbl),
        _ptr(w), _ptr(scale), _ptr(out), G, Sm, src.shape[1], attr.shape[1],
        tbl.shape[0], d, _stream(x))
    _build.check(lib, err, "gin_agg_fwd")
    gin_agg.launches += 1
    return out


class _GinAgg(torch.autograd.Function):
    """K1 on CUDA tensors with K1's backward kernel as its gradient."""

    @staticmethod
    def forward(ctx, x, src, dst, emask, attr, tbl, w, scale):
        ctx.save_for_backward(x, src, dst, emask, attr, tbl, w, scale)
        return _launch_fwd(x, src, dst, emask, attr, tbl, w, scale)

    @staticmethod
    def backward(ctx, gout):
        x, src, dst, emask, attr, tbl, w, scale = ctx.saved_tensors
        dx, dtbl, dw, dscale = gin_agg_bwd(x, src, dst, emask, attr, tbl, w,
                                           scale, gout.contiguous())
        return dx, None, None, None, None, dtbl, dw, dscale


def gin_agg(x: torch.Tensor, src: torch.Tensor, dst: torch.Tensor,
            emask: torch.Tensor, attr: torch.Tensor, tbl: torch.Tensor,
            w: Optional[torch.Tensor] = None,
            scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K1 forward. CPU tensors take ``gin_agg_plain``; CUDA tensors launch
    the kernel or raise, and where a gradient is wanted the result carries
    K1's backward kernel (``gin_agg_bwd``). Every edge slot, masked or not,
    must hold src/dst in ``[0, Sm)`` and attr in ``[0, V)``: ``collate``
    pads masked slots with 0 and ``dense_mp.bond_table_index`` clips attr."""
    if x.device.type == "cpu":
        return gin_agg_plain(x, src, dst, emask, attr, tbl, w, scale)
    if x.device.type != "cuda":
        raise ValueError(f"gin_agg: unsupported device {x.device}")
    _check(x, src, dst, emask, attr, tbl, w, scale)
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (x, tbl, w, scale)):
        return _GinAgg.apply(x, src, dst, emask, attr, tbl, w, scale)
    return _launch_fwd(x, src, dst, emask, attr, tbl, w, scale)


gin_agg.launches = 0


def gin_agg_bwd(x, src, dst, emask, attr, tbl, w, scale, gout):
    """K1 backward on CUDA tensors: (dx [G,Sm,d], dT [V,d], dw [G,Em] or
    None, dscale [1] or None) for the cotangent ``gout`` of ``gin_agg``.
    CPU tensors take ``gin_agg_bwd_plain``."""
    if x.device.type == "cpu":
        return gin_agg_bwd_plain(x, src, dst, emask, attr, tbl, w, scale,
                                 gout)
    if x.device.type != "cuda":
        raise ValueError(f"gin_agg_bwd: unsupported device {x.device}")
    _check(x, src, dst, emask, attr, tbl, w, scale, gout)
    G, Sm, d = x.shape
    V, Em, F = tbl.shape[0], src.shape[1], attr.shape[1]
    new = lambda *shape: torch.empty(shape, dtype=torch.float32,
                                     device=x.device)
    dx, dtbl = new(G, Sm, d), new(V, d)
    dw = new(G, Em) if w is not None else None
    dscale = new(1) if scale is not None else None
    if G == 0 or d == 0:
        dtbl.zero_()
        if dscale is not None:
            dscale.zero_()
        return dx, dtbl, dw, dscale
    geo = bwd_geometry(G, Sm, Em, F, V, d, w is not None, _sms(x.device),
                       _align(x, gout, tbl))
    dtbl_part = new(geo.chunks, V, d)
    dw_part = new(geo.slices, G, Em) if w is not None and geo.slices > 1 \
        else None
    dsc_part = new(geo.chunks * geo.slices) if scale is not None else None
    lib = _load()
    err = lib.gin_agg_bwd(
        _ptr(x), _ptr(src), _ptr(dst), _ptr(emask), _ptr(attr), _ptr(tbl),
        _ptr(w), _ptr(scale), _ptr(gout), _ptr(dx), _ptr(dtbl), _ptr(dw),
        _ptr(dscale), _ptr(dtbl_part), _ptr(dw_part), _ptr(dsc_part), G, Sm,
        Em, F, V, d, *geo.args(), _stream(x))
    _build.check(lib, err, "gin_agg_bwd")
    gin_agg_bwd.launches += 1
    return dx, dtbl, dw, dscale


gin_agg_bwd.launches = 0


def _load():
    lib = _build.load("gin_agg")
    if lib.gin_agg_fwd.argtypes is None:
        lib.gin_agg_fwd.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 6
                                    + [ctypes.c_void_p])
        lib.gin_agg_fwd.restype = ctypes.c_int
        lib.gin_agg_bwd.argtypes = ([ctypes.c_void_p] * 16
                                    + [ctypes.c_int] * 13 + [ctypes.c_void_p])
        lib.gin_agg_bwd.restype = ctypes.c_int
    return lib
