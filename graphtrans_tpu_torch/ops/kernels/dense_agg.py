"""K6: the strided-layout message-passing sum with precomputed edge
embeddings, and its backward.

Computes, per graph g of the strided layout,

    out[g,s,c] = sum_{e: mask[g,e], dst[g,e]=s}
                 w[g,e] * relu(x[g,src[g,e],c] + emb[g,e,c])

with ``relu`` (GCN/GIN's ``relu_add``; off: ``add``) and the edge weight
``w`` optional. x ``[G, Sm, d]`` float32, emb ``[G, Em, d]`` float32 or
None (all-zero embeddings, the function the JAX package computes with
its zeros: NCI1's ``ZeroEdgeEncoder``, so that no ``[G, Em, d]`` tensor
is made), src/dst ``[G, Em]`` int32 graph-local, mask ``[G, Em]`` bool.
The backward returns dx ``[G, Sm, d]``, demb ``[G, Em, d]`` (zero on
masked slots; None without emb) and dw ``[G, Em]`` (``sum_c
gout[dst]*relu(pre)``), recomputing the relu mask from x and emb; torch's
relu gradient is 0 at a tie, as ``jnp.where(pre > 0, ...)`` of the JAX
kernel.

Replaces ``graphtrans_tpu/ops/pallas/dense_agg.py:fused_dense_agg``: the
forward (``_fwd_kernel``) and the custom-VJP backward (``_bwd_kernel``).
The TPU kernels build one-hot matrices of src and dst so the gather and
the scatter run on the MXU, over tiles of 16 graphs (callers pad G to a
multiple of 16); both exist for the TPU only. Here any G and any d run.

What bounds it on the H100: memory. The forward must read x and the emb
rows of valid edges and write out: at 4096 NCI1-like graphs (stride 48,
160 edge slots of which 68 valid on average, d=128) about 0.35 GB with
emb, 0.21 GB without it, against a few flops per valid edge and channel.
The backward reads x, gout and the valid emb rows and writes dx, about
0.45 GB; demb (written in full) and dw add 0.34 GB where autograd asks for
them, which NCI1 never does (its edge embeddings are zero, its weight the
structural GCN norm).

Both directions (``csrc/dense_agg.cu``): a warp a graph and channel slice
(``fwd_geometry``, ``bwd_geometry``), so a few thousand graphs fill the
card in one wave. The warp sorts its graph's valid slots in shared memory,
once for all of its channels (by (dst, slot) forward, by (src, slot)
backward), then walks them as K7 walks its runs: the rows of several edges
in flight (16-byte loads where d % 4 == 0), each output row summed in
registers in slot order, each weight product rounded before its add, and
written once, zero for a row no valid edge reaches. No shared
accumulator, no atomics, no barrier.

Forward: it loads the x[src] and emb rows of each edge, or x[src] alone in
its emb-less instance; launches count by instance in
``dense_agg.instances``. Where the graphs alone would leave the card's
warps idle (fewer than ``FWD_SPLIT_PER_SM`` graphs an SM; NCI1's batch of
128), the channels are cut into slices of 32, a float a lane, and a warp
keeps 16 edges' rows in flight.

Backward: the gout[dst], emb and x[src] rows in flight. ``dense_agg_bwd``
computes only what it is asked for: the dx-only instance writes neither
demb nor dw; the full one writes demb (0 on masked slots) and reduces dw,
a sum over channels, over the warp's lanes per edge (per channel slice,
the slices summed in order). Launches count by instance in
``dense_agg_bwd.instances``.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass
from typing import Optional

import torch

from . import _build
from .gin_agg import SMS, _sms
from .spmm import bwd_launch

_SMEM_MAX = 232448  # bytes of shared memory a block can use on Hopper
WARPS = 8  # warps a block at most (csrc/dense_agg.cu)
# The forward splits the channels into slices of 32 below this many graphs
# an SM: on the H100 the split took less device time at 129-528 graphs and
# more at 1056 and up (chip_smoke.py's phase 12a times both launches).
FWD_SPLIT_PER_SM = 6


def dense_agg_plain(x, src, dst, emask, emb=None, w=None,
                    relu: bool = True) -> torch.Tensor:
    """Plain PyTorch version of K6: same arguments, same result; autograd
    differentiates it. gather -> (+emb, relu, *w) -> mask -> scatter-add;
    emb None adds nothing."""
    G, Sm, d = x.shape
    Em = src.shape[1]
    m = torch.gather(x, 1, src.long()[..., None].expand(G, Em, d))
    if emb is not None:
        m = m + emb
    if relu:
        m = torch.relu(m)
    if w is not None:
        m = m * w[..., None]
    m = m.masked_fill(~emask[..., None], 0.0)
    return torch.zeros_like(x).scatter_add_(
        1, dst.long()[..., None].expand(G, Em, d), m)


def dense_agg_bwd_plain(x, src, dst, emask, emb, w, gout, relu: bool = True,
                        need_demb: bool = True, need_dw: bool = True):
    """Plain version of K6's backward: autograd through ``dense_agg_plain``.
    Returns (dx, demb or None, dw or None), as ``dense_agg_bwd``: demb
    where emb is given and ``need_demb``, dw where w is given and
    ``need_dw``."""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_() if t is not None and need
                  else t for t, need in ((x, True), (emb, need_demb),
                                         (w, need_dw))]
        out = dense_agg_plain(leaves[0], src, dst, emask, leaves[1],
                              leaves[2], relu)
        want = [t for t in leaves if t is not None and t.requires_grad]
        got = iter(torch.autograd.grad(out, want, gout))
    return tuple(next(got) if t is not None and t.requires_grad else None
                 for t in leaves)


@dataclass(frozen=True)
class Geometry:
    """One launch of K6 or K6-bwd: ``vec`` neighbouring channels a load,
    ``vpl`` loads a lane a row, ``slices`` channel slices of 32 * vec *
    vpl, ``warps`` graphs a block (a warp a graph; ceil(G / warps) blocks
    a slice) and the block's dynamic shared bytes. ``args`` are the ints
    the C entries check and launch."""
    vec: int
    vpl: int
    slices: int
    warps: int
    smem: int

    def args(self) -> tuple:
        return (self.vec, self.vpl, self.slices, self.warps, self.smem)


def warp_smem(Em: int, warps: int) -> int:
    """Shared bytes of a block of either direction
    (``csrc/dense_agg.cu:warp_smem``): per warp and edge slot a compacted
    key, a sorted key, the other endpoint and w."""
    return 16 * Em * warps


def _warps(G: int, Sm: int, Em: int, sms: int, what: str) -> int:
    """Graphs a block: up to WARPS, fewer where the graphs would leave SMs
    without a block (G 129: 129 blocks of one warp), and fewer where the
    shared memory would pass the limit."""
    if Sm > 32767 or Em > 65536:
        raise ValueError(f"{what}: stride {Sm} and {Em} edge slots do not "
                         f"fit a sort key (at most 32767 and 65536)")
    warps = max(1, min(WARPS, -(-G // sms)))
    while warps > 1 and warp_smem(Em, warps) > _SMEM_MAX:
        warps -= 1
    if warp_smem(Em, warps) > _SMEM_MAX:
        raise ValueError(f"{what}: {Em} edge slots need {warp_smem(Em, 1)} "
                         f"bytes of shared memory (max {_SMEM_MAX})")
    return warps


@functools.lru_cache(maxsize=None)
def fwd_geometry(G: int, Sm: int, Em: int, d: int, sms: int = SMS,
                 align: int = 4,
                 split_per_sm: int = FWD_SPLIT_PER_SM) -> Geometry:
    """K6's launch for G graphs of stride Sm with Em edge slots at width d
    on a card of ``sms`` SMs (``align``: the widest vector, in floats, the
    tensors' addresses allow). A warp takes one graph and slice, the slices
    by K7's vector rule (``bwd_launch``); below ``split_per_sm`` graphs an
    SM, slices of 32 channels, a float a lane (the kernel then keeps 16
    edges' rows in flight a warp)."""
    warps = _warps(G, Sm, Em, sms, "dense_agg")
    if G < split_per_sm * sms:
        vec, vpl, slices = 1, 1, -(-d // 32)
    else:
        vec, vpl, slices = bwd_launch(d, align)
    return Geometry(vec, vpl, slices, warps, warp_smem(Em, warps))


@functools.lru_cache(maxsize=None)
def bwd_geometry(G: int, Sm: int, Em: int, d: int, sms: int = SMS,
                 align: int = 4) -> Geometry:
    """K6-bwd's launch, the arguments as ``fwd_geometry``'s: slices by
    K7-bwd's vector rule (``bwd_launch``: one slice up to d 512), a warp a
    graph and slice."""
    warps = _warps(G, Sm, Em, sms, "dense_agg_bwd")
    return Geometry(*bwd_launch(d, align), warps, warp_smem(Em, warps))


def _check(x, src, dst, emask, emb, w, gout=None):
    G, Sm, d = x.shape
    Em = src.shape[1]
    want = [(x, torch.float32, (G, Sm, d)), (src, torch.int32, (G, Em)),
            (dst, torch.int32, (G, Em)), (emask, torch.bool, (G, Em))]
    if emb is not None:
        want.append((emb, torch.float32, (G, Em, d)))
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
    return _load()


def _ptr(t: Optional[torch.Tensor]):
    """A tensor's address for a ``c_void_p`` argument (None: NULL)."""
    return t.data_ptr() if t is not None else None


def _stream(t: torch.Tensor):
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def _launch_fwd(x, src, dst, emask, emb, w, relu: bool):
    lib = _check(x, src, dst, emask, emb, w)
    G, Sm, d = x.shape
    Em = src.shape[1]
    out = torch.empty_like(x)
    if out.numel() == 0:
        return out
    if Em == 0:
        return out.zero_()
    geo = fwd_geometry(G, Sm, Em, d, _sms(x.device),
                       _build.align(x, *([emb] if emb is not None else [])),
                       FWD_SPLIT_PER_SM)                    # out: new
    err = lib.dense_agg_fwd(
        _ptr(x), _ptr(src), _ptr(dst), _ptr(emask), _ptr(emb), _ptr(w),
        _ptr(out), G, Sm, Em, d, int(relu), *geo.args(), _stream(x))
    _build.check(lib, err, "dense_agg_fwd")
    dense_agg.launches += 1
    dense_agg.instances["emb" if emb is not None else "emb-less"] += 1
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
        dx, demb, dw = dense_agg_bwd(
            x, src, dst, emask, emb, w, gout.contiguous(), ctx.relu,
            need_demb=ctx.needs_input_grad[4],
            need_dw=ctx.needs_input_grad[5])
        return dx, None, None, None, demb, dw, None


def dense_agg(x: torch.Tensor, src: torch.Tensor, dst: torch.Tensor,
              emask: torch.Tensor, emb: Optional[torch.Tensor] = None,
              w: Optional[torch.Tensor] = None,
              relu: bool = True) -> torch.Tensor:
    """K6 forward. CPU tensors take ``dense_agg_plain``; CUDA tensors
    launch the kernel (its emb-less instance where emb is None) or raise,
    and where a gradient is wanted the result carries K6's backward kernel
    (``dense_agg_bwd``). Every valid edge slot must hold src/dst in ``[0,
    Sm)``; masked slots are never read."""
    if x.device.type == "cpu":
        return dense_agg_plain(x, src, dst, emask, emb, w, relu)
    if x.device.type != "cuda":
        raise ValueError(f"dense_agg: unsupported device {x.device}")
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (x, emb, w)):
        return _DenseAgg.apply(x, src, dst, emask, emb, w, relu)
    return _launch_fwd(x, src, dst, emask, emb, w, relu)


dense_agg.launches = 0
dense_agg.instances = {"emb": 0, "emb-less": 0}   # launches by instance


def dense_agg_bwd(x, src, dst, emask, emb, w, gout, relu: bool = True,
                  need_demb: bool = True, need_dw: bool = True):
    """K6 backward: (dx [G,Sm,d], demb [G,Em,d] or None, dw [G,Em] or
    None) for the cotangent ``gout`` of ``dense_agg``; demb where emb is
    given and ``need_demb``, dw where w is given and ``need_dw``
    (``_DenseAgg`` passes what autograd asks for). CPU tensors take
    ``dense_agg_bwd_plain``; CUDA tensors launch the kernel's instance
    (dx only, or with demb and dw) or raise."""
    need_demb = need_demb and emb is not None
    need_dw = need_dw and w is not None
    if x.device.type == "cpu":
        return dense_agg_bwd_plain(x, src, dst, emask, emb, w, gout, relu,
                                   need_demb, need_dw)
    if x.device.type != "cuda":
        raise ValueError(f"dense_agg_bwd: unsupported device {x.device}")
    lib = _check(x, src, dst, emask, emb, w, gout)
    G, Sm, d = x.shape
    Em = src.shape[1]
    dx = torch.empty_like(x)
    demb = torch.empty_like(emb) if need_demb else None
    dw = torch.empty_like(w) if need_dw else None
    if G == 0 or d == 0 or Sm == 0 or Em == 0:
        for t in (dx, demb, dw):
            if t is not None:
                t.zero_()
        return dx, demb, dw
    geo = bwd_geometry(G, Sm, Em, d, _sms(x.device), _build.align(
        x, gout, *([emb] if emb is not None else [])))   # dx, demb: new
    dw_part = (torch.empty(geo.slices, G, Em, dtype=torch.float32,
                           device=x.device)
               if need_dw and geo.slices > 1 else None)
    err = lib.dense_agg_bwd(
        _ptr(x), _ptr(src), _ptr(dst), _ptr(emask), _ptr(emb), _ptr(w),
        _ptr(gout), _ptr(dx), _ptr(demb), _ptr(dw), _ptr(dw_part), G, Sm, Em,
        d, int(relu), *geo.args(), _stream(x))
    _build.check(lib, err, "dense_agg_bwd")
    dense_agg_bwd.launches += 1
    dense_agg_bwd.instances[instance(need_demb, need_dw)] += 1
    return dx, demb, dw


def instance(need_demb: bool, need_dw: bool) -> str:
    """The name of K6-bwd's instance that computes dx and what is asked."""
    return "+".join(["dx"] + ["demb"] * need_demb + ["dw"] * need_dw)


dense_agg_bwd.launches = 0
dense_agg_bwd.instances = {instance(a, b): 0 for a in (False, True)
                           for b in (False, True)}   # launches by instance


def _load():
    lib = _build.load("dense_agg")
    if lib.dense_agg_fwd.argtypes is None:
        lib.dense_agg_fwd.argtypes = ([ctypes.c_void_p] * 7
                                      + [ctypes.c_int] * 10
                                      + [ctypes.c_void_p])
        lib.dense_agg_fwd.restype = ctypes.c_int
        lib.dense_agg_bwd.argtypes = ([ctypes.c_void_p] * 11
                                      + [ctypes.c_int] * 10
                                      + [ctypes.c_void_p])
        lib.dense_agg_bwd.restype = ctypes.c_int
    return lib
