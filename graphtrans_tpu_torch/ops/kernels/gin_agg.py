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
bandwidth.

Both directions take a grid sized to the card, by one set of rules
(``fwd_geometry``, ``bwd_geometry``): at the throughput batch a block
covers all of d for a chunk of graphs, a few hundred blocks, one wave; at
a small batch, or where a block's shared memory could not hold a graph,
the channels are split into slices. A thread owns ``vec`` neighbouring
channels (16-byte copies and loads where d % 4 == 0, so d=300 leaves 21
of 96 lanes idle, not a third of each 128-channel slice).

Forward (``csrc/gin_agg.cu``): a graph's x slice lands in shared memory by
``cp.async``; where a block walks a chunk of graphs, the next graph's x is
issued when the walk ends and lands while that graph's edges are sorted
(a second buffer, so that it lands during the walk, would leave two blocks
an SM instead of five at the bench batch, and measured slower: PERF.md
§6). Its valid edges
are sorted by (dst, slot) in shared memory once for all of d (masked slots
dropped), so each output row is summed in registers, its edges in slot
order as the parent design added them into a shared accumulator, and
written once with ``scale*x`` added: the parent's bits. The bond table's
rows come through the read-only cache, each edge's T[a0] + T[a1] + ... in
``TableEmb``'s order.

Backward: a graph's gout
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
from .rounding import round_grad, round_value

_SMEM_MAX = 232448  # bytes of shared memory a block can use on Hopper
SM_SHARED = 228 * 1024  # shared memory of an SM; a block reserves 1 KB more
SMS = 132  # SMs of the H100 SXM, where the card cannot be asked
BWD_MAX_THREADS = 256  # threads a block, forward or backward (csrc/gin_agg.cu)
BWD_MAX_F = 4  # table rows an edge sums in the backward
MIN_SLICE_LANES = 8  # lanes a channel slice keeps when the grid is split


def gin_agg_plain(x, src, dst, emask, attr, tbl, w=None, scale=None):
    """Plain PyTorch version of K1: same arguments, same result; autograd
    differentiates it. x [G,Sm,d] f32 or bf16; src/dst/emask [G,Em];
    attr [G,F,Em] int; tbl [V,d] and w [G,Em] or None in x's dtype; scale
    a 1-element f32 tensor or None. bf16 inputs take ``_gin_agg_bf16``,
    which rounds where the bf16 kernels round."""
    if x.dtype == torch.bfloat16:
        return _gin_agg_bf16(x, src, dst, emask, attr, tbl, w, scale)
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


def _gin_agg_bf16(x, src, dst, emask, attr, tbl, w, scale):
    """K1 in bf16, as the JAX kernel computes it in bf16
    (``graphtrans_tpu/ops/pallas/gin_agg.py:_fwd_kernel``, ``_bwd_kernel``):
    the pre-activation x_src + sum_f T[attr_f] summed in float32, relu, times
    w in float32; each message rounded to bf16 once, summed in float32 at
    its destination, ``scale*x`` added in float32 and the result rounded
    once. Backward (autograd through the float32 ops): dmsg = gout[dst]
    (times w, masked by relu and the mask) rounded to bf16 once; dx its sum
    at the source plus ``scale*gout`` in float32, rounded once; dT summed in
    float32 and rounded to T's dtype; dw a float32 sum over channels,
    rounded to w's dtype; dscale a float32 sum."""
    G, Sm, d = x.shape
    Em = src.shape[1]
    attr = attr.long()
    xf, tf = x.float(), tbl.float()
    emb = tf[attr[:, 0]]
    for f in range(1, attr.shape[1]):
        emb = emb + tf[attr[:, f]]                           # [G, Em, d]
    xs = torch.gather(xf, 1, src.long()[..., None].expand(G, Em, d))
    pre = round_grad(xs + emb, x.dtype)                     # dmsg's rounding
    m = torch.relu(pre)
    if w is not None:
        m = m * w.float()[..., None]
    m = round_value(m.masked_fill(~emask[..., None], 0.0), x.dtype)
    out = torch.zeros_like(xf).scatter_add_(
        1, dst.long()[..., None].expand(G, Em, d), m)
    if scale is not None:
        out = out + scale.reshape(()) * xf
    return out.to(x.dtype)


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


DTYPES = (torch.float32, torch.bfloat16)   # the kernels' instances


def _check(x, src, dst, emask, attr, tbl, w, scale, gout=None):
    """x, tbl, w and gout in one dtype of DTYPES (the f32 or the bf16
    instance; mixed dtypes raise), scale f32, the rest as the kernels read
    them; every tensor on x's device and contiguous."""
    G, Sm, d = x.shape
    Em = src.shape[1]
    F = attr.shape[1]
    dt = x.dtype if x.dtype in DTYPES else torch.float32
    want = [(x, dt, (G, Sm, d)), (src, torch.int32, (G, Em)),
            (dst, torch.int32, (G, Em)), (emask, torch.bool, (G, Em)),
            (attr, torch.int32, (G, F, Em)),
            (tbl, dt, (tbl.shape[0], d))]
    if w is not None:
        want.append((w, dt, (G, Em)))
    if scale is not None:
        want.append((scale, torch.float32, (1,)))
    if gout is not None:
        want.append((gout, dt, (G, Sm, d)))
    dev = x.device
    for t, dtype, shape in want:   # one test a tensor: at serve64 the
        if (t.dtype != dtype or t.shape != shape or t.device != dev
                or not t.is_contiguous()):   # host paces the calls
            _refuse(t, dtype, shape, dev)


def _refuse(t, dtype, shape, dev):
    if t.device != dev:
        raise ValueError(f"gin_agg: tensors on {t.device} and {dev}")
    if t.dtype != dtype or tuple(t.shape) != shape:
        raise ValueError(f"gin_agg: expected {dtype} {shape}, got "
                         f"{t.dtype} {tuple(t.shape)}")
    raise ValueError("gin_agg: inputs must be contiguous")


XRING = 8  # rows of x in flight in a backward block's ring (csrc/gin_agg.cu)


def _word_bytes(n: int, esize: int) -> int:
    """Bytes of n elements of ``esize`` bytes, rounded up to whole words."""
    return -(-n * esize // 4) * 4


def bwd_smem(Sm: int, Em: int, F: int, V: int, channels: int, threads: int,
             has_w: bool, xrows: int, esize: int = 4) -> int:
    """Shared bytes of a K1-bwd block (``csrc/gin_agg.cu:bwd_smem``): the
    sorted edge records, one graph's gout slice and ``xrows`` rows of x
    (the slice, or a ring of XRING) in elements of ``esize`` bytes (4: the
    f32 instance, 2: bf16), the bond table's gradient, the staged edge
    lists, with ``w`` the weights and per-warp dw sums, and 32 floats of
    scratch."""
    words = 8 * Em + V * channels + Em * (F + 4) + 32
    if has_w:
        words += Em * (1 + threads // 32)
    return 4 * words + _word_bytes((Sm + xrows) * channels, esize)


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


def _slices(G: int, d: int, sms: int, align: int, smem_of, what: str):
    """The rules K1's forward and backward launches share: (vec, lanes a
    slice, slices, threads). A thread takes ``vec`` channels: 4 where d
    and the addresses (``align`` floats) allow, else 1. The channels split
    into slices only where the graphs alone would leave SMs without a
    block (a slice keeps at least MIN_SLICE_LANES lanes: at d 40 one slice
    of 10 lanes), or where a block's shared bytes ``smem_of(channels,
    threads)`` pass its limit; a slice is a whole number of warps, its
    last warp maybe part idle."""
    vec = 4 if d % 4 == 0 and align % 4 == 0 else 1
    lanes = -(-d // vec)
    per = -(-lanes // max(1, min(-(-sms // G), lanes // MIN_SLICE_LANES)))
    while True:   # lanes a slice
        slices = -(-lanes // per)
        threads = _round(per, 32)
        if (threads <= BWD_MAX_THREADS
                and smem_of(per * vec, threads) <= _SMEM_MAX):
            return vec, per, slices, threads
        if per == 1:
            raise ValueError(f"{what} need more than {_SMEM_MAX} bytes of "
                             f"shared memory")
        per = min(per - 1, -(-lanes // (slices + 1)))


def _per_sm(smem: int) -> int:
    """Blocks of ``smem`` shared bytes that an SM holds at once."""
    return SM_SHARED // (smem + 1024)


def _one_wave(G: int, slices: int, smem: int, sms: int) -> bool:
    """Whether a block for each graph and slice fits the card at once."""
    return smem <= _SMEM_MAX and G * slices <= sms * _per_sm(smem)


def _chunks(G: int, slices: int, smem: int, sms: int):
    """(graphs a block, blocks along the graphs): as many blocks as the
    shared memory lets the card hold take every graph in one wave."""
    chunks = max(1, min(G, sms * _per_sm(smem) // slices))
    gpb = -(-G // chunks)
    return gpb, -(-G // gpb)


@functools.lru_cache(maxsize=None)
def bwd_geometry(G: int, Sm: int, Em: int, F: int, V: int, d: int,
                 has_w: bool, sms: int = SMS, align: int = 4,
                 esize: int = 4) -> BwdGeometry:
    """K1-bwd's launch for G graphs of stride Sm with Em edge slots and F
    table rows an edge, at width d, on a card of ``sms`` SMs; ``align`` is
    the widest vector (in elements) that the tensors' addresses allow,
    ``esize`` the bytes of an element (4: the f32 instance, 2: bf16).

    Vector width and channel slices by ``_slices`` (with x as a ring of
    XRING rows). Where a block of each graph (and slice) fits the card at
    once, a block walks one graph and holds its x whole; else x streams
    through a ring of XRING rows, and the graphs a block are chosen so
    that as many blocks as the shared memory lets an SM hold take every
    graph in one wave."""
    if not 1 <= F <= BWD_MAX_F:
        raise ValueError(f"gin_agg_bwd: {F} table rows an edge (1 to "
                         f"{BWD_MAX_F})")
    ring = min(XRING, Sm)
    vec, per, slices, threads = _slices(
        G, d, sms, align,
        lambda ch, th: bwd_smem(Sm, Em, F, V, ch, th, has_w, ring, esize),
        f"gin_agg_bwd: stride {Sm} and {Em} edge slots")
    smem = bwd_smem(Sm, Em, F, V, per * vec, threads, has_w, ring, esize)
    xrows = ring
    whole = bwd_smem(Sm, Em, F, V, per * vec, threads, has_w, Sm, esize)
    if _one_wave(G, slices, whole, sms):
        smem, xrows = whole, Sm
    gpb, chunks = _chunks(G, slices, smem, sms)
    return BwdGeometry(vec, gpb, chunks, slices, per * vec, threads, smem,
                       xrows)


def fwd_smem(Sm: int, Em: int, F: int, channels: int, has_w: bool,
             esize: int = 4) -> int:
    """Shared bytes of a K1 forward block (``csrc/gin_agg.cu:fwd_smem``):
    one graph's x slice in elements of ``esize`` bytes, and per edge slot
    its sort key and its sorted record (src and dst in one word, the F
    table rows, with w the weight)."""
    return (_word_bytes(Sm * channels, esize)
            + 4 * Em * (2 + F + int(has_w)))


@dataclass(frozen=True)
class FwdGeometry:
    """One launch of K1's forward: ``vec`` neighbouring channels a thread,
    ``gpb`` graphs a block (``chunks`` blocks along the graphs),
    ``slices`` channel slices of ``channels`` each (``grid`` = (chunks,
    slices)), ``threads`` a block and its dynamic shared bytes. ``args``
    are the ints the C entry checks and launches."""
    vec: int
    gpb: int
    chunks: int
    slices: int
    channels: int
    threads: int
    smem: int

    @property
    def grid(self) -> tuple:
        return (self.chunks, self.slices)

    def args(self) -> tuple:
        return (self.vec, self.gpb, self.slices, self.channels, self.threads,
                self.smem)


@functools.lru_cache(maxsize=None)
def fwd_geometry(G: int, Sm: int, Em: int, F: int, V: int, d: int,
                 has_w: bool, sms: int = SMS, align: int = 4,
                 esize: int = 4) -> FwdGeometry:
    """K1's forward launch, the arguments as ``bwd_geometry``'s. Vector
    width and channel slices by ``_slices``. Where a block of each graph
    (and slice) fits the card at once, a block walks one graph; else it
    walks a chunk of graphs (as many blocks as the shared memory lets an
    SM hold, one wave). Every shape that fits one lane's channels takes a
    launch: stride 128 at d 300 splits no channel."""
    if F < 1:
        raise ValueError(f"gin_agg: {F} table rows an edge (at least 1)")
    if Sm > 65536 or Sm * Em >= 2**31 - 1:
        raise ValueError(f"gin_agg: stride {Sm} and {Em} edge slots do not "
                         f"fit a sort key (stride at most 65536)")
    vec, per, slices, threads = _slices(
        G, d, sms, align,
        lambda ch, th: fwd_smem(Sm, Em, F, ch, has_w, esize),
        f"gin_agg: stride {Sm} and {Em} edge slots")
    smem = fwd_smem(Sm, Em, F, per * vec, has_w, esize)
    gpb, chunks = _chunks(G, slices, smem, sms)
    return FwdGeometry(vec, gpb, chunks, slices, per * vec, threads, smem)


@functools.lru_cache(maxsize=None)
def _sms_of(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _sms(device) -> int:
    """The card's SMs, asked once a card: at serve64 the host's work a call
    paces the calls (PERF.md §6)."""
    return _sms_of(device.index if device.index is not None
                   else torch.cuda.current_device())


def _ptr(t: Optional[torch.Tensor]):
    """A tensor's address for a ``c_void_p`` argument (None: NULL)."""
    return t.data_ptr() if t is not None else None


def _stream(t: torch.Tensor):
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def _launch_fwd(x, src, dst, emask, attr, tbl, w, scale):
    G, Sm, d = x.shape
    out = torch.empty_like(x)
    if out.numel() == 0:
        return out
    Em, F, V = src.shape[1], attr.shape[1], tbl.shape[0]
    geo = fwd_geometry(G, Sm, Em, F, V, d, w is not None, _sms(x.device),
                       _build.align(x, tbl, out), x.element_size())
    lib = _load()
    entry = _build.entry(lib, "gin_agg_fwd", x.dtype)
    err = entry(
        _ptr(x), _ptr(src), _ptr(dst), _ptr(emask), _ptr(attr), _ptr(tbl),
        _ptr(w), _ptr(scale), _ptr(out), G, Sm, Em, F, V, d, *geo.args(),
        _stream(x))
    _build.check(lib, err, entry.__name__)
    gin_agg.launches += 1
    gin_agg.instances[_INSTANCE[x.dtype]] += 1
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
gin_agg.instances = {"f32": 0, "bf16": 0}   # launches by instance


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
    f32 = x.dtype == torch.float32
    new = lambda *shape, dtype=torch.float32: torch.empty(
        shape, dtype=dtype, device=x.device)
    dx, dtbl = new(G, Sm, d, dtype=x.dtype), new(V, d, dtype=x.dtype)
    dw = new(G, Em, dtype=x.dtype) if w is not None else None
    dscale = new(1) if scale is not None else None
    if G == 0 or d == 0:
        dtbl.zero_()
        if dscale is not None:
            dscale.zero_()
        return dx, dtbl, dw, dscale
    geo = bwd_geometry(G, Sm, Em, F, V, d, w is not None, _sms(x.device),
                       _build.align(x, gout, tbl), x.element_size())
    dtbl_part = new(geo.chunks, V, d)
    dw_part = (new(geo.slices, G, Em)
               if w is not None and (geo.slices > 1 or not f32) else None)
    dsc_part = new(geo.chunks * geo.slices) if scale is not None else None
    lib = _load()
    entry = _build.entry(lib, "gin_agg_bwd", x.dtype)
    err = entry(
        _ptr(x), _ptr(src), _ptr(dst), _ptr(emask), _ptr(attr), _ptr(tbl),
        _ptr(w), _ptr(scale), _ptr(gout), _ptr(dx), _ptr(dtbl), _ptr(dw),
        _ptr(dscale), _ptr(dtbl_part), _ptr(dw_part), _ptr(dsc_part), G, Sm,
        Em, F, V, d, *geo.args(), _stream(x))
    _build.check(lib, err, entry.__name__)
    gin_agg_bwd.launches += 1
    gin_agg_bwd.instances[_INSTANCE[x.dtype]] += 1
    return dx, dtbl, dw, dscale


gin_agg_bwd.launches = 0
gin_agg_bwd.instances = {"f32": 0, "bf16": 0}   # launches by instance
_INSTANCE = {torch.float32: "f32", torch.bfloat16: "bf16"}




def _load():
    lib = _build.load("gin_agg")
    if lib.gin_agg_fwd.argtypes is None:
        lib.gin_agg_fwd.argtypes = ([ctypes.c_void_p] * 9
                                    + [ctypes.c_int] * 12 + [ctypes.c_void_p])
        lib.gin_agg_fwd.restype = ctypes.c_int
        lib.gin_agg_bwd.argtypes = ([ctypes.c_void_p] * 16
                                    + [ctypes.c_int] * 13 + [ctypes.c_void_p])
        lib.gin_agg_bwd.restype = ctypes.c_int
    return lib
