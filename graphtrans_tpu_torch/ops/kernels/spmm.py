"""K7: the flat-layout message-passing sum over dst-sorted edges, and its
backward.

Computes

    out[i] = sum_{e: dst[e] = i} w[e] * msg(x[src[e]], emb[e])

with ``msg = relu(x + emb)`` (``relu_add``, GIN/GCN) or ``x + emb``
(``add``), ``w = edge_mask * edge_weight`` (the mask folded into the weight,
so padded edges add nothing), x ``[N, d]`` and emb ``[E, d]`` float32, and
src/dst ``[E]`` int32 with dst sorted ascending (``collate`` sorts the flat
edges by destination and puts padding edges at the tail, pointing at node
N-1). A node with no edge gets a zero row. The backward returns dx and
d_emb: with ``a = x[src] + emb``, ``d_emb[e] = w[e] * 1[a > 0] * g[dst[e]]``
(torch's relu gradient, 0 at a tie) and ``dx[s]`` the sum of d_emb over the
edges leaving s. ``edge_weight`` gets no gradient: the GCN norm comes from
the degree, hence from the mask alone, and a CUDA call whose edge_weight
requires one raises.

Replaces ``graphtrans_tpu/ops/pallas/spmm.py:gather_message_scatter`` (the
opt-in Pallas route of ``ops/scatter.py``). The JAX package has no backward
kernel for it: it trains through the XLA segment route
(``ops/scatter.py:93-105``), so the backward here is the port's own and its
reference is autograd through that route. The TPU kernel keeps x resident
in VMEM, walks aligned 256-edge tiles per 256-row node block and does the
scatter as a one-hot MXU matmul; all of that is for the TPU. The CSR row
pointer is built on the device with ``torch.searchsorted(dst, arange(N+1))``,
as the TPU kernel builds its block pointers, so no value comes back to the
host.

What bounds it on the H100: memory. Per valid edge the forward reads a row
of x (through the src gather) and a row of emb and does 4 flops a channel,
then writes N rows once: at the 512-graph code2 shape (d=300) about 0.4 GB
and 0.2 GFLOP; the backward must read x and g once and a row of emb per
valid edge, and write d_emb and dx, about 0.68 GB. Design (``csrc/spmm.cu``):
forward and backward each walk the valid edges in one major order, cut into
runs of whole rows (``edge_runs``: about ``RUN_COST`` units of work a run,
an edge ``EDGE_COST``, a row one; code2's rows hold a few edges each, so a
run holds some 8 edges and 3 rows), a warp a run. Its lanes load the
indices and weight of 32 edges at once, then it issues the rows of 2-4
edges together (16-byte loads where d and the addresses allow,
``bwd_launch``) before it adds any, so many edges' rows are in flight a
warp rather than one. The kernels fold the mask and ``edge_weight``
themselves, so a call with its batch's orders launches nothing before its
kernel (at code2's serving and train batches of 16 back-to-back calls are
paced by the host). One writer per output cell, no atomics.

Forward: ``DstOrder`` (``dst_order(batch)``, one per batch for every
layer) holds the row pointer of the dst-sorted edges, the live edges
before each row (a cumsum of the mask) and the runs, cut by live edges:
six small ops, no sort, nothing back to the host. The warp walks its
run's edges in batch order, sums each destination row in registers in
edge order, skipping masked edges and edges of weight 0, each product
rounded before its add, and writes the row once (zeros for a row with no
live edge). It stops at the run's last live edge, so the padding tail
(some 25k masked edges on the padding node's row at 512 graphs) is never
walked and no run pays for it.

Backward: the valid edges in src-major order (``SrcOrder``: a stable
device sort of the valid edges by src and a ``searchsorted`` row pointer;
``src_order(batch)`` keeps one on the batch). The warp writes each edge's
d_emb row, sums dx of the current row in registers in perm order and
writes each row's dx once (a row with no edge gets zeros). Masked edges
are in no row, and separate warps write their zero d_emb rows, 16 bytes a
lane.

K8's forward and dx (``ops/kernels/block_spmm.py``) run on these two walks
over the positions of a block plan's ``SlotOrder`` (``blocked_fwd``,
``blocked_dx``).

bf16 (the bf16 step): x, emb and the cotangent bf16, the weight float32
(a bf16 ``edge_weight``, the GCN norm under the cast, widened as the JAX
kernel widens it, ``spmm.py:120-123``). The forward's message and its
weighted sum are float32 and the output is rounded once
(``graphtrans_tpu/ops/pallas/spmm.py:156-164``: HIGHEST on float32
copies, then x's dtype); the backward sums dx in float32 over a source
row's edges and rounds it once, and rounds each d_emb row once. The JAX
package takes that kernel only at widths that are multiples of 128
(code2's 300 goes to ``ops/scatter.py:93-105``, which sums in bf16); the
port's K7 rounds as the kernel does at every width. The kernels are the
f32 ones templated on the element type (``csrc/spmm.cu``, 8-byte bf16
accesses where the f32 kernel makes 16-byte ones, so the launch is the
same); launches count by dtype in ``spmm.instances`` and
``spmm_bwd.instances``.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from . import _build

MESSAGES = ("relu_add", "add")


def _folded_weight(emask: torch.Tensor,
                   edge_weight: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The per-edge weight the kernel reads: the mask as 0/1, times
    ``edge_weight`` where given (``spmm.py:120-123`` of the JAX package)."""
    w = emask.to(torch.float32)
    return w if edge_weight is None else w * edge_weight.to(torch.float32)


def spmm_plain(x, emb, src, dst, emask, edge_weight=None,
               message: str = "relu_add") -> torch.Tensor:
    """Plain PyTorch version of K7: same arguments, same result. The
    message and the sum are float32, the result rounded once to x's dtype
    (bf16: the kernel's rounding; autograd then rounds dx and d_emb once
    each)."""
    m = x.float().index_select(0, src.long()) + emb.float()
    if message == "relu_add":
        m = torch.relu(m)
    elif message != "add":
        raise ValueError(f"spmm: message {message!r} not in {MESSAGES}")
    m = m * _folded_weight(emask, edge_weight)[:, None]
    out = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    return out.index_add_(0, dst.long(), m).to(x.dtype)


def spmm_bwd_plain(x, emb, src, dst, emask, g, edge_weight=None,
                   message: str = "relu_add"):
    """Plain version of K7's backward: (dx, d_emb) by autograd through
    ``spmm_plain`` for the cotangent ``g`` [N, d]."""
    with torch.enable_grad():
        xl, el = (t.detach().requires_grad_() for t in (x, emb))
        out = spmm_plain(xl, el, src, dst, emask, edge_weight, message)
        return torch.autograd.grad(out, (xl, el), g)


RUN_COST = 32  # units of work a backward run (a row 1, an edge EDGE_COST)
EDGE_COST = 3  # an edge's rows (g, emb, d_emb) against a row's dx


def edge_runs(sptr: torch.Tensor, num_edges: int) -> torch.Tensor:
    """Cuts the source rows [0, N) into the runs K7's backward walks, a warp
    each: ``rptr`` int32 [nruns + 1], run r the rows [rptr[r], rptr[r+1]).
    A row costs 1 and each of its edges EDGE_COST; run r takes the rows
    whose cost before them (``EDGE_COST * sptr[s] + s``) lies in [r, r+1) *
    RUN_COST, so no row is split and a run is about RUN_COST long, more
    where one row alone is longer. ``nruns`` follows from ``num_edges``
    (the edge slots, at least the valid edges), so it is known on the
    host; the runs past the valid edges' cost are empty. RUN_COST 32 beat
    16, 64 and 128 on the H100 (PERF.md §6)."""
    return _edge_runs(sptr, num_edges, RUN_COST)


def _edge_runs(sptr: torch.Tensor, num_edges: int,
               run_cost: int) -> torch.Tensor:
    N = sptr.shape[0] - 1
    long = torch.long
    cost = torch.add(_arange(N, 1, long, sptr.device), sptr[:N],
                     alpha=EDGE_COST)
    nruns = max(1, -(-(EDGE_COST * num_edges + N) // run_cost))
    return torch.searchsorted(
        cost, _arange(nruns + 1, run_cost, long, sptr.device), out_int32=True)


@functools.lru_cache(maxsize=64)
def _arange(n: int, step: int, dtype: torch.dtype,
            device: torch.device) -> torch.Tensor:
    """arange(0, n * step, step) on ``device``, made once a shape (a
    batch's orders then launch no arange)."""
    return torch.arange(0, n * step, step, dtype=dtype, device=device)


class SrcOrder:
    """The src-major edge order K7's backward walks: ``perm`` [E] lists the
    valid edges of each source row s at ``[sptr[s], sptr[s+1])`` in their
    batch order (a stable sort; masked edges sort past row N-1 and are in
    no row), and ``runs()`` the rows cut into runs (``edge_runs``).
    Computed on the device at first use, then shared: one per batch serves
    every layer."""

    def __init__(self, src: torch.Tensor, emask: torch.Tensor,
                 num_nodes: int):
        self.src, self.emask, self.num_nodes = src, emask, num_nodes
        self.num_edges = src.shape[0]
        self._order = self._runs = None

    def get(self):
        if self._order is None:
            N = self.num_nodes
            key = torch.where(self.emask, self.src, N)
            skey, perm = torch.sort(key, stable=True)
            sptr = torch.searchsorted(
                skey, torch.arange(N + 1, dtype=skey.dtype,
                                   device=skey.device), out_int32=True)
            self._order = (perm.to(torch.int32), sptr)
        return self._order

    def runs(self) -> torch.Tensor:
        if self._runs is None:
            self._runs = edge_runs(self.get()[1], self.num_edges)
        return self._runs


def src_order(batch) -> SrcOrder:
    """The ``SrcOrder`` of a batch's flat edges, made at the first call and
    kept on the batch: one sort serves every layer and every step that
    reuses the batch."""
    order = batch.__dict__.get("_src_order")
    if order is None:
        order = SrcOrder(batch.edge_src, batch.edge_mask,
                         batch.num_node_slots)
        object.__setattr__(batch, "_src_order", order)   # a frozen dataclass
    return order


class DstOrder:
    """The dst-major order K7's forward walks: ``ptr`` [N + 1] int32, row
    i's edges at ``[ptr[i], ptr[i+1])`` (dst must be sorted), ``dptr`` [N +
    1] int32, the live (masked-in) edges before row i, and ``runs()`` the
    rows cut into runs (``edge_runs`` of ``dptr``: a run costs its live
    edges, so the masked tail costs nothing). Nothing is sorted and nothing
    comes back to the host. Computed on the device at first use, then
    shared: one per batch serves every layer."""

    def __init__(self, dst: torch.Tensor, emask: torch.Tensor,
                 num_nodes: int):
        self.dst, self.emask, self.num_nodes = dst, emask, num_nodes
        self.num_edges = dst.shape[0]
        self._order = self._runs = None

    def get(self):
        if self._order is None:
            N, E, dev = self.num_nodes, self.num_edges, self.dst.device
            live = torch.zeros(E + 1, dtype=torch.int32, device=dev)
            torch.cumsum(self.emask, 0, dtype=torch.int32, out=live[1:])
            ptr = torch.searchsorted(
                self.dst, _arange(N + 1, 1, self.dst.dtype, dev),
                out_int32=True)
            self._order = (ptr, live.index_select(0, ptr))
        return self._order

    def runs(self) -> torch.Tensor:
        if self._runs is None:
            self._runs = edge_runs(self.get()[1], self.num_edges)
        return self._runs


def dst_order(batch) -> DstOrder:
    """The ``DstOrder`` of a batch's flat edges, made at the first call and
    kept on the batch, as ``src_order`` keeps its ``SrcOrder``."""
    order = batch.__dict__.get("_dst_order")
    if order is None:
        order = DstOrder(batch.edge_dst, batch.edge_mask,
                         batch.num_node_slots)
        object.__setattr__(batch, "_dst_order", order)   # a frozen dataclass
    return order


def _same_edges(order, what: str, x: torch.Tensor, n_edges: int):
    """Raise where ``order`` (a SrcOrder or DstOrder) was made for another
    node or edge count than the call's (the kernel would leave rows
    unwritten)."""
    if order.num_nodes != x.shape[0] or order.num_edges != n_edges:
        raise ValueError(f"{what}: order is of {order.num_nodes} nodes and "
                         f"{order.num_edges} edges, the call of "
                         f"{x.shape[0]} and {n_edges}")


DTYPES = (torch.float32, torch.bfloat16)   # K7's and K7-bwd's instances


def _check(x, emb, src, dst, emask, edge_weight, message, g=None):
    N, d = x.shape
    E = src.shape[0]
    dt = x.dtype if x.dtype in DTYPES else torch.float32
    want = [(x, dt, (N, d)), (emb, dt, (E, d)),
            (src, torch.int32, (E,)), (dst, torch.int32, (E,)),
            (emask, torch.bool, (E,))]
    if edge_weight is not None:
        want.append((edge_weight, edge_weight.dtype if edge_weight.dtype
                     in DTYPES else torch.float32, (E,)))
    if g is not None:
        want.append((g, dt, (N, d)))
    for t, dtype, shape in want:
        if t.device != x.device:
            raise ValueError(f"spmm: tensors on {t.device} and {x.device}")
        if t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(f"spmm: expected {dtype} {shape}, got "
                             f"{t.dtype} {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError("spmm: inputs must be contiguous")
    if message not in MESSAGES:
        raise ValueError(f"spmm: message {message!r} not in {MESSAGES}")


def _weight32(edge_weight):
    """The kernel's float32 weight: a bf16 one (the GCN norm under the
    cast) widened, as the JAX kernel widens it."""
    return None if edge_weight is None else edge_weight.float()


def _instance(x: torch.Tensor) -> str:
    """The counted instance: "f32" or "bf16"."""
    return "bf16" if x.dtype == torch.bfloat16 else "f32"


def _launch_fwd(x, emb, src, dst, emask, edge_weight, message,
                rows: DstOrder):
    N, d = x.shape
    out = torch.empty_like(x)
    if out.numel() == 0:
        return out
    ptr, dptr = rows.get()
    rptr = rows.runs()
    edge_weight = _weight32(edge_weight)
    vec, vpl, slices = bwd_launch(d, _build.align(x, emb))   # out: new
    lib = _load()
    entry = _build.entry(lib, "spmm_fwd", x.dtype)
    err = entry(            # ints: ctypes makes each a c_void_p; the kernel
        *(t.data_ptr()      # folds emask * edge_weight itself
          for t in (x, emb, src, dst, emask, ptr, dptr, rptr)),
        edge_weight.data_ptr() if edge_weight is not None else None,
        out.data_ptr(), N, d, rptr.shape[0] - 1, int(message == "relu_add"),
        vec, vpl, slices, _stream(x))
    _build.check(lib, err, entry.__name__)
    spmm.launches += 1
    spmm.instances[_instance(x)] += 1
    return out


BWD_MAX_VPL = 4  # loads a lane a row (csrc/spmm.cu MAX_VPL)


@functools.lru_cache(maxsize=None)
def bwd_launch(d: int, align: int = 4):
    """K7's and K7-bwd's (vec, vpl, slices) at width d: ``vec`` floats a
    load (4 where d and the addresses, ``align`` floats, allow; else 1),
    ``vpl`` loads a lane a row, so a warp covers 32 * vec * vpl channels,
    and ``slices`` such warps' widths (grid y) to cover d: one slice up to
    d 512 with vec 4."""
    vec = 4 if d % 4 == 0 and align % 4 == 0 else 1
    lanes = -(-d // vec)
    slices = -(-lanes // (32 * BWD_MAX_VPL))
    vpl = -(-lanes // (32 * slices))
    return vec, vpl, slices


def _stream(t: torch.Tensor):
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


class _Spmm(torch.autograd.Function):
    """K7 on CUDA tensors with K7's backward kernel as its gradient (dx and
    d_emb)."""

    @staticmethod
    def forward(ctx, x, emb, src, dst, emask, edge_weight, message, order,
                rows):
        ctx.save_for_backward(x, emb, src, dst, emask, edge_weight)
        ctx.message, ctx.order = message, order
        return _launch_fwd(x, emb, src, dst, emask, edge_weight, message,
                           rows)

    @staticmethod
    def backward(ctx, g):
        x, emb, src, dst, emask, edge_weight = ctx.saved_tensors
        dx, demb = spmm_bwd(x, emb, src, dst, emask, g.contiguous(),
                            ctx.order, edge_weight, ctx.message)
        return dx, demb, None, None, None, None, None, None, None


def spmm(x: torch.Tensor, emb: torch.Tensor, src: torch.Tensor,
         dst: torch.Tensor, emask: torch.Tensor,
         edge_weight: Optional[torch.Tensor] = None,
         message: str = "relu_add",
         order: Optional[SrcOrder] = None,
         rows: Optional[DstOrder] = None) -> torch.Tensor:
    """K7 forward. CPU tensors take ``spmm_plain``; CUDA tensors launch the
    kernel or raise. Every edge must hold src and dst in ``[0, N)`` and dst
    must be sorted. The kernel walks ``rows``, the ``DstOrder`` of these
    edges (``dst_order(batch)`` for a batch's, so that a call launches
    nothing before the kernel); without it the call makes one. Where a
    gradient is wanted the result carries K7's backward kernel
    (``spmm_bwd``), which walks ``order``, the ``SrcOrder`` of these edges
    (``src_order(batch)`` for a batch's)."""
    if x.device.type == "cpu":
        return spmm_plain(x, emb, src, dst, emask, edge_weight, message)
    if x.device.type != "cuda":
        raise ValueError(f"spmm: unsupported device {x.device}")
    _check(x, emb, src, dst, emask, edge_weight, message)
    if rows is None:
        rows = DstOrder(dst, emask, x.shape[0])
    _same_edges(rows, "spmm", x, src.shape[0])
    if torch.is_grad_enabled() and (x.requires_grad or emb.requires_grad
                                    or (edge_weight is not None
                                        and edge_weight.requires_grad)):
        if edge_weight is not None and edge_weight.requires_grad:
            raise ValueError(
                "spmm: edge_weight requires a gradient, which K7's backward "
                "does not compute (it returns dx and d_emb; the GCN norm "
                "comes from the mask alone): pass edge_weight.detach()")
        if order is None:
            raise ValueError("spmm: a gradient needs order, the SrcOrder of "
                             "these edges (src_order(batch) for a batch's)")
        return _Spmm.apply(x, emb, src, dst, emask, edge_weight, message,
                           order, rows)
    return _launch_fwd(x, emb, src, dst, emask, edge_weight, message, rows)


spmm.launches = 0
spmm.instances = {"f32": 0, "bf16": 0}   # launches by dtype


def spmm_bwd(x: torch.Tensor, emb: torch.Tensor, src: torch.Tensor,
             dst: torch.Tensor, emask: torch.Tensor, g: torch.Tensor,
             order: SrcOrder, edge_weight: Optional[torch.Tensor] = None,
             message: str = "relu_add"):
    """K7 backward: (dx [N, d], d_emb [E, d]) for the cotangent ``g`` of
    ``spmm(x, emb, src, dst, emask, edge_weight, message)``; the kernel
    walks ``order``, the ``SrcOrder`` of these edges. CPU tensors take
    ``spmm_bwd_plain``; CUDA tensors launch the kernel or raise. An
    ``order`` of another node or edge count raises on either: the kernel
    writes the dx rows of ``order``'s nodes only."""
    _same_edges(order, "spmm_bwd", x, src.shape[0])
    if x.device.type == "cpu":
        return spmm_bwd_plain(x, emb, src, dst, emask, g, edge_weight,
                              message)
    if x.device.type != "cuda":
        raise ValueError(f"spmm_bwd: unsupported device {x.device}")
    _check(x, emb, src, dst, emask, edge_weight, message, g)
    N, d = x.shape
    E = src.shape[0]
    dx, demb = torch.empty_like(x), torch.empty_like(emb)
    if N == 0 or d == 0:
        return dx, demb
    perm, sptr = order.get()
    rptr = order.runs()
    edge_weight = _weight32(edge_weight)
    vec, vpl, slices = bwd_launch(d, _build.align(x, emb, g))  # dx, demb: new
    lib = _load()
    entry = _build.entry(lib, "spmm_bwd", x.dtype)
    err = entry(            # ints: ctypes makes each a c_void_p; the kernel
        *(t.data_ptr()      # folds emask * edge_weight itself
          for t in (x, emb, src, dst, perm, sptr, rptr, emask)),
        edge_weight.data_ptr() if edge_weight is not None else None,
        *(t.data_ptr() for t in (g, dx, demb)),
        N, E, d, rptr.shape[0] - 1, int(message == "relu_add"), vec, vpl,
        slices, _stream(x))
    _build.check(lib, err, entry.__name__)
    spmm_bwd.launches += 1
    spmm_bwd.instances[_instance(x)] += 1
    return dx, demb


spmm_bwd.launches = 0
spmm_bwd.instances = {"f32": 0, "bf16": 0}   # launches by dtype


def _load():
    lib = _build.load("spmm")
    if lib.spmm_fwd.argtypes is None:
        lib.spmm_fwd.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 7
                                 + [ctypes.c_void_p])
        lib.spmm_fwd.restype = ctypes.c_int
        lib.spmm_bwd.argtypes = ([ctypes.c_void_p] * 12 + [ctypes.c_int] * 8
                                 + [ctypes.c_void_p])
        lib.spmm_bwd.restype = ctypes.c_int
        lib.blocked_fwd.argtypes = ([ctypes.c_void_p] * 9
                                    + [ctypes.c_int] * 7 + [ctypes.c_void_p])
        lib.blocked_fwd.restype = ctypes.c_int
        lib.blocked_dx.argtypes = ([ctypes.c_void_p] * 10
                                   + [ctypes.c_int] * 7 + [ctypes.c_void_p])
        lib.blocked_dx.restype = ctypes.c_int
    return lib
