"""K8: the flat-layout message-passing sum over the blocked-CSR chunk plans
(``ops/block_plan.py``), and its backward (d_emb and dx).

Computes K7's function in the plans' order:

    out[maj] = sum over the real slots of the dst-major plan of
               w[slot] * msg(x[min] + emb_fwd[slot])

with ``maj = blk_out[c]*NB + loc_out[c, s]`` (the edge's dst),
``min = blk_in[c]*NB + loc_in[c, s]`` (its src), a slot real where
``mask > 0``, ``msg = relu`` (``relu_add``) or the identity (``add``),
x ``[N, d]`` with ``N % 128 == 0``, emb_fwd and emb_bwd ``[C*EB, d]`` (the
edge embeddings in the dst-major and src-major chunk orders), w_fwd and
w_bwd ``[C*EB]`` or None. A node no real slot reaches gets a zero row. The
backward gives ``d_emb[slot] = w * 1[x[min] + emb_fwd > 0] * g[maj]``
over the dst-major plan (0 on slots that are not real: the edge
encoder's bias gradient sums every slot) and dx over the src-major plan,
whose major rows are the srcs: ``dx[src] = sum w * 1[x[src] + emb > 0] *
g[dst]``, emb and w the src-major copies where they are given (as the JAX
kernel reads them) and else the dst-major ones, read through the
src-major plan's ``fwd_slot`` (each slot's dst-major slot, from
``collate``): both copies come from one encoder applied to the same
attribute row, and both weights are ``vals[src] * vals[dst]``, so the
values are the same. emb_bwd gets no gradient (emb_fwd carries the whole
d_emb), and w none: the GCN norm is structural, and a call whose w
requires a gradient raises.

Replaces ``graphtrans_tpu/ops/pallas/block_spmm.py:
blocked_gather_message_scatter`` (``_fwd_kernel``, ``_demb_kernel``,
``_dx_kernel``). The TPU kernel runs one grid step per chunk, gathers and
scatters each chunk's 512 slots as 128-wide one-hot MXU products and
carries the block's sum across its consecutive chunks in VMEM; those are
TPU idioms and none of them carries over.

What bounds it on the H100: memory. Per real slot the forward reads a row
of emb and gathers a row of x, and writes the N rows once; at the
512-graph code2 batch (N = 65536, d = 300, 171762 real slots of 1245184)
that is about 0.36 GB. d_emb must write all C*EB rows (1.49 GB there), dx
reads like the forward and g besides.

Forward (``csrc/spmm.cu:blocked_fwd_kernel``, K7's forward body): the
batch's ``SlotOrder`` (``slot_order(batch)``, made once a batch and shared
by the five layers) lists the real slots of the dst-major plan grouped by
major row (the edge's dst), in slot order within each row, with each
position's minor and major row and a row pointer; pad slots and pad chunks
are in no row. A warp walks a run of whole rows (``spmm.edge_runs`` of
the row pointer), issues the x and emb rows of several positions before
it adds any (16-byte loads where d % 4 == 0), sums each row in registers
and writes it once, zero for a row no real slot reaches. A row's terms
are added in slot order, each product rounded before its add, as the
plain version's ``index_add_`` adds them on the CPU. No shared
accumulator, no atomics, no barrier; nothing launched before the kernel
but the order, once a batch.

dx (``csrc/spmm.cu:blocked_dx_kernel``, K7-bwd's walk, dx only): a
``SlotOrder`` of the src-major plan, made once a batch where a gradient is
wanted (``src_slot_order(batch)``, whose positions name the dst-major
slot of their edge through ``fwd_slot``, so that the training step makes
no src-major emb copy and no src-major weight). A warp walks a run of
whole source rows, reads g[dst] and emb and w through each position's
slot, loads x of a row once, sums dx in registers in slot order and
writes each row once, zero for a row no real slot leaves: the order of
terms of the parent's shared sums, so the same bits.

d_emb (``csrc/block_spmm.cu``), one warp per slot, writes zero rows for
the slots that are not real. Without a gradient only the dst-major plan
is read: the src-major plan, its emb copy and weight may be None.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from ..block_plan import EB, NB, slot_rows
from . import _build, spmm

MESSAGES = ("relu_add", "add")
_PLAN = (("blk_out", torch.int32, 1), ("blk_in", torch.int32, 1),
         ("loc_out", torch.int32, 2), ("loc_in", torch.int32, 2),
         ("mask", torch.float32, 2))


def _real(plan) -> torch.Tensor:
    return plan["mask"].reshape(-1, 1) > 0


def _message(message: str):
    if message not in MESSAGES:
        raise ValueError(f"block_spmm: message {message!r} not in "
                         f"{MESSAGES}")
    return message == "relu_add"


def blocked_gather_message_scatter_plain(
        x, emb_fwd, emb_bwd, plan_fwd, plan_bwd, w_fwd=None, w_bwd=None,
        message: str = "relu_add") -> torch.Tensor:
    """Plain PyTorch version of K8's forward: gather at the minor rows,
    message, weight and mask, ``index_add_`` at the major rows in slot
    order. Only the dst-major plan and its emb copy enter the result."""
    relu = _message(message)
    maj, mnr = slot_rows(plan_fwd)
    m = x.index_select(0, mnr) + emb_fwd
    if relu:
        m = torch.relu(m)
    if w_fwd is not None:
        m = m * w_fwd.to(torch.float32)[:, None]
    m = torch.where(_real(plan_fwd), m, 0.0)
    return torch.zeros_like(x).index_add_(0, maj, m)


def blocked_gather_message_scatter_bwd_plain(
        x, emb_fwd, emb_bwd, plan_fwd, plan_bwd, g, w_fwd=None, w_bwd=None,
        message: str = "relu_add"):
    """(dx, d_emb) by autograd through the plain forward for the cotangent
    ``g`` [N, d]; emb_bwd's cotangent is zero (it does not enter)."""
    with torch.enable_grad():
        xl, el = (t.detach().requires_grad_() for t in (x, emb_fwd))
        out = blocked_gather_message_scatter_plain(
            xl, el, emb_bwd, plan_fwd, plan_bwd, w_fwd, w_bwd, message)
        return torch.autograd.grad(out, (xl, el), g)


def blocked_gather_message_scatter_demb_plain(x, g, emb_fwd, plan_fwd,
                                              w_fwd=None,
                                              message: str = "relu_add"):
    """Plain version of the d_emb kernel (dst-major plan), [C*EB, d]."""
    relu = _message(message)
    maj, mnr = slot_rows(plan_fwd)
    gate = g.index_select(0, maj)
    if w_fwd is not None:
        gate = gate * w_fwd.to(torch.float32)[:, None]
    if relu:
        gate = torch.where(x.index_select(0, mnr) + emb_fwd > 0, gate, 0.0)
    return torch.where(_real(plan_fwd), gate, 0.0)


def blocked_gather_message_scatter_dx_plain(x, g, emb_bwd, plan_bwd,
                                            w_bwd=None,
                                            message: str = "relu_add",
                                            slot=None):
    """Plain version of the dx kernel (src-major plan: major rows are the
    srcs, minor rows the dsts), [N, d]. ``slot`` [C*EB] (where given) is
    the row of emb_bwd and w_bwd each slot reads: with the plan's
    ``fwd_slot``, they are the dst-major copies."""
    relu = _message(message)
    if slot is not None:
        at = slot.long().clamp(min=0)            # pad slots: masked below
        emb_bwd = emb_bwd.index_select(0, at)
        w_bwd = None if w_bwd is None else w_bwd.index_select(0, at)
    src, dst = slot_rows(plan_bwd)
    gate = g.index_select(0, dst)
    if w_bwd is not None:
        gate = gate * w_bwd.to(torch.float32)[:, None]
    if relu:
        gate = torch.where(x.index_select(0, src) + emb_bwd > 0, gate, 0.0)
    gate = torch.where(_real(plan_bwd), gate, 0.0)
    return torch.zeros_like(x).index_add_(0, src, gate)


def _check(x, pairs, g=None):
    """pairs: (emb [C*EB, d], plan, w or None) per plan used."""
    N, d = x.shape
    if N % NB:
        raise ValueError(f"block_spmm: {N} node rows, not a multiple of {NB}")
    want = [(x, torch.float32, (N, d))]
    if g is not None:
        want.append((g, torch.float32, (N, d)))
    for emb, plan, w in pairs:
        C = plan["blk_out"].shape[0]
        for key, dtype, rank in _PLAN:
            want.append((plan[key], dtype, (C, EB)[:rank]))
        want.append((emb, torch.float32, (C * EB, d)))
        if w is not None:
            want.append((w, torch.float32, (C * EB,)))
    for t, dtype, shape in want:
        if t.device != x.device:
            raise ValueError(f"block_spmm: tensors on {t.device} and "
                             f"{x.device}")
        if t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(f"block_spmm: expected {dtype} {shape}, got "
                             f"{t.dtype} {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError("block_spmm: inputs must be contiguous")


def _refuse_weight_grad(w_fwd, w_bwd):
    if torch.is_grad_enabled() and any(
            w is not None and w.requires_grad for w in (w_fwd, w_bwd)):
        raise ValueError(
            "block_spmm: a slot weight requires a gradient, which K8 does "
            "not compute (the GCN norm is structural): pass w.detach()")


class SlotOrder:
    """The walk order of a block plan's real slots: ``get()`` gives
    (``slot``, ``src``, ``dst``, ``ptr``), int32 on the plan's device:
    positions ``[ptr[i], ptr[i+1])`` hold the real slots whose major row
    is i (the edge's dst in a dst-major plan, K8's forward; its src in a
    src-major one, K8-dx), in slot order, position k the edge between
    minor row ``src[k]`` and major row ``dst[k]`` and the slot ``slot[k]``,
    or with ``slot_map`` (``[C*EB]``) ``slot_map`` of it: the slot of the
    same edge in another plan, whose emb and weight rows the kernel then
    reads. The slots that are not real sort past row N-1 and are in no
    row. ``runs()`` cuts the rows into runs (``spmm.edge_runs``;
    ``num_edges``, at least the real slots and known on the host, sets how
    many: a batch's edge slots). One stable sort, made on the device at
    first use, then shared: one per batch serves every layer."""

    def __init__(self, plan: dict, num_nodes: int,
                 num_edges: Optional[int] = None,
                 slot_map: Optional[torch.Tensor] = None):
        self.plan, self.num_nodes, self.slot_map = plan, num_nodes, slot_map
        self.num_slots = plan["mask"].numel()
        self.num_edges = self.num_slots if num_edges is None else num_edges
        self._order = self._runs = None

    def get(self):
        if self._order is None:
            p, N = self.plan, self.num_nodes
            rows = lambda blk, loc: (blk[:, None] * NB + loc).reshape(-1)
            key = torch.where(p["mask"].reshape(-1) > 0,
                              rows(p["blk_out"], p["loc_out"]), N)
            dst, slot = torch.sort(key, stable=True)
            src = rows(p["blk_in"], p["loc_in"]).index_select(0, slot)
            ptr = torch.searchsorted(
                dst, spmm._arange(N + 1, 1, dst.dtype, dst.device),
                out_int32=True)
            slot = (slot.to(torch.int32) if self.slot_map is None
                    else self.slot_map.index_select(0, slot))
            self._order = (slot, src, dst, ptr)
        return self._order

    def runs(self) -> torch.Tensor:
        if self._runs is None:
            self._runs = spmm.edge_runs(self.get()[3], self.num_edges)
        return self._runs


def slot_order(batch) -> SlotOrder:
    """The ``SlotOrder`` of a batch's dst-major plan, made at the first
    call and kept on the batch, as ``spmm.dst_order`` keeps its
    ``DstOrder``."""
    order = batch.__dict__.get("_slot_order")
    if order is None:
        order = SlotOrder(batch.bsp_fwd, batch.num_node_slots,
                          batch.edge_src.shape[0])
        object.__setattr__(batch, "_slot_order", order)  # a frozen dataclass
    return order


def src_slot_order(batch) -> SlotOrder:
    """The ``SlotOrder`` of a batch's src-major plan that K8-dx walks, its
    positions naming the dst-major slot of their edge (``bsp_bwd
    ["fwd_slot"]``), so that dx reads emb_fwd and w_fwd: made at the first
    call and kept on the batch, as ``slot_order``."""
    order = batch.__dict__.get("_src_slot_order")
    if order is None:
        order = SlotOrder(batch.bsp_bwd, batch.num_node_slots,
                          batch.edge_src.shape[0],
                          slot_map=batch.bsp_bwd["fwd_slot"])
        object.__setattr__(batch, "_src_slot_order", order)
    return order


def _ptr(t):
    return ctypes.c_void_p(None if t is None else t.data_ptr())


def _stream(t: torch.Tensor):
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


class _Blocked(torch.autograd.Function):
    """K8 on CUDA tensors with the d_emb and dx kernels as its gradient."""

    @staticmethod
    def forward(ctx, x, emb_fwd, emb_bwd, w_fwd, w_bwd, plan_fwd, plan_bwd,
                message, rows, rows_bwd):
        ctx.save_for_backward(x, emb_fwd, emb_bwd, w_fwd, w_bwd)
        ctx.plans, ctx.message = (plan_fwd, plan_bwd), message
        ctx.rows_bwd = rows_bwd
        return _forward(x, emb_fwd, w_fwd, message, rows)

    @staticmethod
    def backward(ctx, g):
        x, emb_fwd, emb_bwd, w_fwd, w_bwd = ctx.saved_tensors
        plan_fwd, plan_bwd = ctx.plans
        g = g.contiguous()
        dx = demb = None
        if ctx.needs_input_grad[1]:
            demb = blocked_gather_message_scatter_demb(
                x, g, emb_fwd, plan_fwd, w_fwd, ctx.message)
        if ctx.needs_input_grad[0]:
            emb, w = (emb_fwd, w_fwd) if emb_bwd is None else (emb_bwd,
                                                                w_bwd)
            dx = blocked_gather_message_scatter_dx(
                x, g, emb, plan_bwd, w, ctx.message, rows=ctx.rows_bwd)
        return dx, demb, None, None, None, None, None, None, None, None


def _forward(x, emb_fwd, w_fwd, message, rows: SlotOrder):
    N, d = x.shape
    out = torch.empty_like(x)
    slot, src, dst, ptr = rows.get()
    rptr = rows.runs()
    vec, vpl, slices = spmm.bwd_launch(d, _build.align(x, emb_fwd))
    lib = spmm._load()           # K8's forward runs on K7's forward body
    err = lib.blocked_fwd(
        *(_ptr(t) for t in (x, emb_fwd, src, dst, slot, ptr, rptr, w_fwd,
                            out)),
        N, d, rptr.shape[0] - 1, int(message == "relu_add"), vec, vpl,
        slices, _stream(x))
    _build.check(lib, err, "blocked_fwd")
    blocked_gather_message_scatter.launches += 1
    return out


def _same_nodes(rows: SlotOrder, x, slots: int, what: str):
    if rows.num_nodes != x.shape[0] or rows.num_slots != slots:
        raise ValueError(f"block_spmm: {what} is the order of "
                         f"{rows.num_nodes} nodes and {rows.num_slots} "
                         f"slots, the call's of {x.shape[0]} and {slots}")


def blocked_gather_message_scatter(
        x: torch.Tensor, emb_fwd: torch.Tensor,
        emb_bwd: Optional[torch.Tensor], plan_fwd: dict,
        plan_bwd: Optional[dict], w_fwd: Optional[torch.Tensor] = None,
        w_bwd: Optional[torch.Tensor] = None, message: str = "relu_add",
        rows: Optional[SlotOrder] = None,
        rows_bwd: Optional[SlotOrder] = None) -> torch.Tensor:
    """K8 forward, with the JAX signature. CPU tensors take the plain
    version; CUDA tensors launch the kernel or raise. ``plan_fwd`` and
    ``plan_bwd`` are the batch's dst- and src-major plans as tensors on
    x's device (``blk_out`` grouped ascending, as ``build_block_plan``
    makes it). The kernel walks ``rows``, the ``SlotOrder`` of
    ``plan_fwd`` (``slot_order(batch)`` for a batch's, so that a call
    launches nothing before the kernel); without it the call makes one.
    Where x or emb_fwd wants a gradient the result carries the d_emb and
    dx kernels, and the src-major plan is needed: dx walks ``rows_bwd``, a
    ``SlotOrder`` of it, reading emb_bwd and w_bwd at each position's own
    slot where emb_bwd is given, else emb_fwd and w_fwd through the plan's
    ``fwd_slot`` (``src_slot_order(batch)``, made once a batch); without
    it the call makes one. Without a gradient the src-major plan, its emb
    copy and weight may be None."""
    _message(message)
    grad = torch.is_grad_enabled() and (x.requires_grad
                                        or emb_fwd.requires_grad)
    if ((emb_bwd is not None and plan_bwd is None)
            or (emb_bwd is None and w_bwd is not None)):
        raise ValueError("block_spmm: give the src-major emb copy with its "
                         "plan and its weight with the copy, together")
    if emb_bwd is not None and (w_fwd is None) != (w_bwd is None):
        raise ValueError("block_spmm: give both slot weights or neither")
    if grad and (plan_bwd is None or (emb_bwd is None
                                      and "fwd_slot" not in plan_bwd)):
        raise ValueError("block_spmm: a gradient needs the src-major plan, "
                         "with its fwd_slot or with its emb copy and "
                         "weight (dx walks them)")
    if grad and rows_bwd is not None and (
            (rows_bwd.slot_map is None) != (emb_bwd is not None)):
        raise ValueError("block_spmm: rows_bwd names the dst-major slots "
                         "exactly where emb_bwd is not given")
    _refuse_weight_grad(w_fwd, w_bwd)
    if x.device.type == "cpu":
        return blocked_gather_message_scatter_plain(
            x, emb_fwd, emb_bwd, plan_fwd, plan_bwd, w_fwd, w_bwd, message)
    if x.device.type != "cuda":
        raise ValueError(f"block_spmm: unsupported device {x.device}")
    pairs = [(emb_fwd, plan_fwd, w_fwd)]
    if emb_bwd is not None:
        pairs.append((emb_bwd, plan_bwd, w_bwd))
    _check(x, pairs)
    if rows is None:
        rows = SlotOrder(plan_fwd, x.shape[0])
    _same_nodes(rows, x, emb_fwd.shape[0], "rows")
    if not grad:
        return _forward(x, emb_fwd, w_fwd, message, rows)
    if rows_bwd is None:
        rows_bwd = SlotOrder(plan_bwd, x.shape[0], slot_map=(
            None if emb_bwd is not None else plan_bwd["fwd_slot"]))
    return _Blocked.apply(x, emb_fwd, emb_bwd, w_fwd, w_bwd, plan_fwd,
                          plan_bwd, message, rows, rows_bwd)


blocked_gather_message_scatter.launches = 0


def blocked_gather_message_scatter_demb(
        x: torch.Tensor, g: torch.Tensor, emb_fwd: torch.Tensor,
        plan_fwd: dict, w_fwd: Optional[torch.Tensor] = None,
        message: str = "relu_add") -> torch.Tensor:
    """K8's d_emb [C*EB, d] for the cotangent g of its forward. CPU tensors
    take the plain version; CUDA tensors launch the kernel or raise."""
    relu = _message(message)
    if x.device.type == "cpu":
        return blocked_gather_message_scatter_demb_plain(
            x, g, emb_fwd, plan_fwd, w_fwd, message)
    if x.device.type != "cuda":
        raise ValueError(f"block_spmm: unsupported device {x.device}")
    _check(x, [(emb_fwd, plan_fwd, w_fwd)], g)
    demb = torch.empty_like(emb_fwd)
    lib = _load()
    err = lib.block_spmm_demb(
        *(_ptr(t) for t in (x, g, emb_fwd, plan_fwd["blk_out"],
                            plan_fwd["blk_in"], plan_fwd["loc_out"],
                            plan_fwd["loc_in"], plan_fwd["mask"], w_fwd,
                            demb)),
        plan_fwd["blk_out"].shape[0], x.shape[1], int(relu), _stream(x))
    _build.check(lib, err, "block_spmm_demb")
    blocked_gather_message_scatter_demb.launches += 1
    return demb


blocked_gather_message_scatter_demb.launches = 0


def blocked_gather_message_scatter_dx(
        x: torch.Tensor, g: torch.Tensor, emb: torch.Tensor,
        plan_bwd: dict, w: Optional[torch.Tensor] = None,
        message: str = "relu_add",
        rows: Optional[SlotOrder] = None) -> torch.Tensor:
    """K8's dx [N, d] for the cotangent g of its forward, over the
    src-major plan. The kernel walks ``rows``, a ``SlotOrder`` of
    ``plan_bwd``, and reads emb [C*EB, d] and w [C*EB] at the slot each
    position names: its own (``SlotOrder(plan_bwd, N)``, made where
    ``rows`` is None: emb and w are the src-major copies, as the JAX
    kernel reads them) or, with the order's ``slot_map`` (``fwd_slot``,
    ``src_slot_order(batch)``), the dst-major plan's: emb_fwd and w_fwd.
    CPU tensors take the plain version; CUDA tensors launch the kernel or
    raise."""
    relu = _message(message)
    if x.device.type == "cpu":
        return blocked_gather_message_scatter_dx_plain(
            x, g, emb, plan_bwd, w, message,
            None if rows is None else rows.slot_map)
    if x.device.type != "cuda":
        raise ValueError(f"block_spmm: unsupported device {x.device}")
    _check(x, [(emb, plan_bwd, w)], g)
    N, d = x.shape
    if rows is None:
        rows = SlotOrder(plan_bwd, N)
    _same_nodes(rows, x, emb.shape[0], "rows")
    dx = torch.empty_like(x)
    slot, minor, major, ptr = rows.get()
    rptr = rows.runs()
    vec, vpl, slices = spmm.bwd_launch(d, _build.align(x, emb, g))  # dx: new
    lib = spmm._load()           # K8-dx runs on K7-bwd's walk
    err = lib.blocked_dx(
        *(_ptr(t) for t in (x, emb, minor, major, slot, ptr, rptr, w, g,
                            dx)),
        N, d, rptr.shape[0] - 1, int(relu), vec, vpl, slices, _stream(x))
    _build.check(lib, err, "blocked_dx")
    blocked_gather_message_scatter_dx.launches += 1
    return dx


blocked_gather_message_scatter_dx.launches = 0


def _load():
    lib = _build.load("block_spmm")
    if lib.block_spmm_demb.argtypes is None:
        lib.block_spmm_demb.argtypes = ([ctypes.c_void_p] * 10
                                        + [ctypes.c_int] * 3
                                        + [ctypes.c_void_p])
        lib.block_spmm_demb.restype = ctypes.c_int
    return lib
