"""K12: the segment sum of precomputed edge messages onto their dst nodes.

    out[i] = sum_{e: edge_dst[e] = i} msg[e]     (f32 [N, d])

with ``edge_dst`` sorted ascending; only edges with ``0 <= dst < N``
count. The JAX contract holds: the result is None when ``d % 128``,
``N % 256`` or ``E % 256`` is not 0 (the caller takes another route), and
there is no gradient (a CUDA call whose msg requires one raises).

Replaces ``graphtrans_tpu/ops/pallas/scatter_mxu.py:segment_sum_mxu``, a
standalone op of the JAX package (no model path calls it; its test does).
The TPU kernel streams aligned 256-edge tiles of msg per 256-row node
block and adds each tile as a one-hot MXU product; both are TPU idioms.

What bounds it on the H100: memory, msg read once and out written once
(at [196608, 128] f32, 134 MB). Design (``csrc/scatter_mxu.cu``), one
launch with no PyTorch op before it: the wrapper only allocates ``out``
and a scratch of (2 d + 2) floats a warp with ``torch.empty`` (an int32
dst is taken as it is). The kernel
cuts the work as a merge path over the edges and the N row ends (an edge
and a row each one item, SPAN items a warp), so a row without edges costs
a zero row's write and the padding node's long row (24846 edges at the
512-graph code2 batch, 3.29 ms when one warp walked it alone) spreads over
some two hundred warps. A warp finds its ends by a search over dst, moves
an end that cuts a row to the row's end when that lies within 32 edges,
and sums its rows from 0 in edge order with 16-byte loads, 2-8 edges'
rows in flight: a row inside one warp gets the sequential sum's bits. A row cut
between warps leaves one part a warp; the block that finishes last (a
ticket after ``__threadfence``) sums each such row's parts in warp order,
by one warp, or, past 32 parts (the padding node's row), by the whole
block as 8 in-order range sums (0.0628 ms against 0.0732 with one warp
for every row at the 512-graph batch, PERF.md §6). The ticket is a counter of the caller's stream
(``_ticket``: zeroed at the stream's first call, and set back to 0 by the
kernel), so calls on two streams at once count apart. One writer per
output row, a fixed order of terms, no atomics on out: two calls give the
same bits.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import _build

NODE_BLOCK = 256   # the JAX kernel's tiles, which set the shape contract
EDGE_TILE = 256
SPAN = 128         # merge-path items (edges and row ends) a warp, as the
                   # kernel's (csrc/scatter_mxu.cu)


def _refused(msg: torch.Tensor, num_nodes: int) -> bool:
    E, d = msg.shape
    return d % 128 != 0 or num_nodes % NODE_BLOCK != 0 or E % EDGE_TILE != 0


def segment_sum_mxu_plain(msg: torch.Tensor, edge_dst: torch.Tensor,
                          num_nodes: int) -> Optional[torch.Tensor]:
    """Plain PyTorch version of K12: ``index_add_`` of the edges whose dst
    lies in [0, N), with the same None contract."""
    if _refused(msg, num_nodes):
        return None
    dst = edge_dst.long()
    keep = (dst >= 0) & (dst < num_nodes)
    out = torch.zeros(num_nodes, msg.shape[1], dtype=torch.float32,
                      device=msg.device)
    return out.index_add_(0, dst[keep], msg.to(torch.float32)[keep])


def segment_sum_mxu(msg: torch.Tensor, edge_dst: torch.Tensor,
                    num_nodes: int) -> Optional[torch.Tensor]:
    """K12. None on the shapes the JAX function refuses; else CPU tensors
    take the plain version and CUDA tensors launch the kernel or raise.
    ``edge_dst`` must be sorted ascending."""
    if _refused(msg, num_nodes):
        return None
    if msg.device.type == "cpu":
        return segment_sum_mxu_plain(msg, edge_dst, num_nodes)
    if msg.device.type != "cuda":
        raise ValueError(f"segment_sum_mxu: unsupported device {msg.device}")
    if torch.is_grad_enabled() and msg.requires_grad:
        raise ValueError("segment_sum_mxu: msg requires a gradient, and K12 "
                         "has none (as the JAX kernel): pass msg.detach()")
    E, d = msg.shape
    if (edge_dst.device != msg.device or tuple(edge_dst.shape) != (E,)
            or edge_dst.dtype not in (torch.int32, torch.int64)):
        raise ValueError(f"segment_sum_mxu: edge_dst must be int [{E}] on "
                         f"{msg.device}")
    if d > 512:
        raise ValueError(f"segment_sum_mxu: d {d} > 512")
    msg = msg.to(torch.float32).contiguous()
    if msg.data_ptr() % 16:              # float4 loads
        msg = msg.clone()
    dst = edge_dst.to(torch.int32).contiguous()
    N = num_nodes
    out = torch.empty(N, d, dtype=torch.float32, device=msg.device)
    if N == 0:
        return out
    lib = _load()
    nwarps = -(-(N + E) // SPAN)
    scratch = torch.empty(nwarps * (2 * d + 2), dtype=torch.float32,
                          device=msg.device)
    stream = torch.cuda.current_stream(msg.device).cuda_stream
    err = lib.segment_sum_mxu(
        msg.data_ptr(), dst.data_ptr(), out.data_ptr(), scratch.data_ptr(),
        _ticket(msg.device, stream).data_ptr(), N, E, d, stream)
    _build.check(lib, err, "segment_sum_mxu")
    segment_sum_mxu.launches += 1
    return out


segment_sum_mxu.launches = 0

_tickets = {}   # (device, stream): the kernel's ticket counter


def _ticket(device: torch.device, stream: int) -> torch.Tensor:
    """K12's ticket counter for calls on ``stream``: made zero at the
    stream's first call and kept (the kernel's last block sets it back to
    0), so calls on two streams at once count apart and every later call
    launches nothing before the kernel."""
    key = (device, stream)
    if key not in _tickets:
        _tickets[key] = torch.zeros(1, dtype=torch.int32, device=device)
    return _tickets[key]


def _load():
    lib = _build.load("scatter_mxu")
    if lib.segment_sum_mxu.argtypes is None:
        lib.segment_sum_mxu.argtypes = (
            [ctypes.c_void_p] * 5 + [ctypes.c_int, ctypes.c_long,
                                     ctypes.c_int, ctypes.c_void_p])
        lib.segment_sum_mxu.restype = ctypes.c_int
        lib.segment_sum_span.restype = ctypes.c_int
        if lib.segment_sum_span() != SPAN:
            raise RuntimeError("segment_sum_mxu: csrc/scatter_mxu.cu's SPAN "
                               f"is {lib.segment_sum_span()}, not {SPAN}")
    return lib
