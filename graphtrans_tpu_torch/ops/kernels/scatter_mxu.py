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
(at [196608, 128] f32, 134 MB). Design (``csrc/scatter_mxu.cu``): the row
pointer comes from ``torch.searchsorted(dst, arange(N + 1))`` on the card
(edges outside [0, N) fall outside every row), and each row's edges are
cut into pieces of 128, numbered by a ``cumsum`` (one piece for a row
without edges). One warp per piece sums its edges in order, lanes over
the channels, 4 edges' loads in flight; then one warp per row sums its
pieces in order. A collated batch's padding node owns tens of thousands
of edges (24846 at the 512-graph code2 batch), which one warp alone walked
in 3.29 ms (NVIDIA H100 80GB HBM3, 700.00 W, ``chip_smoke.py`` phase 13a):
the pieces spread it over 195 warps. One writer per output, a fixed
order, no atomics; the two launches count as one.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import _build

NODE_BLOCK = 256   # the JAX kernel's tiles, which set the shape contract
EDGE_TILE = 256


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
    dst = edge_dst.to(torch.int32).contiguous()
    N = num_nodes
    ptr = torch.searchsorted(
        dst, torch.arange(N + 1, dtype=torch.int32, device=msg.device),
        out_int32=True)
    lib = _load()
    L = lib.segment_sum_piece_len()
    pieces = ((ptr[1:] - ptr[:-1] + L - 1) // L).clamp_(min=1)
    pptr = torch.zeros(N + 1, dtype=torch.int32, device=msg.device)
    pptr[1:] = torch.cumsum(pieces, 0, dtype=torch.int32)
    P = N + -(-E // L)                   # at least pptr[N]
    partial = torch.empty(P, d, dtype=torch.float32, device=msg.device)
    out = torch.empty(N, d, dtype=torch.float32, device=msg.device)
    err = lib.segment_sum_mxu(
        *(ctypes.c_void_p(t.data_ptr()) for t in (msg, ptr, pptr, partial,
                                                  out)),
        N, P, d,
        ctypes.c_void_p(torch.cuda.current_stream(msg.device).cuda_stream))
    _build.check(lib, err, "segment_sum_mxu")
    segment_sum_mxu.launches += 1
    return out


segment_sum_mxu.launches = 0


def _load():
    lib = _build.load("scatter_mxu")
    if lib.segment_sum_mxu.argtypes is None:
        lib.segment_sum_mxu.argtypes = ([ctypes.c_void_p] * 5
                                        + [ctypes.c_int, ctypes.c_long,
                                           ctypes.c_int, ctypes.c_void_p])
        lib.segment_sum_mxu.restype = ctypes.c_int
        lib.segment_sum_piece_len.restype = ctypes.c_int
    return lib
