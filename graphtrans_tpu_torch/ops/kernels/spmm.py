"""K7: the flat-layout message-passing sum over dst-sorted edges.

Computes

    out[i] = sum_{e: dst[e] = i} w[e] * msg(x[src[e]], emb[e])

with ``msg = relu(x + emb)`` (``relu_add``, GIN/GCN) or ``x + emb``
(``add``), ``w = edge_mask * edge_weight`` (the mask folded into the weight,
so padded edges add nothing), x ``[N, d]`` and emb ``[E, d]`` float32, and
src/dst ``[E]`` int32 with dst sorted ascending (``collate`` sorts the flat
edges by destination and puts padding edges at the tail, pointing at node
N-1). A node with no edge gets a zero row.

Replaces ``graphtrans_tpu/ops/pallas/spmm.py:gather_message_scatter`` (the
opt-in Pallas route of ``ops/scatter.py``; the JAX package has no backward
for it). The TPU kernel keeps x resident in VMEM, walks aligned 256-edge
tiles per 256-row node block and does the scatter as a one-hot MXU matmul;
all of that is for the TPU. The CSR row pointer is built on the device with
``torch.searchsorted(dst, arange(N+1))``, as the TPU kernel builds its block
pointers, so no value comes back to the host.

What bounds it on the H100: memory. Per valid edge it reads a row of x
(through the src gather) and a row of emb and does 4 flops a channel, then
writes N rows once: at the 512-graph code2 shape (d=300) about 0.4 GB and
0.2 GFLOP. Design (``csrc/spmm.cu``): one warp per destination row walks
its edge range in order, lanes over channels, accumulators in registers;
each output row has one writer, so there are no atomics and the sum has a
fixed order. A lane loads the src and weight of 8 edges at once and edges
of weight 0 (the padding tail) are skipped 32 at a time by a ballot, so the
padding node's long edge list (some 25k edges at 512 graphs) costs a few
dozen load steps.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import _build

MESSAGES = ("relu_add", "add")
SLICE_BACKWARD = ("K7 has no backward kernel yet: gradients through the "
                  "flat aggregation arrive with slice 4 (code2 training)")


def _folded_weight(emask: torch.Tensor,
                edge_weight: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The per-edge weight the kernel reads: the mask as 0/1, times
    ``edge_weight`` where given (``spmm.py:120-123`` of the JAX package)."""
    w = emask.to(torch.float32)
    return w if edge_weight is None else w * edge_weight.to(torch.float32)


def spmm_plain(x, emb, src, dst, emask, edge_weight=None,
               message: str = "relu_add") -> torch.Tensor:
    """Plain PyTorch version of K7: same arguments, same result."""
    m = x.index_select(0, src.long()) + emb
    if message == "relu_add":
        m = torch.relu(m)
    elif message != "add":
        raise ValueError(f"spmm: message {message!r} not in {MESSAGES}")
    m = m * _folded_weight(emask, edge_weight)[:, None]
    return torch.zeros_like(x).index_add_(0, dst.long(), m)


def _check(x, emb, src, dst, emask, edge_weight, message):
    N, d = x.shape
    E = src.shape[0]
    want = [(x, torch.float32, (N, d)), (emb, torch.float32, (E, d)),
            (src, torch.int32, (E,)), (dst, torch.int32, (E,)),
            (emask, torch.bool, (E,))]
    if edge_weight is not None:
        want.append((edge_weight, torch.float32, (E,)))
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


def spmm(x: torch.Tensor, emb: torch.Tensor, src: torch.Tensor,
         dst: torch.Tensor, emask: torch.Tensor,
         edge_weight: Optional[torch.Tensor] = None,
         message: str = "relu_add") -> torch.Tensor:
    """K7 forward. CPU tensors take ``spmm_plain``; CUDA tensors launch the
    kernel or raise. Every edge must hold src and dst in ``[0, N)`` and dst
    must be sorted. The kernel has no backward yet: a call on CUDA tensors
    that would need a gradient raises NotImplementedError."""
    if x.device.type == "cpu":
        return spmm_plain(x, emb, src, dst, emask, edge_weight, message)
    if x.device.type != "cuda":
        raise ValueError(f"spmm: unsupported device {x.device}")
    _check(x, emb, src, dst, emask, edge_weight, message)
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (x, emb, edge_weight)):
        raise NotImplementedError(SLICE_BACKWARD)
    N, d = x.shape
    out = torch.empty_like(x)
    if out.numel() == 0:
        return out
    ptr = torch.searchsorted(
        dst, torch.arange(N + 1, dtype=torch.int32, device=x.device),
        out_int32=True)
    w = _folded_weight(emask, edge_weight)
    lib = _load()
    err = lib.spmm_fwd(
        ctypes.c_void_p(x.data_ptr()), ctypes.c_void_p(emb.data_ptr()),
        ctypes.c_void_p(src.data_ptr()), ctypes.c_void_p(ptr.data_ptr()),
        ctypes.c_void_p(w.data_ptr()), ctypes.c_void_p(out.data_ptr()), N, d,
        int(message == "relu_add"),
        ctypes.c_void_p(torch.cuda.current_stream(x.device).cuda_stream))
    _build.check(lib, err, "spmm_fwd")
    spmm.launches += 1
    return out


spmm.launches = 0


def _load():
    lib = _build.load("spmm")
    if lib.spmm_fwd.argtypes is None:
        lib.spmm_fwd.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 3
                                 + [ctypes.c_void_p])
        lib.spmm_fwd.restype = ctypes.c_int
    return lib
