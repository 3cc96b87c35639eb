"""Host-side block-pair plans for the blocked-CSR aggregation (kernel K8),
copied from ``graphtrans_tpu/ops/block_plan.py`` (``NB``, ``EB``,
``chunk_capacity``, ``build_block_plan``, ``permute_edge_data``; the
scatter-free and ELL plans there have no kernel and stay behind), the
per-model switch that turns the route on, ``slot_rows``, the node rows
of a plan's slots on the device, and ``slot_map``, which matches the slots
of the two plans.

The node axis is cut into blocks of ``NB`` rows. A plan groups the valid
edges by (major block, minor block) pairs and cuts each pair's run into
chunks of ``EB`` slots; every major block gets at least one chunk. Two
plans per batch: dst-major (forward and d_emb) and src-major (dx).

Plan arrays (C = chunk capacity):
  blk_out [C] i32      major block of the chunk (grouped ascending)
  blk_in  [C] i32      minor block of the chunk
  is_first [C] i32     1 on the first chunk of each major block
  loc_out [C, EB] i32  row of the edge's major endpoint within its block
  loc_in  [C, EB] i32  row of its minor endpoint within its block
  mask    [C, EB] f32  1.0 on a real edge slot
  perm    [C*EB] i64   edge index per slot (-1 pad), host only: it puts
                       per-edge data in chunk order (``permute_edge_data``)
The port's ``collate`` keeps one more array on the src-major plan:
  fwd_slot [C*EB] i32  the dst-major plan's slot of the same edge (-1 pad;
                       ``slot_map``), K8-dx's way to the dst-major emb copy
Pad chunks past the last real one revisit the last major block with
``is_first`` 0 and an all-zero mask.

``build_block_plan`` here is vectorised; its arrays equal the JAX loop's
exactly (``tests/test_torch_port_blocked.py``).
"""

from __future__ import annotations

import numpy as np
from torch import nn

NB = 128   # node rows per block
EB = 512   # edge slots per chunk

MODES = ("off", "on", "auto")


def set_block_spmm(model: nn.Module, mode: str) -> nn.Module:
    """Route the flat GCN aggregation of ``model`` through K8 when a batch
    carries block plans ("on", or "auto", which the port reads as on: it
    always takes the JAX package's TPU branch) or through K7 ("off", the
    default), as the JAX package's process-wide ``set_block_spmm`` does,
    but for this model alone."""
    if mode not in MODES:
        raise ValueError(f"block_spmm mode {mode!r} is not one of {MODES}")
    for m in model.modules():
        if hasattr(m, "block_spmm"):
            m.block_spmm = mode
    return model


def slot_rows(plan):
    """(major row, minor row) of every slot of a plan on the device, two
    [C*EB] int64 tensors (pad slots read their chunk's rows)."""
    maj = plan["blk_out"].long()[:, None] * NB + plan["loc_out"]
    mnr = plan["blk_in"].long()[:, None] * NB + plan["loc_in"]
    return maj.reshape(-1), mnr.reshape(-1)


def chunk_capacity(e_cap: int, n_cap: int, pair_slack: int = 4) -> int:
    """Static chunk count for any batch under (e_cap, n_cap): one chunk per
    EB edges, one per node block, plus slack for partial chunks at pair
    boundaries."""
    nb = -(-n_cap // NB)
    return -(-e_cap // EB) + nb * pair_slack


def build_block_plan(src, dst, emask, n_slots: int, chunks_cap: int,
                     major: str = "dst"):
    """One plan (see the module docstring) as a dict of numpy arrays, or
    None when the batch needs more than ``chunks_cap`` chunks (the batch
    then takes the flat route, K7)."""
    if n_slots % NB:
        raise ValueError(f"n_slots {n_slots} is not a multiple of {NB}")
    nb = n_slots // NB
    src, dst = np.asarray(src), np.asarray(dst)
    e_idx = np.nonzero(np.asarray(emask))[0]
    ma = (dst if major == "dst" else src)[e_idx]
    mi = (src if major == "dst" else dst)[e_idx]
    bo, bi = ma // NB, mi // NB
    order = np.lexsort((bi, bo))
    e_idx, ma, mi, bo, bi = (a[order] for a in (e_idx, ma, mi, bo, bi))

    # a chunk starts at each new (bo, bi) pair and every EB edges within one
    E = len(e_idx)
    pair_key = bo.astype(np.int64) * nb + bi
    new_pair = np.ones(E, bool)
    new_pair[1:] = pair_key[1:] != pair_key[:-1]
    run_start = np.flatnonzero(new_pair)
    within = np.arange(E) - run_start[np.cumsum(new_pair) - 1]
    starts = np.flatnonzero(within % EB == 0)
    # zero-init chunks for the major blocks no edge reaches, then a stable
    # sort by major block (the JAX package's list.sort)
    bare = np.setdiff1d(np.arange(nb), bo[starts])
    co = np.concatenate([bo[starts], bare])
    ci = np.concatenate([bi[starts], np.zeros(len(bare), bi.dtype)])
    sorted_idx = np.argsort(co, kind="stable")
    n_chunks = len(co)
    C = chunks_cap
    if n_chunks > C:
        return None

    blk_out = np.zeros(C, np.int32)
    blk_in = np.zeros(C, np.int32)
    is_first = np.zeros(C, np.int32)
    loc_out = np.zeros((C, EB), np.int32)
    loc_in = np.zeros((C, EB), np.int32)
    mask = np.zeros((C, EB), np.float32)
    perm = np.full(C * EB, -1, np.int64)
    blk_out[:n_chunks] = co[sorted_idx]
    blk_in[:n_chunks] = ci[sorted_idx]
    is_first[:n_chunks] = np.diff(blk_out[:n_chunks], prepend=-1) != 0
    # each edge's chunk (its position after the sort) and slot within it
    place = np.empty(n_chunks, np.int64)
    place[sorted_idx] = np.arange(n_chunks)
    chunk = np.cumsum(within % EB == 0) - 1
    c = place[chunk]
    slot = np.arange(E) - starts[chunk]
    loc_out[c, slot] = ma - bo * NB
    loc_in[c, slot] = mi - bi * NB
    mask[c, slot] = 1.0
    perm[c * EB + slot] = e_idx
    if n_chunks < C:
        blk_out[n_chunks:] = blk_out[n_chunks - 1]
        blk_in[n_chunks:] = blk_in[n_chunks - 1]
    return {"blk_out": blk_out, "blk_in": blk_in, "is_first": is_first,
            "loc_out": loc_out, "loc_in": loc_in, "mask": mask, "perm": perm}


def slot_map(perm_from, perm_to):
    """For each slot of one plan (``perm_from``, its slot -> edge map), the
    slot of another plan of the same edges (``perm_to``) that holds the
    same edge: int32 [C*EB], -1 on pad slots. ``collate`` keeps the
    src-major plan's as its ``fwd_slot``, through which K8-dx reads the
    dst-major plan's emb and weight rows."""
    perm_from, perm_to = np.asarray(perm_from), np.asarray(perm_to)
    size = int(max(perm_from.max(initial=-1), perm_to.max(initial=-1))) + 1
    at = np.full(size, -1, np.int64)
    real = perm_to >= 0
    at[perm_to[real]] = np.flatnonzero(real)
    out = np.full(perm_from.shape[0], -1, np.int32)
    real = perm_from >= 0
    out[real] = at[perm_from[real]]
    return out


def permute_edge_data(arr, perm, fill=0):
    """Per-edge array [E, ...] -> chunk-ordered [C*EB, ...] by a plan's
    ``perm`` (``fill`` on pad slots)."""
    arr = np.asarray(arr)
    out = np.full((len(perm),) + arr.shape[1:], fill, arr.dtype)
    valid = perm >= 0
    out[valid] = arr[perm[valid]]
    return out
