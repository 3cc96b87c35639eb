"""The walks of CUDA kernels of the port, K7's forward
(``csrc/spmm.cu:spmm_fwd_kernel``), K8's forward (``blocked_fwd_kernel``,
the same body over a SlotOrder), K8-dx (``blocked_dx_kernel``, K7-bwd's
walk over a SlotOrder of the src-major plan), K12
(``csrc/scatter_mxu.cu``), K6 and K6-bwd (``csrc/dense_agg.cu:
dense_agg_fwd_kernel``, ``dense_agg_bwd_kernel``), emulated in numpy
float32 with the kernels' order of terms, so that the CPU tests can hold
each walk against the JAX package and the card tests can hold each kernel
to the walk's bits. Imports numpy only (the card's machine has no JAX)."""

import numpy as np

F32 = np.float32
JOIN_ONE_WARP = 32  # K12: a cut row of up to this many later pieces is
JOIN_WARPS = 8      # summed by one warp, a longer one in 8 ranges


def k7_fwd_walk(x, emb, src, dst, mask, w, relu, order):
    """K7's forward as the kernel runs it: each run of ``order.runs()``
    walked by one warp over the DstOrder ``order``, from the run's first
    edge in batch order, 32 edges a step, up to its last live edge; every
    row summed from 0 in edge order, masked edges and edges of weight 0
    skipped, each product rounded before its add. ``w`` is the edge weight
    (None: 1). Returns the output, how many times each row was written and
    which edges a warp walked."""
    ptr, dptr = (t.numpy() for t in order.get())
    rptr = order.runs().numpy()
    N, d = x.shape
    out = np.full((N, d), np.nan, F32)
    writes = np.zeros(N, int)
    walked = np.zeros(dst.shape[0], bool)
    for r in range(len(rptr) - 1):
        r_lo, r_hi = rptr[r], rptr[r + 1]
        row, acc = r_lo, np.zeros(d, F32)

        def write_to(to):
            nonlocal row, acc
            while row < to:
                out[row], acc = acc, np.zeros(d, F32)
                writes[row] += 1
                row += 1

        e0, e_hi, left = ptr[r_lo], ptr[r_hi], dptr[r_hi] - dptr[r_lo]
        while r_lo < r_hi and e0 < e_hi and left > 0:
            live = [e for e in range(e0, min(e0 + 32, e_hi)) if mask[e]]
            if live:
                left -= len(live)
                walked[e0:live[-1] + 1] = True
            for e in live:
                we = F32(1.0) if w is None else F32(w[e])
                if we == 0:
                    continue
                write_to(dst[e])
                m = x[src[e]] + emb[e]
                if relu:
                    m = np.maximum(m, F32(0))
                acc = acc + m * we
            e0 += 32
        write_to(r_hi)
    return out, writes, walked


class _Positions:
    """A SlotOrder seen as K7's DstOrder: every position live, so the live
    positions before a row are its row pointer."""

    def __init__(self, order):
        self.order = order

    def get(self):
        ptr = self.order.get()[3]
        return ptr, ptr

    def runs(self):
        return self.order.runs()


def k8_fwd_walk(x, emb, w, relu, order):
    """K8's forward as the kernel runs it: K7's forward walk over the
    positions of the SlotOrder ``order``, position k the edge src[k] ->
    dst[k] with the emb row and weight of its slot (``w`` [C*EB] or
    None). Returns what ``k7_fwd_walk`` returns."""
    slot, src, dst, _ = (t.numpy() for t in order.get())
    return k7_fwd_walk(x, emb[slot], src, dst, np.ones(slot.shape[0], bool),
                       None if w is None else w[slot], relu,
                       _Positions(order))


def k8_dx_walk(x, g, emb, w, relu, order):
    """K8-dx as the kernel runs it: each run of ``order.runs()`` walked by
    one warp over the positions of ``order`` (a SlotOrder of the src-major
    plan), every row summed from 0 in slot order, position k adding
    g[src[k]] * w[slot[k]] (rounded; 0 where x[dst[k]] + emb[slot[k]] <= 0
    under relu), where src and dst are the order's minor and major rows
    (the edge's dst and src) and ``w`` [*] or None; every row written once,
    zero where no real slot leaves it. Returns dx and how many times each
    row was written."""
    slot, minor, major, ptr = (t.numpy() for t in order.get())
    rptr = order.runs().numpy()
    N, d = x.shape
    dx = np.full((N, d), np.nan, F32)
    writes = np.zeros(N, int)
    for r in range(len(rptr) - 1):
        r_lo, r_hi = rptr[r], rptr[r + 1]
        row, acc = r_lo, np.zeros(d, F32)
        for k in range(ptr[r_lo], ptr[r_hi]):
            while row < major[k]:
                dx[row], acc = acc, np.zeros(d, F32)
                writes[row] += 1
                row += 1
            s = slot[k]
            m = g[minor[k]] * (F32(1) if w is None else F32(w[s]))
            if relu:
                m = np.where(x[major[k]] + emb[s] > 0, m, F32(0))
            acc = acc + m
        while row < r_hi:
            dx[row], acc = acc, np.zeros(d, F32)
            writes[row] += 1
            row += 1
    return dx, writes


def k6_fwd_walk(x, src, dst, emask, emb, w, relu):
    """K6's forward as the kernel runs it: per graph the valid slots sorted
    by (dst, slot), each row's m = x[src] (+ emb, where ``emb`` is not
    None; relu under relu) times w (rounded) summed from 0 in that order,
    every row written once (zero where no valid edge reaches it). ``w``
    [G, Em] or None. Returns out [G, Sm, d] and how many times each row
    was written."""
    G, Sm, d = x.shape
    out = np.full((G, Sm, d), np.nan, F32)
    writes = np.zeros((G, Sm), int)
    for g in range(G):
        valid = np.nonzero(emask[g])[0]
        row, acc = 0, np.zeros(d, F32)
        for e in sorted(valid, key=lambda e: (dst[g, e], e)):
            while row < dst[g, e]:
                out[g, row], acc = acc, np.zeros(d, F32)
                writes[g, row] += 1
                row += 1
            m = x[g, src[g, e]]
            if emb is not None:
                m = m + emb[g, e]
            if relu:
                m = np.maximum(m, F32(0))
            acc = acc + m * (F32(1) if w is None else F32(w[g, e]))
        while row < Sm:
            out[g, row], acc = acc, np.zeros(d, F32)
            writes[g, row] += 1
            row += 1
    return out, writes


def k6_bwd_walk(x, src, dst, emask, emb, w, gout, relu):
    """K6-bwd's dx as the kernel runs it: per graph the valid slots sorted
    by (src, slot), each row's dmsg = gout[dst] * w (rounded; 0 where x[src]
    + emb <= 0 under relu) summed from 0 in that order, every row written
    once (zero where no valid edge leaves it). ``w`` [G, Em] or None,
    ``emb`` [G, Em, d] or None (zero embeddings). Returns dx [G, Sm, d]
    and how many times each row was written."""
    G, Sm, d = x.shape
    dx = np.full((G, Sm, d), np.nan, F32)
    writes = np.zeros((G, Sm), int)
    for g in range(G):
        valid = np.nonzero(emask[g])[0]
        row, acc = 0, np.zeros(d, F32)
        for e in sorted(valid, key=lambda e: (src[g, e], e)):
            while row < src[g, e]:
                dx[g, row], acc = acc, np.zeros(d, F32)
                writes[g, row] += 1
                row += 1
            dm = gout[g, dst[g, e]] * (F32(1) if w is None else F32(w[g, e]))
            if relu:
                pre = x[g, row] if emb is None else x[g, row] + emb[g, e]
                dm = np.where(pre > 0, dm, F32(0))
            acc = acc + dm
        while row < Sm:
            dx[g, row], acc = acc, np.zeros(d, F32)
            writes[g, row] += 1
            row += 1
    return dx, writes


def _row_of(dst, N):
    return np.where(dst < 0, 0, np.minimum(dst, N)).astype(np.int64)


def k12_ends(dst, N: int, span: int):
    """K12's warps on the merge path of the edges and the N row ends: for
    each of the ceil((N + E) / span) + 1 boundaries (rows ended, edges
    taken, cuts a row), each moved past the end of a row it cuts when that
    row ends within 32 edges."""
    E = dst.shape[0]
    row = _row_of(dst, N)
    key = np.arange(E) + row
    items = N + E
    ends = []
    for w in range(-(-items // span) + 1):
        k = min(w * span, items)
        j = min(max(int(np.searchsorted(key, k)), max(0, k - N)), min(k, E))
        i = k - j
        cut = i < N and j > 0 and row[j - 1] == i
        if cut:
            for x in range(j, j + 32):
                if x >= E or row[x] != i:
                    i, j, cut = i + 1, x, False
                    break
        ends.append((i, j, cut))
    return ends


def k12_walk(msg, dst, N: int, span: int = 256):
    """K12 as the kernel runs it: each warp sums its rows from 0 in edge
    order and writes every row whose end it holds (zeros without edges);
    the parts of a row cut between warps are summed in warp order,
    tail[o] + head[o+1] + ... Returns the output, how many times each row
    was written and the rows that were cut. A row cut into more than
    JOIN_ONE_WARP later pieces is summed as the kernel's block sums it:
    tail[o] + S_0 + ... + S_7, S_k the k-th of 8 equal ranges in order."""
    E, d = msg.shape
    row = _row_of(dst, N)
    ends = k12_ends(dst, N, span)
    out = np.full((N, d), np.nan, F32)
    writes = np.zeros(N, int)
    head, tail, flags = {}, {}, {}
    for w in range(len(ends) - 1):
        (i0, j0, has_head), (i1, j1, cut1) = ends[w], ends[w + 1]
        acc, cur = np.zeros(d, F32), i0

        def finish_to(r):
            nonlocal acc, cur
            while cur < r:
                if has_head and cur == i0:
                    head[w] = acc
                else:
                    out[cur] = acc
                    writes[cur] += 1
                acc, cur = np.zeros(d, F32), cur + 1

        for e in range(j0, j1):
            finish_to(row[e])
            if 0 <= dst[e] < N:
                acc = acc + msg[e]
        finish_to(i1)
        flags[w] = "head" if has_head else ""
        if cut1:
            if has_head and i0 == i1:
                head[w], flags[w] = acc, "mid"
            else:
                tail[w] = (i1, acc)
    cut_rows = []
    for o, (r, acc) in sorted(tail.items()):
        end = o + 1
        while flags[end] == "mid":
            end += 1
        P = end - o                      # pieces o+1 .. end
        if P <= JOIN_ONE_WARP:
            for j in range(o + 1, end + 1):
                acc = acc + head[j]
        else:                            # the block's split: WARPS ranges
            for k in range(JOIN_WARPS):
                lo = o + 1 + P * k // JOIN_WARPS
                hi = o + 1 + P * (k + 1) // JOIN_WARPS
                if lo < hi:
                    part = head[lo]
                    for j in range(lo + 1, hi):
                        part = part + head[j]
                    acc = acc + part
        out[r] = acc
        writes[r] += 1
        cut_rows.append(r)
    return out, writes, cut_rows
