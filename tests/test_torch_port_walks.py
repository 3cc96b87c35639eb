"""The walks of K7's forward (``csrc/spmm.cu:spmm_fwd_kernel``) and K12
(``csrc/scatter_mxu.cu``), emulated on the CPU (``tests/_port_walks.py``)
in the kernels' order of terms, against the port's plain versions and the
JAX Pallas kernels in interpret mode (``ops/pallas/spmm.py:
gather_message_scatter``, ``ops/pallas/scatter_mxu.py:segment_sum_mxu``);
and the per-batch dst order K7's forward walks. The CUDA kernels are held
to the same walks' bits on the card in test_torch_port_cuda.py."""

import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from graphtrans_tpu.ops.pallas import scatter_mxu as jk12  # noqa: E402
from graphtrans_tpu.ops.pallas import spmm as jspmm  # noqa: E402
from graphtrans_tpu_torch.ops.kernels import (  # noqa: E402
    DstOrder, dst_order, segment_sum_mxu_plain, spmm, spmm_plain)
from _heap import release_freed_heap  # noqa: E402,F401
from _port_walks import k12_ends, k12_walk, k7_fwd_walk  # noqa: E402

TOL = 1e-5  # of max(1, max|ref|): f32 sums in another order
k7 = importlib.import_module("graphtrans_tpu_torch.ops.kernels.spmm")
k12 = importlib.import_module("graphtrans_tpu_torch.ops.kernels.scatter_mxu")


def _k7_case(seed=0, N=512, d=128, hub=600, others=1400, tail=30000):
    """dst-sorted edges: ``others`` over rows 0..299 plus a hub (row 100
    with ``hub`` more), masked edges mid-row (every 7th), zero weights (one
    inside row 40, all of row 41), rows 300..N-2 with no edge, and a masked
    padding tail of ``tail`` edges on node N-1."""
    rng = np.random.default_rng(seed)
    live = np.sort(np.concatenate([rng.integers(0, 300, others),
                                   np.full(hub, 100)]))
    E = live.size + tail
    dst = np.concatenate([live, np.full(tail, N - 1)]).astype(np.int32)
    src = np.concatenate([rng.integers(0, 350, live.size),
                          np.full(tail, N - 1)]).astype(np.int32)
    mask = np.arange(E) < live.size
    mask[:live.size:7] = False
    x = rng.standard_normal((N, d)).astype(np.float32)
    x[N - 1] = 0
    emb = rng.standard_normal((E, d)).astype(np.float32)
    w = rng.uniform(0.1, 1.0, E).astype(np.float32)
    w[np.nonzero((dst == 40) & mask)[0][:1]] = 0.0
    w[dst == 41] = 0.0
    return x, emb, src, dst, mask, w


@pytest.mark.parametrize("message", ["relu_add", "add"])
@pytest.mark.parametrize("weighted", [True, False])
def test_k7_forward_walk_matches_plain_and_jax_kernel(message, weighted):
    """The forward's walk over runs of whole destination rows, emulated,
    writes every row once, equals spmm_plain bit for bit (the same order
    of terms and rounded products: masked and weight-0 edges add nothing)
    and the interpret-mode Pallas kernel within 1e-5: a hub of 600 edges,
    masked edges mid-row, zero weights, rows with no live edge (exactly
    0) and a masked tail of 30000 edges that no run walks."""
    x, emb, src, dst, mask, w = _k7_case(seed=1 + weighted)
    w = w if weighted else None
    N, E = x.shape[0], dst.shape[0]
    assert E % 256 == 0
    t = [torch.from_numpy(a) for a in (x, emb, src, dst, mask)]
    tw = torch.from_numpy(w) if weighted else None
    order = DstOrder(t[3], t[4], N)
    got, writes, walked = k7_fwd_walk(x, emb, src, dst, mask, w,
                                      message == "relu_add", order)
    assert (writes == 1).all()
    plain = spmm_plain(*t, tw, message).numpy()
    np.testing.assert_array_equal(got, plain)
    want = np.asarray(jspmm.gather_message_scatter(
        *(jnp.asarray(a) for a in (x, emb, src, dst, mask)), N,
        message=message, edge_weight=None if w is None else jnp.asarray(w),
        interpret=True))
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=TOL * max(1.0, np.abs(want).max()))
    assert not got[300:].any()
    if weighted:
        assert not got[41].any()
    # every live edge is walked once, and no run walks past the last live
    # edge: the masked tail is never walked
    last = np.nonzero(mask)[0][-1]
    assert walked[mask].all() and not walked[last + 1:].any()
    assert order.get()[1][N] == mask.sum()


def test_dst_order_lists_the_live_edges_by_row():
    """Row i of the DstOrder holds exactly the edges into i, at [ptr[i],
    ptr[i+1]) in batch order, and dptr counts the live edges before it;
    masked edges (mid-row and the tail) count in no row. Its runs are
    edge_runs of dptr, made once, keep every row whole and cost the live
    edges only."""
    x, emb, src, dst, mask, w = _k7_case(seed=3)
    N, E = x.shape[0], dst.shape[0]
    order = DstOrder(torch.from_numpy(dst), torch.from_numpy(mask), N)
    ptr, dptr = (a.numpy() for a in order.get())
    assert ptr.dtype == dptr.dtype == np.int32
    assert ptr.shape == dptr.shape == (N + 1,)
    assert ptr[0] == 0 and ptr[N] == E
    for i in range(N):
        assert (dst[ptr[i]:ptr[i + 1]] == i).all()
        assert dptr[i + 1] - dptr[i] == mask[ptr[i]:ptr[i + 1]].sum()
    assert dptr[0] == 0 and dptr[N] == mask.sum()
    rptr = order.runs()
    assert order.runs() is rptr and order.get() is order.get()
    assert torch.equal(rptr, k7.edge_runs(torch.from_numpy(dptr), E))
    rptr = rptr.numpy()
    assert rptr[0] == 0 and rptr[-1] == N and (np.diff(rptr) >= 0).all()
    cost = k7.EDGE_COST * dptr[:N].astype(np.int64) + np.arange(N)
    for r in range(len(rptr) - 1):       # run r: rows whose cost before
        rows = np.arange(rptr[r], rptr[r + 1])   # them lies in its span
        assert ((cost[rows] >= r * k7.RUN_COST)
                & (cost[rows] < (r + 1) * k7.RUN_COST)).all()
    hub = np.searchsorted(rptr, 100, side="right") - 1
    assert dptr[rptr[hub + 1]] - dptr[rptr[hub]] >= 500     # one run, whole
    tail = np.searchsorted(rptr, N - 1, side="right") - 1
    assert dptr[N] - dptr[rptr[tail]] == 0   # the masked tail's run: no cost


def test_dst_order_is_made_once_per_batch():
    """``dst_order(batch)`` keeps one DstOrder on the batch (every layer
    shares it); a batch copied to a device gets its own; a call of the
    wrapper without it, or with the order of other edges, behaves as the
    plain version on the CPU and raises on a count mismatch."""
    from graphtrans_tpu_torch.data.batch import collate

    rng = np.random.default_rng(8)
    graphs = [dict(x=rng.integers(0, 5, (n, 2)),
                   edge_index=rng.integers(0, n, (2, 2 * n)))
              for n in (5, 9, 3)]
    host = collate(graphs, 4, 32, 64)
    batch = host.to("cpu")
    order = dst_order(batch)
    assert dst_order(batch) is order and order.num_nodes == 32
    assert order.dst is batch.edge_dst and order.emask is batch.edge_mask
    assert dst_order(host.to("cpu")) is not order
    ptr, dptr = order.get()
    live = batch.edge_mask.numpy()
    assert dptr[-1].item() == live.sum()
    np.testing.assert_array_equal(
        ptr.numpy(), np.searchsorted(batch.edge_dst.numpy(), np.arange(33)))


def _k12_case(seed, N, E, d=128, long_row=None):
    """Sorted dsts with out-of-range edges at both ends (-5, -1; N, N+3),
    rows 40..99 and the last 50 rows without edges, a row of 600 edges
    (row 7) and, where given, one of ``long_row`` edges (row 200)."""
    rng = np.random.default_rng(seed)
    extra = [np.full(600, 7)] + ([np.full(long_row, 200)] if long_row else [])
    fixed = 600 + (long_row or 0) + 40
    rest = rng.integers(0, N - 50 - 60, E - fixed)
    rest = np.where(rest >= 40, rest + 60, rest)     # skip rows 40..99
    dst = np.sort(np.concatenate([rest, *extra, np.full(10, -5),
                                  np.full(10, -1), np.full(10, N),
                                  np.full(10, N + 3)])).astype(np.int32)
    msg = rng.standard_normal((E, d)).astype(np.float32)
    return msg, dst


@pytest.mark.parametrize("N,E,long_row", [(512, 2048, None),
                                          (1024, 32768, 30000)])
def test_k12_walk_matches_jax_kernel(N, E, long_row):
    """K12's merge-path walk, emulated: every row written once (zeros for
    rows without edges), out-of-range edges counted nowhere, rows longer
    than 32 edges cut between warps and joined in warp order; within 1e-5
    of max(1, max|ref|) of the interpret-mode Pallas kernel and of the
    plain version."""
    msg, dst = _k12_case(N, N, E, long_row=long_row)
    span = k12.SPAN
    got, writes, cut = k12_walk(msg, dst, N, span)
    assert (writes == 1).all()
    want = np.asarray(jk12.segment_sum_mxu(jnp.asarray(msg),
                                           jnp.asarray(dst), N,
                                           interpret=True))
    for ref in (want, segment_sum_mxu_plain(torch.from_numpy(msg),
                                            torch.from_numpy(dst),
                                            N).numpy()):
        np.testing.assert_allclose(got, ref, rtol=0,
                                   atol=TOL * max(1.0, np.abs(ref).max()))
    assert not got[40:100].any() and not got[N - 50:].any()
    assert 7 in cut and (long_row is None or 200 in cut)
    counts = np.bincount(dst[(dst >= 0) & (dst < N)], minlength=N)
    assert (counts[cut] > 32).all()      # short rows are never cut


@pytest.mark.parametrize("span", [64, 256])
def test_k12_ends_cut_the_merge_path_in_order(span):
    """The warps' ends: monotone, from (0, 0) to (N, E), each warp about
    ``span`` items (at most 33 more or fewer where an end moved past a
    row's end), and an end cuts a row only where the row goes on for more
    than 32 edges after it."""
    N, E = 512, 2048
    _, dst = _k12_case(5, N, E)
    ends = k12_ends(dst, N, span)
    assert ends[0] == (0, 0, False) and ends[-1] == (N, E, False)
    row = np.where(dst < 0, 0, np.minimum(dst, N))
    for (i0, j0, _), (i1, j1, _) in zip(ends, ends[1:]):
        assert i0 <= i1 and j0 <= j1
        assert (i1 + j1) - (i0 + j0) <= span + 33
    for i, j, cut in ends:
        if cut:
            assert (row[j:j + 32] == i).all() and row[j - 1] == i
