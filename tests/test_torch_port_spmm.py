"""Kernel K7 (the flat-layout message-passing sum over dst-sorted edges):
the port's plain version against the JAX Pallas kernel
``ops/pallas/spmm.py:gather_message_scatter`` in interpret mode and against
the XLA segment route ``ops/scatter.py:gather_message_scatter``, and its
autograd backward against the XLA route's ``jax.vjp`` (the JAX package has
no backward kernel). The CUDA kernels are held against the plain versions
on the card in test_torch_port_cuda.py."""

import importlib
import re
import types
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from graphtrans_tpu.ops import scatter as jscatter  # noqa: E402
from graphtrans_tpu.ops.pallas import spmm as jspmm  # noqa: E402
from graphtrans_tpu_torch.ops.kernels import (  # noqa: E402
    SrcOrder, spmm, spmm_bwd, spmm_bwd_plain, spmm_plain, src_order)
from graphtrans_tpu_torch.ops.segment import (  # noqa: E402
    out_degree, segment_sum)
from _heap import release_freed_heap  # noqa: E402,F401

TOL = 2e-5  # each row sums a dozen or fewer f32 terms of order 1
k7 = importlib.import_module("graphtrans_tpu_torch.ops.kernels.spmm")
CSRC = Path(__file__).resolve().parents[1] / "graphtrans_tpu_torch" / "csrc"


def _case(N=512, E=512, d=128, seed=0):
    """dst-sorted edges that leave node block 1 (rows 256..511, bar the
    last) without edges, with a masked padding tail pointing at N-1."""
    rng = np.random.default_rng(seed)
    n_valid = 300
    dst = np.sort(rng.integers(0, 200, n_valid)).astype(np.int32)
    src = rng.integers(0, 250, n_valid).astype(np.int32)
    pad = E - n_valid
    dst = np.concatenate([dst, np.full(pad, N - 1, np.int32)])
    src = np.concatenate([src, np.full(pad, N - 1, np.int32)])
    mask = np.arange(E) < n_valid
    x = rng.standard_normal((N, d)).astype(np.float32)
    emb = rng.standard_normal((E, d)).astype(np.float32)
    w = rng.uniform(0.1, 1.0, E).astype(np.float32)
    return x, emb, src, dst, mask, w


@pytest.mark.parametrize("message", ["relu_add", "add"])
@pytest.mark.parametrize("weighted", [False, True])
def test_plain_matches_jax_kernel_and_segment_route(message, weighted):
    x, emb, src, dst, mask, w = _case(seed=1 + weighted)
    w = w if weighted else None
    jargs = [jnp.asarray(a) for a in (x, emb, src, dst, mask)]
    jw = jnp.asarray(w) if weighted else None
    want_k = np.asarray(jspmm.gather_message_scatter(
        *jargs, x.shape[0], message=message, edge_weight=jw, interpret=True))
    want_x = np.asarray(jscatter.gather_message_scatter(
        *jargs, x.shape[0], message=message, edge_weight=jw))
    t = [torch.from_numpy(a) for a in (x, emb, src, dst, mask)]
    tw = torch.from_numpy(w) if weighted else None
    got = spmm_plain(*t, tw, message).numpy()
    np.testing.assert_allclose(got, want_k, atol=TOL, rtol=0)
    np.testing.assert_allclose(got, want_x, atol=TOL, rtol=0)
    assert not got[200:].any()       # nodes with no valid edge: zero rows
    # CPU tensors take the plain version through the wrapper, uncounted
    before = spmm.launches
    np.testing.assert_array_equal(spmm(*t, tw, message).numpy(), got)
    assert spmm.launches == before


def test_segment_ops_match_jax():
    from graphtrans_tpu.ops import segment as jseg

    rng = np.random.default_rng(3)
    data = rng.standard_normal((40, 6)).astype(np.float32)
    ids = rng.integers(0, 9, 40).astype(np.int32)
    mask = rng.random(40) < 0.7
    got = segment_sum(torch.from_numpy(data), torch.from_numpy(ids), 10,
                      torch.from_numpy(mask)).numpy()
    want = np.asarray(jseg.segment_sum(jnp.asarray(data), jnp.asarray(ids),
                                       10, mask=jnp.asarray(mask)))
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    deg = out_degree(torch.from_numpy(ids), 10, torch.from_numpy(mask))
    np.testing.assert_array_equal(deg.numpy(), np.asarray(jseg.out_degree(
        jnp.asarray(ids), 10, jnp.asarray(mask))))


def _gcn_case(seed):
    """``_case`` as a GCN layer sees it: the padding node's row of x and
    the padding edges' emb rows are zero (so every exact relu tie sits on a
    masked edge), and the weight is the GCN norm deg^-1/2[src]
    deg^-1/2[dst] with deg = out-degree + 1."""
    x, emb, src, dst, mask, _ = _case(seed=seed)
    N = x.shape[0]
    x[N - 1] = 0
    emb[~mask] = 0
    deg = np.bincount(src[mask], minlength=N).astype(np.float32) + 1.0
    dis = deg ** -0.5
    return x, emb, src, dst, mask, (dis[src] * dis[dst]).astype(np.float32)


@pytest.mark.parametrize("message", ["relu_add", "add"])
def test_plain_grad_matches_jax_segment_route(message):
    """dx and d_emb by autograd through spmm_plain against ``jax.vjp`` of
    the XLA segment route (Pallas off) that the JAX package trains through.
    jnp.maximum's gradient is 0.5 at an exact tie and torch's relu's is 0:
    the ties here all sit on masked edges, whose terms the mask kills in
    both."""
    import jax

    x, emb, src, dst, mask, w = _gcn_case(seed=5)
    N = x.shape[0]
    ties = (x[src] + emb) == 0
    assert ties[~mask].all() and not ties[mask].any()
    g = np.random.default_rng(6).standard_normal(x.shape).astype(np.float32)
    assert not jscatter.pallas_enabled()
    _, vjp = jax.vjp(lambda a, b: jscatter.gather_message_scatter(
        a, b, jnp.asarray(src), jnp.asarray(dst), jnp.asarray(mask), N,
        message=message, edge_weight=jnp.asarray(w)),
        jnp.asarray(x), jnp.asarray(emb))
    want = [np.asarray(t) for t in vjp(jnp.asarray(g))]
    t = [torch.from_numpy(a) for a in (x, emb, src, dst, mask)]
    got = spmm_bwd_plain(*t, torch.from_numpy(g), torch.from_numpy(w),
                         message)
    for name, a, b in zip(("dx", "d_emb"), got, want):
        np.testing.assert_allclose(a.numpy(), b, rtol=0, err_msg=name,
                                   atol=1e-5 * max(1.0, np.abs(b).max()))
    assert not got[1].numpy()[~mask].any()      # padding edges: exact 0
    # CPU tensors take the plain backward through the wrapper, uncounted
    before = spmm_bwd.launches
    again = spmm_bwd(*t, torch.from_numpy(g), SrcOrder(t[2], t[4], N),
                     torch.from_numpy(w), message)
    assert spmm_bwd.launches == before
    for a, b in zip(again, got):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_src_order_partitions_the_valid_edges():
    """The order K7's backward walks: row s lists exactly the valid edges
    leaving s, in batch order; no masked edge is in any row."""
    _, _, src, _, mask, _ = _case(seed=7)
    N = 512
    mask[3] = False                             # a masked edge mid-list
    perm, sptr = SrcOrder(torch.from_numpy(src), torch.from_numpy(mask),
                          N).get()
    perm, sptr = perm.numpy(), sptr.numpy()
    assert perm.dtype == sptr.dtype == np.int32 and sptr.shape == (N + 1,)
    for s in range(N):
        want = np.nonzero((src == s) & mask)[0]
        np.testing.assert_array_equal(perm[sptr[s]:sptr[s + 1]], want)
    assert sptr[N] == mask.sum()
    assert not mask[perm[sptr[N]:]].any()


def test_src_order_is_made_once_per_batch():
    """``src_order(batch)`` keeps one SrcOrder on the batch (every layer
    and step shares its sort); a batch copied to a device gets its own."""
    from graphtrans_tpu_torch.data.batch import collate

    rng = np.random.default_rng(8)
    graphs = [dict(x=rng.integers(0, 5, (n, 2)),
                   edge_index=rng.integers(0, n, (2, 2 * n)))
              for n in (5, 9, 3)]
    host = collate(graphs, 4, 32, 64)
    batch = host.to("cpu")
    order = src_order(batch)
    assert src_order(batch) is order and order.num_nodes == 32
    assert order.src is batch.edge_src and order.emask is batch.edge_mask
    assert src_order(host.to("cpu")) is not order


# ---- K7-bwd's runs and walk (csrc/spmm.cu), on the CPU --------------------


def _hub_case(d=8, seed=11):
    """_case's edges plus a hub (source row 3 with 600 valid edges), a
    zero weight inside a row and a masked edge mid-list; rows 250..N-2
    have no edge leaving them."""
    x, emb, src, dst, mask, w = _case(N=512, E=1400, d=d, seed=seed)
    rng = np.random.default_rng(seed)
    src[300:900] = 3
    dst[:900] = np.sort(rng.integers(0, 200, 900))
    mask[:900] = True
    w[:900] = rng.uniform(0.1, 1.0, 900)
    w[src == 5] = 0.0                          # a row of zero weights
    w[np.nonzero(src == 7)[0][:1]] = 0.0       # one inside a row
    mask[17] = False
    return x, emb, src, dst, mask, w


@pytest.mark.parametrize("run_cost", [1, 7, k7.RUN_COST, 10**6])
def test_edge_runs_cut_the_rows_whole(run_cost):
    """The runs partition the rows [0, N) in order, and run r takes the
    rows whose cost before them (EDGE_COST per edge, 1 per row) lies in
    [r, r+1) * run_cost: no row is split, and a run is longer than
    run_cost only by its last row. The hub's run takes all its edges and
    leaves the runs its cost spans empty."""
    _, _, src, _, mask, _ = _hub_case()
    N = 512
    perm, sptr = SrcOrder(torch.from_numpy(src), torch.from_numpy(mask),
                          N).get()
    rptr = k7._edge_runs(sptr, src.shape[0], run_cost).numpy()
    sp = sptr.numpy().astype(np.int64)
    assert rptr.dtype == np.int32 and rptr[0] == 0 and rptr[-1] == N
    assert (np.diff(rptr) >= 0).all()
    cost = k7.EDGE_COST * sp[:N] + np.arange(N)
    for r in range(len(rptr) - 1):
        rows = np.arange(rptr[r], rptr[r + 1])
        assert ((cost[rows] >= r * run_cost)
                & (cost[rows] < (r + 1) * run_cost)).all()
    if run_cost == k7.RUN_COST:
        assert (k7.edge_runs(sptr, src.shape[0]).numpy() == rptr).all()
        hub = np.searchsorted(rptr, 3, side="right") - 1
        assert sp[rptr[hub + 1]] - sp[rptr[hub]] >= 600
        assert (np.diff(rptr) == 0).sum() >= 600 * k7.EDGE_COST // run_cost - 1


def test_src_order_runs_are_edge_runs_made_once():
    """SrcOrder's runs are edge_runs of its row pointer, made once."""
    _, _, src, _, mask, _ = _hub_case()
    t = torch.from_numpy
    order = SrcOrder(t(src), t(mask), 512)
    sptr = order.get()[1]
    assert torch.equal(order.runs(), k7.edge_runs(sptr, src.shape[0]))
    assert order.runs() is order.runs()


@pytest.mark.parametrize("nodes,edges", [(511, 1400), (513, 1400),
                                         (512, 1399)])
def test_bwd_refuses_an_order_of_other_edges(nodes, edges):
    """spmm_bwd raises where ``order`` was made for another node or edge
    count than the call's (the kernel would leave dx rows unwritten)."""
    x, emb, src, dst, mask, w = (torch.from_numpy(a) for a in _hub_case())
    g = torch.ones_like(x)
    order = SrcOrder(src[:edges], mask[:edges], nodes)
    with pytest.raises(ValueError, match="order is of"):
        spmm_bwd(x, emb, src, dst, mask, g, order, w)


def _emulate_bwd(x, emb, src, dst, mask, w, g, relu, order):
    """K7-bwd as csrc/spmm.cu runs it, in float32: each run walked by one
    warp over perm, writing an edge's d_emb row where its weight is not 0
    and each row's dx once (its sum in perm order, zero without edges);
    the slot warps write the zero d_emb rows of weight-0 edges. Returns dx,
    d_emb and how many times each row of them was written."""
    perm, sptr = (t.numpy() for t in order.get())
    rptr = order.runs().numpy()
    N, d = x.shape
    E = emb.shape[0]
    dx, demb = np.full((N, d), np.nan, np.float32), np.full((E, d), np.nan,
                                                           np.float32)
    nx, ne = np.zeros(N, int), np.zeros(E, int)
    for r in range(len(rptr) - 1):
        row, acc = rptr[r], np.zeros(d, np.float32)
        for k in list(range(sptr[rptr[r]], sptr[rptr[r + 1]])) + [None]:
            s = rptr[r + 1] if k is None else src[perm[k]]
            while row < s:
                dx[row], acc = acc, np.zeros(d, np.float32)
                nx[row] += 1
                row += 1
            if k is None or w[perm[k]] == 0:
                continue
            e = perm[k]
            gate = g[dst[e]] * w[e]
            if relu:
                gate = np.where(x[s] + emb[e] > 0, gate, np.float32(0))
            demb[e] = gate
            ne[e] += 1
            acc = acc + gate
    for e in np.nonzero(w == 0)[0]:
        demb[e] = 0.0
        ne[e] += 1
    return dx, demb, nx, ne


@pytest.mark.parametrize("message", ["relu_add", "add"])
def test_bwd_walk_over_runs_matches_plain(message):
    """The runs' walk, emulated, writes every dx row and every d_emb row
    exactly once and agrees with autograd through the plain version, on
    rows with no edge, a hub of 600 edges, zero weights (a whole row and
    one inside a row) and masked edges (exact-zero d_emb rows)."""
    x, emb, src, dst, mask, w = _hub_case()
    w = w * mask
    g = np.random.default_rng(5).standard_normal(x.shape).astype(np.float32)
    t = torch.from_numpy
    order = SrcOrder(t(src), t(mask), x.shape[0])
    dx, demb, nx, ne = _emulate_bwd(x, emb, src, dst, mask, w, g,
                                    message == "relu_add", order)
    assert (nx == 1).all() and (ne == 1).all()
    want = spmm_bwd_plain(t(x), t(emb), t(src), t(dst), t(mask), t(g),
                          t(w), message)
    for name, a, b in zip(("dx", "d_emb"), (dx, demb), want):
        np.testing.assert_allclose(a, b.numpy(), rtol=0, err_msg=name,
                                   atol=1e-5 * max(1.0, b.abs().max().item()))
    assert not demb[~mask].any() and not demb[w == 0].any()
    assert not dx[250:511].any()


@pytest.mark.parametrize("d", [4, 40, 42, 128, 300, 512, 1000])
@pytest.mark.parametrize("align", [1, 4])
def test_bwd_launch_covers_every_channel(d, align):
    """Slices of 32 * vec * vpl channels cover d once: one slice up to
    d 512 with 16-byte loads, vec 1 where d or the addresses do not allow
    them."""
    vec, vpl, slices = k7.bwd_launch(d, align)
    assert vec == (4 if d % 4 == 0 and align == 4 else 1)
    assert 1 <= vpl <= k7.BWD_MAX_VPL
    width = 32 * vec * vpl
    assert slices * width >= d > (slices - 1) * width
    if vec == 4 and d <= 512:
        assert slices == 1


def _c_params(entry: str, source: str = "spmm.cu") -> int:
    text = (CSRC / source).read_text()
    sig = re.search(r'extern "C" int ' + entry + r"\((.*?)\)\s*\{", text,
                    re.S)
    return len(sig.group(1).split(","))


def test_ctypes_signatures_match_the_c_entries(monkeypatch):
    """The argtypes that spmm.py and scatter_mxu.py set have as many
    entries as K7's C entries (forward and backward, and K8's forward and
    dx on K7's bodies) and K12's have parameters."""
    from graphtrans_tpu_torch.ops.kernels import _build

    k12 = importlib.import_module(
        "graphtrans_tpu_torch.ops.kernels.scatter_mxu")
    entry = lambda: types.SimpleNamespace(argtypes=None)  # noqa: E731
    monkeypatch.setattr(_build, "load", lambda name: types.SimpleNamespace(
        spmm_fwd=entry(), spmm_bwd=entry(), blocked_fwd=entry(),
        blocked_dx=entry(), segment_sum_mxu=entry(),
        segment_sum_span=lambda: k12.SPAN))
    lib = k7._load()
    for name in ("spmm_fwd", "spmm_bwd", "blocked_fwd", "blocked_dx"):
        assert len(getattr(lib, name).argtypes) == _c_params(name), name
    lib = k12._load()
    assert len(lib.segment_sum_mxu.argtypes) == _c_params(
        "segment_sum_mxu", "scatter_mxu.cu")
