"""Kernel K7 (the flat-layout message-passing sum over dst-sorted edges):
the port's plain version against the JAX Pallas kernel
``ops/pallas/spmm.py:gather_message_scatter`` in interpret mode and against
the XLA segment route ``ops/scatter.py:gather_message_scatter``, and its
autograd backward against the XLA route's ``jax.vjp`` (the JAX package has
no backward kernel). The CUDA kernels are held against the plain versions
on the card in test_torch_port_cuda.py."""

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
