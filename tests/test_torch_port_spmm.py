"""Kernel K7 (the flat-layout message-passing sum over dst-sorted edges):
the port's plain version against the JAX Pallas kernel
``ops/pallas/spmm.py:gather_message_scatter`` in interpret mode and against
the XLA segment route ``ops/scatter.py:gather_message_scatter``. The CUDA
kernel is held against the plain version on the card in
test_torch_port_cuda.py."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from graphtrans_tpu.ops import scatter as jscatter  # noqa: E402
from graphtrans_tpu.ops.pallas import spmm as jspmm  # noqa: E402
from graphtrans_tpu_torch.ops.kernels import spmm, spmm_plain  # noqa: E402
from graphtrans_tpu_torch.ops.segment import (  # noqa: E402
    out_degree, segment_sum)

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
