"""Kernel K2 (segment-masked attention over packed rows): the port's plain
version against the JAX Pallas kernel in interpret mode and the XLA seg
branch. The CUDA kernel is held against the plain version on the card in
test_torch_port_cuda.py."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from graphtrans_tpu.nn.transformer import masked_softmax  # noqa: E402
from graphtrans_tpu.ops.pallas.attention_packed import (  # noqa: E402
    attention_packed_seg_qkv)
from graphtrans_tpu_torch.ops.kernels import (  # noqa: E402
    attention_seg, attention_seg_plain)

TOL = 2e-5  # f32 softmax chain, sums over <= W keys in another order


def _case(R, W, d, seed):
    """qkv and contiguous segments per row, with padding tails and one
    all-padding row."""
    rng = np.random.default_rng(seed)
    qkv = rng.standard_normal((R, W, 3 * d)).astype(np.float32)
    seg = np.full((R, W), -1, np.int32)
    g = 0
    for r in range(R - 1):
        s = 0
        while True:
            n = int(rng.integers(2, W // 3))
            if s + n > W - int(rng.integers(0, 8)):
                break
            seg[r, s:s + n] = g
            g += 1
            s += n
    return qkv, seg


def _xla_seg(qkv, seg, H):
    """The JAX package's XLA seg branch (nn/transformer.py) in f32."""
    R, W, d3 = qkv.shape
    d = d3 // 3
    hd = d // H
    hi = jax.lax.Precision.HIGHEST
    q, k, v = jnp.split(jnp.asarray(qkv), 3, axis=-1)
    sh = lambda t: t.reshape(R, W, H, hd).transpose(0, 2, 1, 3)
    q, k, v = sh(q), sh(k), sh(v)
    s = jnp.einsum("bhqd,bhkd->bhqk", q, k, precision=hi) / np.sqrt(hd)
    segj = jnp.asarray(seg)
    m = ((segj[:, :, None] == segj[:, None, :]) & (segj >= 0)[:, None, :])
    o = jnp.einsum("bhqk,bhkd->bhqd", masked_softmax(s, m[:, None]), v,
                   precision=hi)
    return np.asarray(o.transpose(0, 2, 1, 3).reshape(R, W, d))


def test_plain_matches_jax_interpret_kernel():
    qkv, seg = _case(R=4, W=128, d=128, seed=0)
    want = attention_packed_seg_qkv(jnp.asarray(qkv), jnp.asarray(seg), 0, 4,
                                    0.0, False, True)
    got = attention_seg_plain(torch.from_numpy(qkv), torch.from_numpy(seg), 4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                               rtol=0)
    assert not got.numpy()[seg < 0].any()       # padding queries: exact 0
    assert not got.numpy()[-1].any()            # the all-padding row


@pytest.mark.parametrize("W,d,H", [(128, 32, 4), (128, 128, 4), (256, 64, 2)])
def test_plain_matches_jax_xla_seg_branch(W, d, H):
    qkv, seg = _case(R=3, W=W, d=d, seed=W + d)
    got = attention_seg_plain(torch.from_numpy(qkv), torch.from_numpy(seg), H)
    np.testing.assert_allclose(got.numpy(), _xla_seg(qkv, seg, H), atol=TOL,
                               rtol=0)
    assert np.isfinite(got.numpy()).all()
    # CPU tensors take the plain version through the wrapper, uncounted
    before = attention_seg.launches
    again = attention_seg(torch.from_numpy(qkv), torch.from_numpy(seg), H)
    assert attention_seg.launches == before
    np.testing.assert_array_equal(again.numpy(), got.numpy())

