"""Kernel K3 (segment-masked attention over wide packed rows): the port's
plain version against the JAX Pallas kernel ``flash_hil_seg_qkv`` in
interpret mode. The CUDA kernel is held against the plain version on the
card in test_torch_port_cuda.py."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from graphtrans_tpu.ops.pallas.flash_hil import flash_hil_seg_qkv  # noqa: E402
from graphtrans_tpu_torch.ops.kernels import (  # noqa: E402
    flash_hil_seg, flash_hil_seg_plain)

TOL = 3e-5  # f32 online softmax over up to 1024 keys in another order


def _case(S, d, seed):
    """One packed row: a long segment, mid-sized ones, single-token
    segments, and a padding tail; plus one all-padding row."""
    rng = np.random.default_rng(seed)
    qkv = rng.standard_normal((2, S, 3 * d)).astype(np.float32)
    seg = np.full((2, S), -1, np.int32)
    lens = [S // 2 + 3, 1, 40, 1, 1, 97, S // 8]
    s = 0
    for g, n in enumerate(lens):
        seg[0, s:s + n] = g
        s += n
    assert s < S                     # the tail of row 0 is padding
    return qkv, seg


@pytest.mark.parametrize("S", [640, 1024])
def test_plain_matches_jax_interpret_kernel(S):
    qkv, seg = _case(S, 128, seed=S)
    want = np.asarray(flash_hil_seg_qkv(jnp.asarray(qkv), jnp.asarray(seg), 0,
                                        4, 0.0, False, True))
    got = flash_hil_seg_plain(torch.from_numpy(qkv), torch.from_numpy(seg), 4)
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=0)
    assert not got.numpy()[seg < 0].any()       # padding queries: exact 0
    assert not got.numpy()[1].any()             # the all-padding row
    one = np.nonzero(np.bincount(seg[seg >= 0]) == 1)[0]
    for g in one:                               # a lone token sees itself:
        i = int(np.nonzero(seg[0] == g)[0][0])  # out = its own v
        np.testing.assert_allclose(got.numpy()[0, i], qkv[0, i, 256:],
                                   atol=1e-6, rtol=0)
    # CPU tensors take the plain version through the wrapper, uncounted
    before = flash_hil_seg.launches
    again = flash_hil_seg(torch.from_numpy(qkv), torch.from_numpy(seg), 4)
    assert flash_hil_seg.launches == before
    np.testing.assert_array_equal(again.numpy(), got.numpy())


def test_dropout_waits_for_the_training_slice():
    qkv, seg = _case(640, 128, seed=1)
    with pytest.raises(NotImplementedError, match="slice 4"):
        flash_hil_seg(torch.from_numpy(qkv), torch.from_numpy(seg), 4, 0.1)
